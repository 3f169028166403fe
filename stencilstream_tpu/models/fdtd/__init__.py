"""FDTD — nano-photonic disk-cavity simulation.

The most feature-complete example app: JSON experiment configs, three
material-resolver policies, a TDV-driven source wave, E/H sub-iterations,
and a snapshot loop exercising iteration-offset pause/resume
(``examples/fdtd/src/fdtd.cpp``).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

from ...backends import create_update
from ...core import Grid, Params
from ...utils.io import write_csv_frame
from .kernel import FDTDKernel, make_kernel
from .materials import (
    CoefResolver,
    LUTResolver,
    RenderResolver,
    RESOLVERS,
)
from .params import Parameters

__all__ = [
    "Parameters",
    "FDTDKernel",
    "make_kernel",
    "CoefResolver",
    "LUTResolver",
    "RenderResolver",
    "RESOLVERS",
    "MONO_BENCHMARK",
    "init_grid",
    "build_simulation",
    "run",
    "save_frame",
    "main",
]

#: ops/cell constants used by the benchmark harness
#: (examples/fdtd/scripts/benchmark.jl: 14 + 8 ops).
FLOPS_PER_CELL = 22

#: The reference's benchmark experiment
#: (``examples/fdtd/experiments/mono_benchmark.json``): one 800 nm ring at
#: dx = 1.5656 nm, which renders a 1024x1024 grid of 8-field cells.
MONO_BENCHMARK = {
    "tau": 100e-15,
    "dx": 1.5655577299412914e-9,
    "time": {"t_cutoff": 7.0, "t_detect": 14.0, "t_max": 15.0},
    "source": {"frequency": 120e12, "phase": 3.0, "x": 0, "y": 0, "radius": 0},
    "cavity_rings": [{"radius": 800e-9, "mu_r": 11.56, "eps_r": 1.0, "sigma": 0.0}],
}


def init_grid(parameters: Parameters, resolver) -> Grid:
    """Render the ring geometry into cells (``fdtd.cpp:193-216``)."""
    h, w = parameters.grid_range()
    rr = np.arange(h, dtype=np.float32)[:, None] - np.float32(h) / 2.0
    cc = np.arange(w, dtype=np.float32)[None, :] - np.float32(w) / 2.0
    distance = parameters.dx * np.sqrt(rr * rr + cc * cc)

    ring_index = np.full((h, w), len(parameters.rings), np.int32)
    radius = 0.0
    assigned = np.zeros((h, w), bool)
    for i, ring in enumerate(parameters.rings):
        radius += ring.radius
        hit = (~assigned) & (distance < radius)
        ring_index[hit] = i
        assigned |= hit

    # Build the SoA grid by indexing per-ring prototype cells.
    prototypes = [
        resolver.cell_from_parameters(parameters, i)
        for i in range(len(parameters.rings) + 1)
    ]
    import jax

    arrays = jax.tree.map(
        lambda *vals: np.asarray(vals)[ring_index], *prototypes
    )
    return Grid.from_numpy(arrays)


def build_simulation(
    parameters: Parameters,
    resolver=None,
    backend: str = "auto",
    tdv_strategy="inline",
    n_iterations: int | None = None,
    **backend_kwargs,
):
    if resolver is None:
        resolver = CoefResolver(parameters)
    kernel = make_kernel(parameters, resolver)
    update = create_update(
        Params(
            transition_function=kernel,
            halo_value=resolver.halo_cell(),
            iteration_offset=0,
            n_iterations=(
                parameters.n_timesteps() if n_iterations is None else n_iterations
            ),
            blocking=True,
            tdv_strategy=tdv_strategy,
        ),
        backend=backend,
        **backend_kwargs,
    )
    return update, resolver


def save_frame(grid: Grid, iteration_index: int, field: str, parameters: Parameters) -> str:
    """Write one field of the grid as ``<field>.<iteration>.csv``
    (``fdtd.cpp:114-166``)."""
    path = os.path.join(parameters.out_dir, f"{field}.{iteration_index}.csv")
    write_csv_frame(path, getattr(grid.to_numpy(), field))
    return path


def run(
    parameters: Parameters,
    resolver=None,
    backend: str = "auto",
    tdv_strategy="inline",
    snapshots: bool = True,
):
    """The full simulation driver incl. the snapshot/resume loop
    (``fdtd.cpp:226-252``). Returns ``(grid, update)``."""
    update, resolver = build_simulation(
        parameters, resolver, backend=backend, tdv_strategy=tdv_strategy
    )
    grid = init_grid(parameters, resolver)

    n_snap = parameters.n_snap_timesteps()
    if snapshots and n_snap is not None:
        p = update.get_params()
        p.n_iterations = n_snap
        while p.iteration_offset < parameters.n_timesteps():
            grid = update(grid)
            save_frame(grid, p.iteration_offset + n_snap, "hz", parameters)
            p.iteration_offset += n_snap
    else:
        grid = update(grid)

    return grid, update


def main(argv=None) -> int:
    from ...utils.cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(
        prog="fdtd", description="Nano-photonic disk cavity FDTD simulation"
    )
    parser.add_argument("-c", dest="config", required=True,
                        help="experiment JSON file ('-' for stdin)")
    parser.add_argument("-o", dest="out_dir", default=".")
    parser.add_argument("--material", default="coef", choices=sorted(RESOLVERS))
    parser.add_argument("--tdv", default="inline",
                        choices=["inline", "precompute_on_device", "precompute_on_host"])
    parser.add_argument("--backend", default="auto")
    parser.add_argument("--no-snapshots", action="store_true")
    args = parser.parse_args(argv)

    parameters = Parameters.load(args.config, out_dir=args.out_dir)
    parameters.print_configuration()

    resolver = RESOLVERS[args.material](parameters)
    print("Simulating...")
    grid, update = run(
        parameters,
        resolver,
        backend=args.backend,
        tdv_strategy=args.tdv,
        snapshots=not args.no_snapshots,
    )
    print("Simulation complete!")
    print(f"Walltime: {update.get_walltime()} s")
    save_frame(grid, parameters.n_timesteps(), "hz_sum", parameters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
