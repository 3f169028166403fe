"""Benchmark CLI — the analog of the reference's per-example ``benchmark.jl``
drivers (``examples/*/scripts/benchmark.jl``).

Usage::

    python -m stencilstream_tpu.bench max_perf hotspot
    python -m stencilstream_tpu.bench grid_scaling jacobi --variant jacobi5_general
    python -m stencilstream_tpu.bench max_perf fdtd

Modes mirror the reference CLI (``benchmark.jl:22-40``):

* ``max_perf`` — single large-grid run.
* ``grid_scaling`` — throughput across grid sizes (the reference's
  deep-grid-scaling sweep; produces the throughput-vs-size curve of
  ``README.md:76``).

Results are persisted as ``metrics.<variant>.json`` (same contract as the
reference harness) and summarized on stdout. Each names the device it ran
on; on a GPU it also carries the roofline report against that card's
published peaks (an unknown GPU is an error).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _hotspot_case(size, backend, backend_kwargs):
    import jax.numpy as jnp

    from ..core import Grid, Params
    from ..backends import create_update
    from ..models.hotspot import FLOPS_PER_CELL, HotspotCell, derive_coefficients

    rng = np.random.default_rng(42)
    grid = Grid.from_numpy(
        HotspotCell(
            temp=rng.uniform(70, 90, (size, size)).astype(np.float32),
            power=rng.uniform(0, 1e-3, (size, size)).astype(np.float32),
        )
    )
    kernel = derive_coefficients(size, size)

    def make(n):
        return create_update(
            Params(
                transition_function=kernel,
                halo_value=HotspotCell(temp=jnp.float32(0), power=jnp.float32(0)),
                n_iterations=n,
                blocking=True,
            ),
            backend=backend,
            **backend_kwargs,
        )

    return grid, make, 8, FLOPS_PER_CELL  # cell_bytes, flops/cell


def _jacobi_case(size, backend, backend_kwargs, variant="jacobi5_general"):
    from ..core import Params
    from ..backends import create_update
    from ..models import jacobi

    tf_cls = jacobi.VARIANTS[variant]
    kernel = jacobi.make_kernel(variant, [0.2] * tf_cls.n_coefficients)
    grid = jacobi.init_grid(size, size)

    def make(n):
        return create_update(
            Params(transition_function=kernel, n_iterations=n, blocking=True),
            backend=backend,
            **backend_kwargs,
        )

    return grid, make, 4, tf_cls.n_operations


def _fdtd_case(size, backend, backend_kwargs):
    from ..models import fdtd

    # The grid is derived from the (cumulative) ring extent: width =
    # ceil(2r/dx + 2) (Parameters.hpp:243-251), so a single ring of
    # r = (size-2)/2*dx gives a size^2 grid; cells beyond the disk are
    # perfect metal, so a material boundary stays in play.
    dx = 10e-9
    radius = (size - 2) / 2 * dx
    params = fdtd.Parameters.from_json(
        {
            "tau": 100e-15,
            "dx": dx,
            "time": {"t_cutoff": 7.0, "t_detect": 4.0, "t_max": 1.0},
            "source": {"frequency": 120e12, "phase": 3.0, "x": 0, "y": 0, "radius": 0.0},
            "cavity_rings": [
                {"radius": radius, "mu_r": 11.56, "eps_r": 1.0, "sigma": 0.0}
            ],
        }
    )
    resolver = fdtd.CoefResolver(params)
    grid = fdtd.init_grid(params, resolver)

    def make(n):
        update, _ = fdtd.build_simulation(
            params,
            resolver=resolver,
            backend=backend,
            n_iterations=n,
            **backend_kwargs,
        )
        return update

    return grid, make, 32, fdtd.FLOPS_PER_CELL


def _convection_case(size, backend, backend_kwargs, folded=False):
    from ..core import Params
    from ..backends import create_update
    from ..models import convection

    e = convection.Experiment(
        lx=3.0, ly=1.0, px=1.5, py=0.5, eta0=1.0, DcT=1.0, deltaT=1.0,
        Ra=1e7, Pra=1e3, res=max(size // 3, 8), iterMax=400, nt=2, nout=1,
        nerr=50, epsilon=1e-3, dmp=2.0,
    )
    # Default: the PRODUCTION kernel (the straight port with lean Err path —
    # what convection.run drives for nerr-1 of every nerr iterations).
    # --folded benchmarks the folded coordinate-plane variant.
    folded = folded and backend != "reference"
    lean = backend != "reference"
    if folded:
        grid = convection.init_folded_grid(e)
        tf = convection.make_folded_pseudo_transient_kernel(e, with_err=not lean)
        halo = convection.folded_zero_cell()
    else:
        grid = convection.init_grid(e)
        tf = convection.make_pseudo_transient_kernel(e, with_err=not lean)
        halo = convection.zero_cell()

    def make(n):
        return create_update(
            Params(
                transition_function=tf,
                halo_value=halo,
                n_iterations=n,
                blocking=True,
            ),
            backend=backend,
            **backend_kwargs,
        )

    return grid, make, 44, 50  # 11 f32 fields; ops/cell per reference harness


CASES = {
    "hotspot": _hotspot_case,
    "jacobi": _jacobi_case,
    "fdtd": _fdtd_case,
    "convection": _convection_case,
}


def main(argv=None) -> int:
    from ..utils.cache import enable_compile_cache

    enable_compile_cache()

    parser = argparse.ArgumentParser(prog="stencilstream-bench")
    parser.add_argument(
        "mode",
        choices=["max_perf", "grid_scaling", "strong_scaling"],
        help="max_perf: one large-grid run; grid_scaling: throughput vs grid "
        "size (the reference's deep-grid-scaling sweep); strong_scaling: "
        "fixed problem over growing device meshes (distributed backend — "
        "the reference's multi-rank sweep, benchmark.jl:22-40)",
    )
    parser.add_argument("app", choices=sorted(CASES))
    parser.add_argument("--backend", default="auto")
    parser.add_argument("--variant", default=None, help="jacobi kernel variant")
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--n-iterations", type=int, default=256)
    parser.add_argument("--samples", type=int, default=3)
    parser.add_argument(
        "--iters-per-pass", type=int, default=None,
        help="distributed/ring: iterations fused between halo exchanges",
    )
    parser.add_argument(
        "--folded", action="store_true",
        help="convection: benchmark the folded coordinate-plane kernel "
        "variant instead of the production straight one",
    )
    parser.add_argument("--out-dir", default=".")
    args = parser.parse_args(argv)

    import jax

    from .harness import run_benchmark, write_metrics
    from .model import device_peak

    peak = device_peak() if jax.devices()[0].platform == "gpu" else None
    backend_kwargs = {}
    if args.iters_per_pass:
        backend_kwargs["iters_per_pass"] = args.iters_per_pass

    case = CASES[args.app]
    case_kwargs = {}
    if args.app == "jacobi" and args.variant:
        case_kwargs["variant"] = args.variant
    if args.app == "convection" and args.folded:
        case_kwargs["folded"] = True

    def measure(variant, backend, kwargs, size):
        grid, make, cell_bytes, flops = case(size, backend, kwargs, **case_kwargs)
        update = make(args.n_iterations)
        result = run_benchmark(
            lambda: update(grid),
            variant=variant,
            grid_shape=grid.shape,
            n_iterations=args.n_iterations,
            cell_bytes=cell_bytes,
            flops_per_cell=flops,
            n_samples=args.samples,
            peak=peak,
        )
        if args.app == "convection":
            # Record which kernel variant this row measured (mirrors
            # _convection_case's variant selection).
            result.extra.update(
                with_err=backend == "reference",
                folded=args.folded and backend != "reference",
            )
        return result, write_metrics(result, args.out_dir)

    if args.mode == "strong_scaling":
        from ..parallel import make_mesh

        size = args.size or 2048
        n = 1
        while n <= len(jax.devices()):
            result, path = measure(
                f"{args.app}.distributed.{size}.n{n}", "distributed",
                dict(mesh=make_mesh(n), **backend_kwargs), size,
            )
            print(
                f"{result.variant}: {result.cells_per_s / 1e9:.3f} GCell/s "
                f"on {n} {result.device['kind']} device(s) -> {path}"
            )
            print(f"Walltime: {result.walltime_s} s")
            n *= 2
        return 0

    sizes = (
        [args.size or 8192]
        if args.mode == "max_perf"
        else [512, 1024, 2048, 4096, 8192]
    )
    for size in sizes:
        result, path = measure(
            f"{args.app}{'.' + args.variant if args.variant else ''}"
            f".{args.backend}.{size}",
            args.backend, backend_kwargs, size,
        )
        print(
            f"{result.variant}: {result.cells_per_s / 1e9:.2f} GCell/s "
            f"({result.gflops:.0f} GFLOP/s) on {result.device['kind']}, "
            f"walltime {result.walltime_s:.3f} s -> {path}"
        )
        print(f"Walltime: {result.walltime_s} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
