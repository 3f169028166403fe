"""HotSpot — the Rodinia transient thermal simulation.

Mirrors ``examples/hotspot/hotspot.cpp``: a two-field cell (temperature +
dissipated power), in-kernel boundary clamping via global coordinates, the
Rodinia update formula, text/binary file I/O, and the
``Walltime: X s`` / ``GFlops`` stdout protocol the benchmark harness scrapes
(``examples/hotspot/scripts/benchmark.jl:52-66``).
"""

from __future__ import annotations

import argparse
import sys

import jax.numpy as jnp
import numpy as np

from ..backends import create_update
from ..core import Grid, Params, cell_type, transition_function
from ..utils.io import (
    read_float_grid_binary,
    read_float_grid_text,
    write_float_grid_binary,
    write_indexed_text,
)

__all__ = [
    "HotspotCell",
    "HotspotKernel",
    "derive_coefficients",
    "run",
    "main",
    "FLOPS_PER_CELL",
]

# Chip/physics constants (examples/hotspot/hotspot.cpp:40-55).
MAX_PD = 3.0e6
PRECISION = 0.001
SPEC_HEAT_SI = 1.75e6
K_SI = 100.0
FACTOR_CHIP = 0.5
T_CHIP = 0.0005
CHIP_HEIGHT = 0.016
CHIP_WIDTH = 0.016
AMB_TEMP = 80.0

#: ops/cell used for the GFlops print (hotspot.cpp:311, benchmark.jl:15).
FLOPS_PER_CELL = 15

@cell_type
class HotspotCell:
    temp: jnp.ndarray
    power: jnp.ndarray


@transition_function
class HotspotKernel:
    """Rodinia update with boundary handling *inside* the transition function:
    at grid edges the missing neighbor is replaced by the center temperature
    (``hotspot.cpp:69-96``) — exercising ``stencil.id``/``grid_range``."""

    stencil_radius = 1
    n_subiterations = 1
    # Every out-of-grid tap is replaced below via stencil.id clamps, so the
    # fused window passes may skip halo-value substitution in the neighbor
    # shifts (raw wrap-rolls; see backends.fused.shifted).
    handles_boundary = True
    Rx_1: float = 0.0
    Ry_1: float = 0.0
    Rz_1: float = 0.0
    Cap_1: float = 0.0

    def __call__(self, s):
        center = s[0, 0]
        old = center.temp
        power = center.power

        h, w = s.grid_range
        top = jnp.where(s.row == 0, old, s[-1, 0].temp)
        bottom = jnp.where(s.row == h - 1, old, s[1, 0].temp)
        left = jnp.where(s.col == 0, old, s[0, -1].temp)
        right = jnp.where(s.col == w - 1, old, s[0, 1].temp)

        # Same update as hotspot.cpp:90-92, reassociated: the constant
        # products fold at trace time and the neighbor terms chain as FMAs,
        # cutting per-sub-step arithmetic from ~10 ops to ~7
        # (mathematically identical, f32 rounding differs by ulps):
        #   new = old + Cap*(power + (b+t-2*old)*Ry + (r+l-2*old)*Rx
        #                    + (AMB-old)*Rz)
        #       = old - Cap*(2Ry+2Rx+Rz)*old + Cap*(power + AMB*Rz)
        #         + (b+t)*(Cap*Ry) + (r+l)*(Cap*Rx)
        old_coef = 1.0 - self.Cap_1 * (
            2.0 * self.Ry_1 + 2.0 * self.Rx_1 + self.Rz_1
        )
        acc = power + AMB_TEMP * self.Rz_1
        acc = (bottom + top) * self.Ry_1 + acc
        acc = (right + left) * self.Rx_1 + acc
        new_temp = old * old_coef + acc * self.Cap_1
        return HotspotCell(temp=new_temp, power=power)

    def get_time_dependent_value(self, i):
        return None


def derive_coefficients(n_rows: int, n_cols: int) -> HotspotKernel:
    """Physics-to-coefficients derivation (``hotspot.cpp:281-295``)."""
    grid_height = CHIP_HEIGHT / n_rows
    grid_width = CHIP_WIDTH / n_cols

    cap = FACTOR_CHIP * SPEC_HEAT_SI * T_CHIP * grid_height * grid_width
    rx = grid_width / (2.0 * K_SI * T_CHIP * grid_height)
    ry = grid_height / (2.0 * K_SI * T_CHIP * grid_width)
    rz = T_CHIP / (K_SI * grid_height * grid_width)

    max_slope = MAX_PD / (FACTOR_CHIP * T_CHIP * SPEC_HEAT_SI)
    step = PRECISION / max_slope / 1000.0

    return HotspotKernel(
        Rx_1=np.float32(1.0 / rx),
        Ry_1=np.float32(1.0 / ry),
        Rz_1=np.float32(1.0 / rz),
        Cap_1=np.float32(step / cap),
    )


def read_input(temp_file: str, power_file: str, n_rows: int, n_cols: int, binary: bool) -> Grid:
    reader = read_float_grid_binary if binary else read_float_grid_text
    return Grid.from_numpy(
        HotspotCell(temp=reader(temp_file, n_rows, n_cols), power=reader(power_file, n_rows, n_cols))
    )


def run(grid: Grid, n_iterations: int, backend: str = "auto", kernel=None,
        **backend_kwargs):
    if kernel is None:
        kernel = derive_coefficients(grid.height, grid.width)
    update = create_update(
        Params(
            transition_function=kernel,
            halo_value=HotspotCell(temp=jnp.float32(0.0), power=jnp.float32(0.0)),
            n_iterations=n_iterations,
            blocking=True,
        ),
        backend=backend,
        **backend_kwargs,
    )
    return update(grid), update


def main(argv=None) -> int:
    from ..utils.cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(
        prog="hotspot", description="Rodinia HotSpot transient thermal simulation"
    )
    parser.add_argument("grid_rows", type=int)
    parser.add_argument("grid_cols", type=int)
    parser.add_argument("sim_time", type=int, help="number of iterations")
    parser.add_argument("temp_file")
    parser.add_argument("power_file")
    parser.add_argument("output_file")
    parser.add_argument("--backend", default="auto")
    args = parser.parse_args(argv)

    binary = args.temp_file.endswith(".bin")
    if binary and not args.power_file.endswith(".bin"):
        parser.error("temp and power files must both be binary or both text")

    grid = read_input(args.temp_file, args.power_file, args.grid_rows, args.grid_cols, binary)
    print("Start computing the transient temperature")
    out, update = run(grid, args.sim_time, backend=args.backend)
    print("Ending simulation")
    print(f"Walltime: {update.get_walltime()} s")
    gflops = (args.grid_rows * args.grid_cols * args.sim_time * FLOPS_PER_CELL) / update.get_walltime() / 1.0e9
    print(f"GFlops: {gflops}")

    temps = out.to_numpy().temp
    if binary:
        write_float_grid_binary(args.output_file, temps)
    else:
        write_indexed_text(args.output_file, temps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
