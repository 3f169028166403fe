"""Jacobi — eight kernel variants scaling arithmetic intensity from 1 to 17
FLOPs/cell, used for throughput benchmarking.

Mirrors ``examples/jacobi/kernels.hpp:34-319`` and the CLI of
``examples/jacobi/jacobi.cpp``: block-initialized grid (center half-rectangle
at 1.0), raw-float32 output dump, and a ``show-config`` JSON introspection
mode. Variants are selected with ``--variant`` instead of per-variant build
targets.
"""

from __future__ import annotations

import argparse
import json
import sys

import jax.numpy as jnp
import numpy as np

from ..backends import create_update
from ..core import Grid, Params, transition_function
from ..utils.io import write_float_grid_binary

__all__ = ["VARIANTS", "make_kernel", "init_grid", "run", "main"]


@transition_function
class Jacobi1General:
    """1 op/cell: ``coef * center`` (``kernels.hpp:34-67``)."""

    stencil_radius = 1
    n_subiterations = 1
    n_operations = 1
    n_coefficients = 1
    coef: float = 1.0

    def __call__(self, s):
        return self.coef * s[0, 0]

    def get_time_dependent_value(self, i):
        return None


@transition_function
class Jacobi2Constant:
    """2 ops/cell (``kernels.hpp:69-99``)."""

    stencil_radius = 1
    n_subiterations = 1
    n_operations = 2
    n_coefficients = 0

    def __call__(self, s):
        return (s[-1, 0] + s[1, 0]) * 0.5

    def get_time_dependent_value(self, i):
        return None


@transition_function
class Jacobi3Constant:
    """3 ops/cell (``kernels.hpp:101-131``)."""

    stencil_radius = 1
    n_subiterations = 1
    n_operations = 3
    n_coefficients = 0

    def __call__(self, s):
        # Center tap first (same math, f32 sum order differs from
        # kernels.hpp by ulps).
        return (s[0, 0] + s[-1, 0] + s[1, 0]) * jnp.float32(0.33333334)

    def get_time_dependent_value(self, i):
        return None


@transition_function
class Jacobi4Constant:
    """4 ops/cell, 4-point cross (``kernels.hpp:133-163``)."""

    stencil_radius = 1
    n_subiterations = 1
    n_operations = 4
    n_coefficients = 0

    def __call__(self, s):
        return (s[-1, 0] + s[0, -1] + s[1, 0] + s[0, 1]) * 0.25

    def get_time_dependent_value(self, i):
        return None


@transition_function
class Jacobi5Constant:
    """5 ops/cell, 5-point star (``kernels.hpp:165-196``)."""

    stencil_radius = 1
    n_subiterations = 1
    n_operations = 5
    n_coefficients = 0

    def __call__(self, s):
        # Center tap first (see Jacobi3Constant).
        return (s[0, 0] + s[-1, 0] + s[0, -1] + s[1, 0] + s[0, 1]) * jnp.float32(0.2)

    def get_time_dependent_value(self, i):
        return None


@transition_function
class Jacobi4General:
    """7 ops/cell, 4 coefficients (``kernels.hpp:198-234``)."""

    stencil_radius = 1
    n_subiterations = 1
    n_operations = 7
    n_coefficients = 4
    c0: float = 0.25
    c1: float = 0.25
    c2: float = 0.25
    c3: float = 0.25

    def __call__(self, s):
        return (
            self.c0 * s[-1, 0] + self.c1 * s[0, -1] + self.c2 * s[1, 0] + self.c3 * s[0, 1]
        )

    def get_time_dependent_value(self, i):
        return None


@transition_function
class Jacobi5General:
    """9 ops/cell, 5 coefficients (``kernels.hpp:236-272``) — the headline
    benchmark variant (176.08 GCell/s on the reference FPGA, README.md:78)."""

    stencil_radius = 1
    n_subiterations = 1
    n_operations = 9
    n_coefficients = 5
    c0: float = 0.2
    c1: float = 0.2
    c2: float = 0.2
    c3: float = 0.2
    c4: float = 0.2

    def __call__(self, s):
        # The accumulation chain starts with the center term, whose operand
        # needs no shift. Same math as kernels.hpp:236-272; f32 sum order
        # differs by ulps.
        return (
            self.c4 * s[0, 0]
            + self.c0 * s[-1, 0]
            + self.c1 * s[0, -1]
            + self.c2 * s[1, 0]
            + self.c3 * s[0, 1]
        )

    def get_time_dependent_value(self, i):
        return None


@transition_function
class Jacobi9General:
    """17 ops/cell, full 3x3 coefficient matrix (``kernels.hpp:274-319``)."""

    stencil_radius = 1
    n_subiterations = 1
    n_operations = 17
    n_coefficients = 9
    coef: tuple = (0.111111, 0.111111, 0.111111, 0.111111, 0.111111, 0.111111, 0.111111, 0.111111, 0.111111)

    def __call__(self, s):
        # Center tap first (see Jacobi5General).
        total = self.coef[4] * s[0, 0]
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if dr == 0 and dc == 0:
                    continue
                total = total + self.coef[(dr + 1) * 3 + (dc + 1)] * s[dr, dc]
        return total

    def get_time_dependent_value(self, i):
        return None


VARIANTS = {
    "jacobi1_general": Jacobi1General,
    "jacobi2_constant": Jacobi2Constant,
    "jacobi3_constant": Jacobi3Constant,
    "jacobi4_constant": Jacobi4Constant,
    "jacobi5_constant": Jacobi5Constant,
    "jacobi4_general": Jacobi4General,
    "jacobi5_general": Jacobi5General,
    "jacobi9_general": Jacobi9General,
}


def make_kernel(variant: str, coefs=()):
    cls = VARIANTS[variant]
    n = cls.n_coefficients
    coefs = [float(c) for c in coefs]
    if len(coefs) != n:
        raise ValueError(f"{variant} takes {n} coefficient(s), got {len(coefs)}")
    if n == 0:
        return cls()
    if cls is Jacobi1General:
        return cls(coef=coefs[0])
    if cls is Jacobi9General:
        return cls(coef=tuple(coefs))
    return cls(**{f"c{i}": c for i, c in enumerate(coefs)})


def init_grid(height: int, width: int) -> Grid:
    """Block initialization: 1.0 inside the centered half-size rectangle
    (``jacobi.cpp:112-124``)."""
    r = np.arange(height)[:, None]
    c = np.arange(width)[None, :]
    block = (
        (r >= height * 0.25) & (r < height * 0.75) & (c >= width * 0.25) & (c < width * 0.75)
    )
    return Grid.from_numpy(block.astype(np.float32))


def run(grid: Grid, kernel, n_iterations: int, backend: str = "auto",
        **backend_kwargs):
    update = create_update(
        Params(
            transition_function=kernel,
            halo_value=jnp.float32(0.0),
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
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "show-config":
        variant = argv[1] if len(argv) > 1 else "jacobi5_general"
        cls = VARIANTS[variant]
        print(
            json.dumps(
                {
                    "variant": variant,
                    "n_coefficients": cls.n_coefficients,
                    "n_operations": cls.n_operations,
                },
                indent=4,
            )
        )
        return 0

    parser = argparse.ArgumentParser(prog="jacobi")
    parser.add_argument("grid_rows", type=int)
    parser.add_argument("grid_cols", type=int)
    parser.add_argument("n_iterations", type=int)
    parser.add_argument("output_file")
    parser.add_argument("coefs", nargs="*", type=float)
    parser.add_argument("--variant", default="jacobi5_general", choices=sorted(VARIANTS))
    parser.add_argument("--backend", default="auto")
    args = parser.parse_args(argv)

    kernel = make_kernel(args.variant, args.coefs)
    grid = init_grid(args.grid_rows, args.grid_cols)
    print("Starting simulation")
    out, update = run(grid, kernel, args.n_iterations, backend=args.backend)
    print("Simulation complete!")
    print(f"Walltime: {update.get_walltime()} s")
    write_float_grid_binary(args.output_file, out.to_numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
