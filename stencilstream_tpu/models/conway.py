"""Conway's Game of Life — the minimal end-to-end example.

CLI-compatible with the reference app (``examples/conway/conway.cpp:90-111``):
``python -m stencilstream_tpu.models.conway <height> <width> <n_iterations>``
reads an ``X``/``.`` grid from stdin and writes the evolved grid to stdout.
"""

from __future__ import annotations

import argparse
import sys

import jax.numpy as jnp

from ..backends import create_update
from ..core import Grid, Params, transition_function
from ..utils.io import read_char_grid, write_char_grid

__all__ = ["ConwayKernel", "run", "main"]


@transition_function
class ConwayKernel:
    """Moore-neighborhood alive count + birth/survival rule
    (``examples/conway/conway.cpp:35-56``)."""

    stencil_radius = 1
    n_subiterations = 1

    def __call__(self, stencil):
        alive = stencil[0, 0]
        count = jnp.zeros(alive.shape, jnp.int32)
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if (dr, dc) != (0, 0):
                    count = count + stencil[dr, dc].astype(jnp.int32)
        survive = (count == 2) | (count == 3)
        born = count == 3
        return jnp.where(alive, survive, born)

    def get_time_dependent_value(self, i_iteration):
        return None


def run(grid: Grid, n_iterations: int, backend: str = "auto") -> tuple[Grid, object]:
    update = create_update(
        Params(
            transition_function=ConwayKernel(),
            halo_value=jnp.asarray(False),  # outside the grid everything is dead
            n_iterations=n_iterations,
            blocking=True,
        ),
        backend=backend,
    )
    return update(grid), update


def main(argv=None) -> int:
    from ..utils.cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(
        prog="conway", description="Conway's Game of Life over stdin/stdout"
    )
    parser.add_argument("height", type=int)
    parser.add_argument("width", type=int)
    parser.add_argument("n_iterations", type=int)
    parser.add_argument("--backend", default="auto")
    args = parser.parse_args(argv)

    cells = read_char_grid(sys.stdin, args.height, args.width)
    grid = Grid.from_numpy(cells)
    out, _ = run(grid, args.n_iterations, backend=args.backend)
    write_char_grid(sys.stdout, out.to_numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
