"""The stencil view handed to a transition function.

The reference materializes a ``(2r+1) x (2r+1)`` register array per cell and
indexes it with signed offsets (``StencilStream/Stencil.hpp:47,91-146``). In
an array program a per-cell register window would defeat vectorization, so
the idiomatic equivalent is an *array-valued* view: ``stencil[dr, dc]`` returns the cell
field(s) of the neighbor at signed offset ``(dr, dc)`` **for every cell of the
block at once** — each leaf is an ``(H, W)`` array. Transition functions are
written exactly like the reference's scalar ones (elementwise arithmetic,
``jnp.where`` instead of ``if``), and XLA applies them across the whole block.

Metadata carried by the view mirrors ``Stencil.hpp:164-177``:

* ``id`` — global (row, col) coordinates of each central cell, as a pair of
  int32 arrays; supports ``stencil.id[0]`` / ``stencil.id[1]`` like the
  reference's ``sycl::id<2>``.
* ``iteration`` / ``subiteration`` — the logical iteration/sub-iteration index.
* ``grid_range`` — ``(height, width)`` of the *logical* grid (ints).
* ``time_dependent_value`` — the TDV for this iteration (see
  :mod:`stencilstream_tpu.tdv`).
"""

from __future__ import annotations

from typing import Any, Callable

import jax.numpy as jnp

__all__ = ["Stencil"]


class Stencil:
    """Array-valued neighborhood view.

    ``neighbor_fn(dr, dc)`` must return the cell pytree for the signed offset
    ``(dr, dc)``, halo-substituted outside the grid. Lookups are cached so a
    transition function touching the same neighbor repeatedly costs one slice.
    """

    __slots__ = (
        "_neighbor_fn",
        "radius",
        "id",
        "grid_range",
        "iteration",
        "subiteration",
        "time_dependent_value",
        "_cache",
    )

    def __init__(
        self,
        neighbor_fn: Callable[[int, int], Any],
        radius: int,
        id: tuple[Any, Any],
        grid_range: tuple[int, int],
        iteration: Any,
        subiteration: Any,
        time_dependent_value: Any = None,
    ):
        self._neighbor_fn = neighbor_fn
        self.radius = radius
        self.id = id
        self.grid_range = grid_range
        self.iteration = iteration
        self.subiteration = subiteration
        self.time_dependent_value = time_dependent_value
        self._cache: dict[tuple[int, int], Any] = {}

    # -- signed indexing: stencil[dr, dc], origin at the central cell --------
    def __getitem__(self, key: tuple[int, int]) -> Any:
        dr, dc = key
        dr, dc = int(dr), int(dc)
        r = self.radius
        if not (-r <= dr <= r and -r <= dc <= r):
            raise IndexError(
                f"stencil offset ({dr}, {dc}) outside radius {r} "
                f"(signed indexing, origin at the central cell)"
            )
        hit = self._cache.get((dr, dc))
        if hit is None:
            hit = self._neighbor_fn(dr, dc)
            self._cache[(dr, dc)] = hit
        return hit

    # -- unsigned indexing, origin at the north-western corner ---------------
    def uid(self, ur: int, uc: int) -> Any:
        """Unsigned indexing in ``[0, 2*radius]``, origin at the NW corner,
        mirroring the reference's ``UID`` operator (``Stencil.hpp:148-162``)."""
        return self[ur - self.radius, uc - self.radius]

    @property
    def center(self) -> Any:
        """Shorthand for ``stencil[0, 0]``."""
        return self[0, 0]

    @property
    def diameter(self) -> int:
        return 2 * self.radius + 1

    @property
    def tdv(self) -> Any:
        """Alias for :attr:`time_dependent_value`."""
        return self.time_dependent_value

    @property
    def row(self) -> Any:
        """Global row coordinate of each central cell (int32 array)."""
        return self.id[0]

    @property
    def col(self) -> Any:
        """Global column coordinate of each central cell (int32 array)."""
        return self.id[1]

    def on_boundary(self) -> Any:
        """Boolean mask of cells on the outermost ring of the logical grid.

        Convenience for in-kernel boundary handling like HotSpot's clamping
        (``examples/hotspot/hotspot.cpp:77-87``).
        """
        h, w = self.grid_range
        return (
            (self.row == 0)
            | (self.row == h - 1)
            | (self.col == 0)
            | (self.col == w - 1)
        )
