"""The Grid: a 2D field of cells, stored struct-of-arrays.

Replaces the reference's per-backend ``Grid`` classes
(``StencilStream/cpu/Grid.hpp:50``, ``monotile/Grid.hpp:56``,
``tiling/Grid.hpp:64``). Where the reference needs vectorized
``Padded<array<Cell, w>>`` storage and accessor shims for wide memory words,
XLA's own array layouts provide the same for free, so there is a
single Grid for all backends: a pytree of ``(H, W)`` arrays, one per cell
field, wrapped in a registered-pytree class so grids can flow through ``jit``.

Host-side conveniences mirror the reference ``Grid`` concept
(``Concepts.hpp:91-129``): construction from dimensions, ``make_similar``,
elementwise host access, and numpy import/export (the analog of
``copy_from_buffer``/``copy_to_buffer``).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .cell import cell_block_shape, cell_full_grid, cell_zeros

__all__ = ["Grid"]


@jax.tree_util.register_pytree_node_class
class Grid:
    """A 2D grid of cells. ``arrays`` is a cell pytree of ``(H, W)`` leaves."""

    __slots__ = ("arrays",)

    def __init__(self, arrays: Any):
        self.arrays = arrays

    # -- pytree protocol -----------------------------------------------------
    def tree_flatten(self):
        leaves, treedef = jax.tree.flatten(self.arrays)
        return leaves, treedef

    @classmethod
    def tree_unflatten(cls, treedef, leaves):
        return cls(jax.tree.unflatten(treedef, leaves))

    # -- constructors --------------------------------------------------------
    @classmethod
    def full(cls, height: int, width: int, cell: Any) -> "Grid":
        """Grid of ``height x width`` cells, every cell equal to ``cell``.

        Analog of ``Grid(c, r)`` + fill (``Concepts.hpp:100-101``); unlike the
        reference, newly created grids are never uninitialized.
        """
        return cls(cell_full_grid((height, width), cell))

    @classmethod
    def zeros(cls, height: int, width: int, cell_prototype: Any) -> "Grid":
        return cls.full(height, width, cell_zeros(cell_prototype))

    @classmethod
    def from_numpy(cls, arrays: Any) -> "Grid":
        """Build a grid from a cell pytree of numpy/host ``(H, W)`` arrays
        (the analog of ``Grid(sycl::buffer)``, ``Concepts.hpp:102-103``)."""
        grid = cls(jax.tree.map(jnp.asarray, arrays))
        cell_block_shape(grid.arrays)  # validate agreeing shapes
        return grid

    # -- geometry ------------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return cell_block_shape(self.arrays)[:2]

    @property
    def height(self) -> int:
        """Number of rows (``get_grid_height``, ``Concepts.hpp:108``)."""
        return self.shape[0]

    @property
    def width(self) -> int:
        """Number of columns (``get_grid_width``, ``Concepts.hpp:107``)."""
        return self.shape[1]

    @property
    def range(self) -> tuple[int, int]:
        """``(height, width)`` — the analog of ``get_grid_range()``."""
        return self.shape

    def make_similar(self) -> "Grid":
        """A zero grid with the same geometry/dtypes (``Concepts.hpp:110``)."""
        return Grid(jax.tree.map(lambda a: jnp.zeros_like(a), self.arrays))

    # -- host access ---------------------------------------------------------
    def cell_at(self, r: int, c: int) -> Any:
        """Read one cell to the host (the ``GridAccessor`` analog)."""
        return jax.tree.map(lambda a: np.asarray(a[r, c]), self.arrays)

    def set_cell(self, r: int, c: int, cell: Any) -> "Grid":
        """Functional single-cell update (host-side initialization helper)."""
        return Grid(
            jax.tree.map(lambda a, v: a.at[r, c].set(v), self.arrays, cell)
        )

    def to_numpy(self) -> Any:
        """Cell pytree of numpy arrays (``copy_to_buffer`` analog)."""
        return jax.tree.map(np.asarray, self.arrays)

    def block_until_ready(self) -> "Grid":
        jax.block_until_ready(self.arrays)
        return self

    def __repr__(self) -> str:
        h, w = self.shape
        n = len(jax.tree.leaves(self.arrays))
        return f"Grid({h}x{w}, {n} field{'s' if n != 1 else ''})"
