"""Cell types: pytrees of per-cell scalar fields.

A *cell* is the value stored at one grid position. In this framework a cell is
any JAX pytree whose leaves are scalars (or arrays, when a whole grid of cells
is represented as a pytree of ``(H, W)`` arrays — the struct-of-arrays layout
that vectorized hardware reads with contiguous loads).

This replaces three reference subsystems at once (see SURVEY.md):

* the ``Cell`` template parameter with the ``std::semiregular`` requirement
  (``StencilStream/Concepts.hpp:43-44``),
* the CUDA backend's opt-in AoS->SoA layout transformation driven by the
  ``Cell::fields`` member-pointer tuple
  (``StencilStream/cuda/StencilUpdate.hpp:294-321``,
  ``StencilStream/cuda/internal/Helpers.hpp:37-67``) — pytrees *are* SoA, so
  the scatter/gather kernels are unnecessary,
* the ``Padded<T>`` power-of-two alignment helper
  (``StencilStream/internal/Helpers.hpp:42-44``) — XLA lays out each field
  array in (8, 128)-tiled form on its own.

Use :func:`cell_type` to declare a multi-field cell as a dataclass; plain
scalars/arrays (Conway's ``bool``, Jacobi's ``float``) work without any
declaration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax
import jax.numpy as jnp

T = TypeVar("T")

__all__ = [
    "cell_type",
    "cell_dtypes",
    "cell_zeros",
    "cell_full_grid",
    "canonicalize_cell",
    "cell_block_shape",
]


def cell_type(cls: type[T]) -> type[T]:
    """Declare a multi-field cell type.

    Wraps :func:`dataclasses.dataclass` and registers the class as a JAX
    pytree with *all* fields as data leaves. The resulting class can be used
    both for a single cell (scalar leaves) and for a whole grid of cells
    (``(H, W)`` array leaves) — the struct-of-arrays duality that the
    reference's ``Cell::fields`` convention only reaches on its CUDA backend
    (``StencilStream/cuda/StencilUpdate.hpp:41``).
    """
    cls = dataclasses.dataclass(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


def cell_dtypes(cell: Any) -> Any:
    """Pytree of dtypes, one per cell field."""
    return jax.tree.map(lambda x: jnp.asarray(x).dtype, cell)


def cell_zeros(prototype: Any) -> Any:
    """A cell of zeros with the same structure/dtypes as ``prototype``."""
    return jax.tree.map(lambda x: jnp.zeros((), jnp.asarray(x).dtype), prototype)


def cell_full_grid(shape: tuple[int, int], cell: Any) -> Any:
    """Broadcast a scalar cell to a full grid pytree of ``shape`` arrays."""
    return jax.tree.map(lambda x: jnp.full(shape, x, jnp.asarray(x).dtype), cell)


def canonicalize_cell(new: Any, like: Any) -> Any:
    """Cast ``new``'s leaves to the dtypes of ``like`` (same structure).

    Transition functions are free to compute in wider types; the stored grid
    keeps its declared dtypes, mirroring how the reference's ``Cell`` struct
    fixes field types at compile time.
    """
    return jax.tree.map(lambda n, l: jnp.asarray(n).astype(jnp.asarray(l).dtype), new, like)


def cell_block_shape(grid_cell: Any) -> tuple[int, ...]:
    """Shape of the leaves of a grid-of-cells pytree (must agree)."""
    leaves = jax.tree.leaves(grid_cell)
    if not leaves:
        raise ValueError("cell pytree has no leaves")
    shape = jnp.shape(leaves[0])
    for leaf in leaves[1:]:
        if jnp.shape(leaf) != shape:
            raise ValueError(
                f"cell field arrays disagree in shape: {jnp.shape(leaf)} vs {shape}"
            )
    return shape
