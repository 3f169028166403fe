"""Narrow STORAGE dtypes (bf16) with full-precision compute.

The HBM-regime backends are bandwidth-bound: per pass the grid moves
``(2 + halo_overhead)`` cell-sizes of HBM traffic regardless of the op mix
(:mod:`..bench.model`). Storing f32 cells as bfloat16 halves that traffic —
the analog of the reference's memory-word packing
(``StencilStream/internal/Helpers.hpp:42-44`` packs cells into power-of-two
words to widen effective memory bandwidth; here the win comes from
narrowing the stored element instead). Compute stays f32: every tap is
upcast before the wrapped transition function sees it, and the backends'
``canonicalize_cell`` casts the result back to the stored dtype on write
(``core/cell.py:77``).

Numerics: bf16 keeps f32's exponent range but only 8 mantissa bits; each
stored iteration rounds to ~3 significant decimal digits. This is a
user-facing precision/bandwidth trade (the same one ML training makes for
activations) — appropriate for throughput studies and tolerance-bounded
simulations, not for convergence-critical runs like the convection
pseudo-transient solver's error scans.

Usage::

    grid = cast_storage(grid, jnp.bfloat16)
    tf = CastStorageKernel(inner_tf)          # taps arrive as f32
    update = create_update(Params(transition_function=tf, ...), backend=...)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.stencil import Stencil

__all__ = ["CastStorageKernel", "cast_storage"]


def cast_storage(grid_or_arrays, storage_dtype=jnp.bfloat16, *,
                 from_dtype=jnp.float32):
    """Cast every ``from_dtype`` leaf to ``storage_dtype`` (other leaves —
    int fields, bool masks — are untouched). Accepts a Grid or a pytree."""
    from ..core.grid import Grid

    is_grid = isinstance(grid_or_arrays, Grid)
    arrays = grid_or_arrays.arrays if is_grid else grid_or_arrays
    out = jax.tree.map(
        lambda a: a.astype(storage_dtype) if a.dtype == from_dtype else a,
        arrays,
    )
    return Grid(out) if is_grid else out


class _CastStencil:
    """Presents a narrow-storage window in the compute dtype.

    Tap upcasts are MEMOIZED per key: repeated ``s[dr, dc]`` accesses
    return the *same* traced values, so a transition function that passes
    a tap through unchanged (e.g. hotspot returning ``center.power``)
    yields an output leaf that is identity-comparable to the upcast input
    — which :meth:`CastStorageKernel.__call__` uses to restore the
    original storage-dtype leaf and keep the field loop-INVARIANT."""

    __slots__ = ("_s", "_storage", "_compute", "_memo")

    def __init__(self, s: Stencil, storage, compute):
        self._s = s
        self._storage = storage
        self._compute = compute
        self._memo = {}

    def _up(self, cell):
        return jax.tree.map(
            lambda a: a.astype(self._compute)
            if a.dtype == self._storage
            else a,
            cell,
        )

    def __getitem__(self, key):
        k = tuple(key) if isinstance(key, (tuple, list)) else key
        try:
            return self._memo[k]
        except (KeyError, TypeError):
            pass
        out = self._up(self._s[key])
        try:
            self._memo[k] = out
        except TypeError:
            pass
        return out

    def uid(self, ur, uc):
        r = self._s.radius
        return self[ur - r, uc - r]

    @property
    def center(self):
        return self[0, 0]

    @property
    def radius(self):
        return self._s.radius

    @property
    def diameter(self):
        return self._s.diameter

    @property
    def id(self):
        return self._s.id

    @property
    def row(self):
        return self._s.id[0]

    @property
    def col(self):
        return self._s.id[1]

    @property
    def grid_range(self):
        return self._s.grid_range

    @property
    def iteration(self):
        return self._s.iteration

    @property
    def subiteration(self):
        return self._s.subiteration

    @property
    def time_dependent_value(self):
        return self._s.time_dependent_value

    tdv = time_dependent_value

    def on_boundary(self):
        h, w = self.grid_range
        return (
            (self.row == 0)
            | (self.row == h - 1)
            | (self.col == 0)
            | (self.col == w - 1)
        )


@jax.tree_util.register_pytree_node_class
class CastStorageKernel:
    """Wraps a transition function for narrow-storage grids: taps are
    upcast ``storage_dtype -> compute_dtype`` before the inner kernel sees
    them (the write-back downcast is the backends' ``canonicalize_cell``).
    Radius/sub-iterations/TDV/boundary contract pass through."""

    def __init__(self, tf, storage_dtype=jnp.bfloat16, compute_dtype=jnp.float32):
        self.tf = tf
        self._storage = jnp.dtype(storage_dtype)
        self._compute = jnp.dtype(compute_dtype)

    @property
    def stencil_radius(self):
        return self.tf.stencil_radius

    @property
    def n_subiterations(self):
        return self.tf.n_subiterations

    @property
    def handles_boundary(self):
        return getattr(self.tf, "handles_boundary", False)

    def get_time_dependent_value(self, i):
        return self.tf.get_time_dependent_value(i)

    def __call__(self, s):
        cs = _CastStencil(s, self._storage, self._compute)
        out = self.tf(cs)
        # Pass-through restoration: a field the inner kernel returns
        # UNCHANGED from the center tap (hotspot's invariant power plane)
        # must stay the original storage-dtype value, so the output var
        # IS the input var and the field stays a visible pass-through
        # instead of an upcast->downcast round-trip.
        raw_center = s[0, 0]
        up_center = cs[0, 0]
        out_leaves, treedef = jax.tree.flatten(out)
        up_leaves = jax.tree.leaves(up_center)
        raw_leaves = jax.tree.leaves(raw_center)
        if len(out_leaves) == len(up_leaves):
            out_leaves = [
                raw if o is up else o
                for o, up, raw in zip(out_leaves, up_leaves, raw_leaves)
            ]
            return jax.tree.unflatten(treedef, out_leaves)
        return out

    def tree_flatten(self):
        return (self.tf,), (self._storage, self._compute)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.tf = children[0]
        obj._storage, obj._compute = aux
        return obj
