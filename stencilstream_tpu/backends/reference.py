"""The reference backend: pure JAX/XLA, the semantic oracle.

This is the analog of the reference's CPU backend
(``StencilStream/cpu/StencilUpdate.hpp:40-228``), which is the semantic gold
standard all other backends are tested against. Where the CPU backend submits
one work-item-per-cell kernel per (iteration, sub-iteration) with per-item
halo-checked gathers (``cpu/StencilUpdate.hpp:199-221``), this backend:

* pads each field array by the stencil radius with the halo value,
* materializes each used neighbor as one static slice of the padded array
  (XLA fuses the shifts and the elementwise transition math into one kernel
  per sub-iteration),
* iterates with ``lax.fori_loop`` — one fused device loop, not N kernel
  launches.

It runs on any JAX platform. It is the single-device path ``auto`` picks and
the test oracle for the multi-device backends. On a GPU each sub-iteration
reads and writes every field once: one device-memory round trip per
sub-iteration, the same structure as the reference project's own GPU backend.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

from ..core.cell import canonicalize_cell
from ..core.grid import Grid
from ..core.stencil import Stencil
from ..tdv import PrecomputeOnDeviceTDV
from .base import StencilUpdateBase, resolve_halo

__all__ = ["StencilUpdate", "apply_iterations"]


def single_subiteration(
    arrays: Any,
    tf: Any,
    halo_cell: Any,
    i_iteration: Any,
    i_subiteration: int,
    tdv: Any,
    *,
    radius: int,
    grid_range: tuple[int, int] | None = None,
    origin: tuple[Any, Any] = (0, 0),
) -> Any:
    """One sub-iteration over a block of cells (pure function).

    ``grid_range``/``origin`` allow a caller to evaluate a *window* of a
    larger logical grid (used by the tiling/distributed backends): ``origin``
    is the global (row, col) of the block's first cell and ``grid_range`` the
    logical grid extent used for ``stencil.id``/``grid_range`` semantics.

    Neighbors are built lazily, one shape-preserving halo shift each, so
    only the neighbors the transition function touches are materialized.
    """
    from .fused import shifted

    H, W = jax.tree.leaves(arrays)[0].shape

    def neighbor(dr: int, dc: int):
        return jax.tree.map(
            lambda a, hv: shifted(shifted(a, dr, 0, hv), dc, 1, hv),
            arrays,
            halo_cell,
        )

    row = lax.broadcasted_iota(jnp.int32, (H, W), 0) + jnp.asarray(origin[0], jnp.int32)
    col = lax.broadcasted_iota(jnp.int32, (H, W), 1) + jnp.asarray(origin[1], jnp.int32)
    stencil = Stencil(
        neighbor_fn=neighbor,
        radius=radius,
        id=(row, col),
        grid_range=grid_range if grid_range is not None else (H, W),
        iteration=i_iteration,
        subiteration=i_subiteration,
        time_dependent_value=tdv,
    )
    new = tf(stencil)
    new_def = jax.tree.structure(new)
    old_def = jax.tree.structure(arrays)
    if new_def != old_def:
        raise TypeError(
            f"transition function returned cell structure {new_def}, expected {old_def}"
        )
    return canonicalize_cell(new, arrays)


@functools.partial(
    jax.jit,
    static_argnames=("radius", "n_subiterations", "n_iterations", "strategy"),
)
def _run(
    arrays,
    tf,
    halo_cell,
    offset,
    tdv_aux,
    *,
    radius: int,
    n_subiterations: int,
    n_iterations: int,
    strategy,
):
    if n_iterations == 0:
        return arrays

    if isinstance(strategy, PrecomputeOnDeviceTDV):
        tdv_aux = strategy.precompute_traced(tf, offset, n_iterations)

    def iter_body(i, arrays):
        i_abs = offset + i
        tdv = strategy.lookup(tf, tdv_aux, i, i_abs)
        for sub in range(n_subiterations):
            arrays = single_subiteration(
                arrays, tf, halo_cell, i_abs, sub, tdv, radius=radius
            )
        return arrays

    return lax.fori_loop(0, n_iterations, iter_body, arrays)


class StencilUpdate(StencilUpdateBase):
    """Pure-JAX stencil updater (the oracle backend)."""

    def _run_args(self, grid: Grid):
        p = self.params
        tf = p.transition_function
        strategy = self._tdv_strategy()
        n = int(p.n_iterations)
        args = (
            grid.arrays,
            tf,
            resolve_halo(p.halo_value, grid),
            jnp.asarray(p.iteration_offset, jnp.int32),
            strategy.prepare(tf, int(p.iteration_offset), n),
        )
        kwargs = dict(
            radius=tf.stencil_radius,
            n_subiterations=tf.n_subiterations,
            n_iterations=n,
            strategy=strategy,
        )
        return args, kwargs

    def _update(self, grid: Grid) -> Grid:
        args, kwargs = self._run_args(grid)
        return Grid(_run(*args, **kwargs))

    def lower(self, grid: Grid):
        args, kwargs = self._run_args(grid)
        return _run.lower(*args, **kwargs)


def apply_iterations(
    grid: Grid,
    tf: Any,
    n_iterations: int,
    *,
    halo_value: Any = None,
    iteration_offset: int = 0,
) -> Grid:
    """Functional one-shot convenience: ``update(grid, offset, n) -> grid``."""
    update = StencilUpdate(
        StencilUpdate.Params(
            transition_function=tf,
            halo_value=halo_value,
            iteration_offset=iteration_offset,
            n_iterations=n_iterations,
        )
    )
    return update(grid)
