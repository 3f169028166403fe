"""Fused multi-iteration window updates (temporal blocking building block).

This replaces the reference's processing-element chain
(``StencilStream/monotile/internal/StencilUpdateKernel.hpp:65``,
``tiling/internal/StencilUpdateKernel.hpp:59``): where the FPGA unrolls
``p * n_subiterations`` PEs in silicon and streams cells through them, we
apply the same number of *whole-window* sub-iteration steps in the program
between two halo exchanges.

Per-axis window disciplines, matching the two reference kernels:

* ``"pad"`` — the window spans the whole grid along this axis, so the window
  edge *is* the grid edge: neighbors beyond it are the halo value, injected
  by constant padding each sub-step (monotile semantics — the grid boundary
  is the halo boundary, ``monotile/internal/StencilUpdateKernel.hpp:36-38``).
  In an overlapped-tiling setting the same discipline yields windows whose
  *interior-edge* margins go stale by ``radius`` rows per sub-step — callers
  discard the stale margins, which is the overlapped-tiling trade.
* ``"shrink"`` — the window loses ``radius`` cells per side per sub-step, so
  a window of ``core + 2 * radius * p * n_subiterations`` yields the exact
  core after ``p`` fused iterations — the compound-halo law of the
  reference's tiling backend (``tiling/internal/StencilUpdateKernel.hpp:79-91``).

Independent of discipline, out-of-grid window cells are re-masked to the halo
value after every sub-step — the vectorized equivalent of the reference's
per-PE coordinate-based halo masking
(``monotile/internal/StencilUpdateKernel.hpp:259-303``) — and cells whose
iteration index is past the requested target pass through unchanged, the
reference's partial-pass pass-through (:250-256).

Everything here is plain ``jnp`` and traces inside ``shard_map``
(distributed, ring); callers use :func:`fused_window_pass`, which applies
:func:`fused_substep` once per fused iteration.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..core.cell import canonicalize_cell
from ..core.stencil import Stencil

__all__ = ["fused_substep", "fused_window_pass", "halo_width", "mask_out_of_grid"]


def halo_width(radius: int, iters_per_pass: int, n_subiterations: int) -> int:
    """Window halo per side for a fused pass — the reference's compound-halo
    law ``r * p * n_subiterations`` (``tiling/StencilUpdate.hpp:81-87``)."""
    return radius * iters_per_pass * n_subiterations


def shifted(a, d: int, axis: int, hv, mask: bool = True):
    """Shape-preserving shift: ``out[i] = a[i + d]`` along ``axis``, with the
    halo value where ``i + d`` runs past the array.

    ``mask=False`` (transition functions declaring ``handles_boundary``)
    skips the halo-value substitution: positions past the array edge hold
    *wrapped* values the kernel must discard itself — this removes one
    select per tap per sub-step.
    """
    if d == 0:
        return a
    if not mask:
        return jnp.roll(a, -d, axis)
    n = a.shape[axis]
    shape = list(a.shape)
    shape[axis] = abs(d)
    frame = jnp.full(shape, jnp.asarray(hv, a.dtype))
    if d > 0:
        return jnp.concatenate([lax.slice_in_dim(a, d, n, axis=axis), frame], axis=axis)
    return jnp.concatenate([frame, lax.slice_in_dim(a, 0, n + d, axis=axis)], axis=axis)


def mask_out_of_grid(
    window: Any,
    halo_cell: Any,
    origin: tuple[Any, Any],
    grid_range: tuple[Any, Any],
) -> Any:
    """Replace out-of-grid window positions with the halo value (the
    reference's insertion-time substitution,
    ``tiling/internal/HaloTiledInputKernel.hpp:66-107``)."""
    h, w = jax.tree.leaves(window)[0].shape
    H, W = grid_range
    row = lax.broadcasted_iota(jnp.int32, (h, w), 0) + jnp.asarray(origin[0], jnp.int32)
    col = lax.broadcasted_iota(jnp.int32, (h, w), 1) + jnp.asarray(origin[1], jnp.int32)
    oog = (row < 0) | (row >= H) | (col < 0) | (col >= W)
    return jax.tree.map(
        lambda a, hv: jnp.where(oog, jnp.asarray(hv, a.dtype), a),
        window,
        halo_cell,
    )


def fused_substep(
    window: Any,
    tf: Any,
    halo_cell: Any,
    row0: Any,
    col0: Any,
    grid_range: tuple[Any, Any],
    i_abs: Any,
    tdv: Any,
    active: Any,
    *,
    radius: int,
    n_subiterations: int,
    row_mode: str = "pad",
    col_mode: str = "pad",
) -> tuple[Any, Any, Any]:
    """One fused iteration (all ``n_subiterations`` phases) over a window.

    Returns ``(window, row0, col0)``; each ``"shrink"`` axis is smaller by
    ``2 * radius * n_subiterations`` with its origin advanced accordingly.
    Pure in all arguments (the TDV is an input, looked up by the caller).
    """
    r = radius
    H, W = grid_range
    row0 = jnp.asarray(row0, jnp.int32)
    col0 = jnp.asarray(col0, jnp.int32)
    # ``handles_boundary``: the transition function clamps/replaces every
    # out-of-grid tap itself via ``stencil.id`` (the HotSpot pattern,
    # ``examples/hotspot/hotspot.cpp:77-87``), so neighbor shifts skip the
    # halo-value substitution — out-of-window tap positions carry wrapped
    # values the kernel provably discards. The reference/oracle semantics
    # (halo value presented at out-of-grid taps) stay the default.
    tap_mask = not getattr(tf, "handles_boundary", False)

    for sub in range(n_subiterations):
        h, w = jax.tree.leaves(window)[0].shape
        # Along "pad" axes neighbors are shape-preserving halo shifts; along
        # "shrink" axes they are interior slices and the output loses 2r.
        nh = h if row_mode == "pad" else h - 2 * r
        nw = w if col_mode == "pad" else w - 2 * r
        if row_mode != "pad":
            row0 = row0 + r
        if col_mode != "pad":
            col0 = col0 + r

        def neighbor(dr: int, dc: int, _window=window, _nh=nh, _nw=nw):
            def one(a, hv):
                if row_mode == "pad":
                    a = shifted(a, dr, 0, hv, mask=tap_mask)
                else:
                    a = lax.slice_in_dim(a, r + dr, r + dr + _nh, axis=0)
                if col_mode == "pad":
                    a = shifted(a, dc, 1, hv, mask=tap_mask)
                else:
                    a = lax.slice_in_dim(a, r + dc, r + dc + _nw, axis=1)
                return a

            return jax.tree.map(one, _window, halo_cell)

        row = lax.broadcasted_iota(jnp.int32, (nh, nw), 0) + row0
        col = lax.broadcasted_iota(jnp.int32, (nh, nw), 1) + col0

        stencil = Stencil(
            neighbor_fn=neighbor,
            radius=r,
            id=(row, col),
            grid_range=grid_range,
            iteration=i_abs,
            subiteration=sub,
            time_dependent_value=tdv,
        )
        center = stencil[0, 0]
        new = canonicalize_cell(tf(stencil), center)
        # Partial-pass pass-through (scalar predicate, vectorized select).
        new = jax.tree.map(lambda n, c: jnp.where(active, n, c), new, center)
        # Halo re-mask: out-of-grid positions always present halo_value.
        out_of_grid = (row < 0) | (row >= H) | (col < 0) | (col >= W)
        window = jax.tree.map(
            lambda n, hv: jnp.where(out_of_grid, jnp.asarray(hv, n.dtype), n),
            new,
            halo_cell,
        )
    return window, row0, col0


def fused_window_pass(
    window: Any,
    tf: Any,
    halo_cell: Any,
    origin: tuple[Any, Any],
    grid_range: tuple[Any, Any],
    i_start: Any,
    i_target: Any,
    tdv_lookup: Callable[[Any, Any], Any],
    *,
    radius: int,
    n_subiterations: int,
    n_steps: int,
    row_mode: str = "shrink",
    col_mode: str = "pad",
) -> Any:
    """Apply ``n_steps`` fused iterations to a window of cells (XLA callers).

    Args:
      window: cell pytree of ``(h, w)`` arrays. A ``"shrink"`` axis must
        exceed ``2 * radius * n_steps * n_subiterations``.
      origin: global (row, col) of ``window[0, 0]`` (traced values ok).
      grid_range: logical grid extent ``(H, W)``.
      i_start: absolute iteration index of the first fused step.
      i_target: absolute end iteration; steps at/after it pass cells through
        unchanged (partial-pass support, enables fixed-shape pass loops).
      tdv_lookup: ``(step, i_abs) -> tdv``, traced per step.

    Returns the final window pytree.
    """
    row0 = jnp.asarray(origin[0], jnp.int32)
    col0 = jnp.asarray(origin[1], jnp.int32)

    # Out-of-grid window positions must present the halo value at the first
    # sub-step too (mesh-edge ppermute halos arrive as zeros).
    window = mask_out_of_grid(window, halo_cell, (row0, col0), grid_range)

    # Shrinking windows change shape every step, so the step loop unrolls.
    for step in range(n_steps):
        i_abs = i_start + step
        window, row0, col0 = fused_substep(
            window,
            tf,
            halo_cell,
            row0,
            col0,
            grid_range,
            i_abs,
            tdv_lookup(step, i_abs),
            i_abs < i_target,
            radius=radius,
            n_subiterations=n_subiterations,
            row_mode=row_mode,
            col_mode=col_mode,
        )
    return window
