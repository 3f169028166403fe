"""Ring backend: multi-device *temporal* pipeline (iteration pipelining).

The realization of the reference's experimental multi-FPGA
monotile variant (``StencilStream/monotile/internal/StencilUpdateDesign.hpp:221-348``):
N accelerators chained in a ring, each applying its own ``p`` iterations to
the grid as it streams through, so one lap around the ring advances
``N * p`` iterations. The reference moves data board-to-board over two
32-byte serial channels with root-only memory I/O; here the stream is a
sequence of row *chunks* moving between devices (``lax.ppermute``), with the same
root-style semantics (the assembled result is reduced back to every device
at the end of each lap).

Pipeline schedule (SPMD, one ``fori_loop`` over ticks):

* device 0 ingests chunk ``j`` from the (replicated) grid at tick ``j``;
* device ``d`` computes chunk ``j`` at tick ``j + 1 + 2d`` — it must first
  receive chunk ``j+1``, whose head rows are the *lookahead halo* that the
  FPGA design encodes as pipeline latency
  (``monotile/internal/StencilUpdateKernel.hpp:88-99``); the tail of chunk
  ``j-1`` is retained device-side, the exact analog of the PE line cache
  (:180-184);
* computed chunks travel one hop per tick; the last device accumulates them
  into the lap result, which a ``psum`` re-replicates (rank-0-writes-memory,
  ``StencilUpdateDesign.hpp:328-335``).

Each per-device chunk update is a fused shrinking-window pass in plain XLA
(:func:`.fused.fused_window_pass`, the same pass the distributed backend
runs). Partial laps (``n % (N*p) != 0``) pass cells through unchanged
exactly like the reference's partial-pass PEs (:250-256).

This backend pays ring-circulation traffic (the whole grid crosses every
hop each lap) in exchange for multiplying temporal depth by N — the same
trade the multi-FPGA design makes. For spatial scale-out prefer the
``distributed`` backend; this one exists for capability parity and for
grids whose iteration count, not size, is the scaling axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..core.grid import Grid
from ..tdv import PrecomputeOnDeviceTDV
from .base import StencilUpdateBase, resolve_halo
from .fused import fused_window_pass, halo_width

__all__ = ["StencilUpdate"]


@functools.partial(
    jax.jit,
    static_argnames=(
        "radius",
        "n_subiterations",
        "n_iterations",
        "strategy",
        "iters_per_pass",
        "chunk_rows",
        "mesh",
        "grid_range",
    ),
)
def _run_ring(
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
    iters_per_pass: int,
    chunk_rows: int,
    mesh: Mesh,
    grid_range: tuple[int, int],
):
    if n_iterations == 0:
        return arrays

    if isinstance(strategy, PrecomputeOnDeviceTDV):
        tdv_aux = strategy.precompute_traced(tf, offset, n_iterations)

    H, W = grid_range
    r, k, p, ch = radius, n_subiterations, iters_per_pass, chunk_rows
    look = halo_width(r, p, k)
    n_dev = mesh.devices.size
    n_chunks = -(-H // ch)
    Hp = n_chunks * ch
    n_ticks = (n_chunks + 1) + 2 * (n_dev - 1) + 1
    lap_iters = n_dev * p
    n_laps = -(-n_iterations // lap_iters)
    offset = jnp.asarray(offset, jnp.int32)
    i_target = offset + n_iterations

    # Replicated padded grid: rows [0, H) are live, the rest is halo-masked
    # by coordinates inside the fused pass. Bool cells ride as int8 (psum
    # accumulates the lap result).
    def encode_store(a):
        return a.astype(jnp.int8) if a.dtype == jnp.bool_ else a

    halo_typed = jax.tree.map(
        lambda hv, a: jnp.asarray(hv, a.dtype), halo_cell, arrays
    )
    padded = jax.tree.map(
        lambda a, hv: jnp.pad(
            encode_store(a), ((0, Hp - H), (0, 0)), constant_values=encode_store(jnp.asarray(hv))
        ),
        arrays,
        halo_typed,
    )

    def tdv_lookup(step_unused, i_abs):
        i_rel = jnp.clip(i_abs - offset, 0, max(n_iterations - 1, 0))
        return strategy.lookup(tf, tdv_aux, i_rel, i_abs)

    def chunk_like(tree, rows):
        return jax.tree.map(lambda a: jnp.zeros((rows, a.shape[1]), a.dtype), tree)

    def spmd(g, tf, halo_cell, offset, tdv_aux):
        d = lax.axis_index("ring")

        def lap_body(lap, g):
            i_start_dev = offset + lap * lap_iters + d * p

            def tick_body(tick, state):
                cur, tail, inflow, accum = state
                # inflow: the chunk arriving this tick. Device 0 sources it
                # from memory; others take last tick's ppermute delivery.
                j_src = tick
                src_rows = jnp.clip(j_src * ch, 0, Hp - ch)
                from_mem = jax.tree.map(
                    lambda a: lax.dynamic_slice(a, (src_rows, 0), (ch, a.shape[1])),
                    g,
                )
                recv = jax.tree.map(
                    lambda m, i: jnp.where(d == 0, m, i), from_mem, inflow
                )

                # Compute chunk j with window = tail | cur | head(recv).
                j = tick - 1 - 2 * d
                window = jax.tree.map(
                    lambda t, c, n: jnp.concatenate([t, c, n[:look]], axis=0),
                    tail,
                    cur,
                    recv,
                )
                # Bool cells are stored as int8; the transition function
                # sees bools.
                window = jax.tree.map(
                    lambda w, a: w.astype(jnp.bool_) if a.dtype == jnp.bool_ else w,
                    window,
                    arrays,
                )
                out_chunk = fused_window_pass(
                    window,
                    tf,
                    halo_cell,
                    origin=(j * ch - look, 0),
                    grid_range=(H, W),
                    i_start=i_start_dev,
                    i_target=i_target,
                    tdv_lookup=tdv_lookup,
                    radius=r,
                    n_subiterations=k,
                    n_steps=p,
                    row_mode="shrink",
                    col_mode="pad",
                )
                out_chunk = jax.tree.map(
                    lambda o, a: o.astype(jnp.int8) if a.dtype == jnp.bool_ else o,
                    out_chunk,
                    arrays,
                )

                # Last device accumulates valid chunks into the lap result.
                valid = (j >= 0) & (j < n_chunks)
                dst = jnp.clip(j * ch, 0, Hp - ch)

                def acc_leaf(acc, new):
                    old = lax.dynamic_slice(acc, (dst, 0), (ch, acc.shape[1]))
                    sel = jnp.where(valid & (d == n_dev - 1), new, old)
                    return lax.dynamic_update_slice(acc, sel, (dst, 0))

                accum = jax.tree.map(acc_leaf, accum, out_chunk)

                # Advance the stream: tail <- end of cur, cur <- recv, and
                # send this tick's computed chunk one hop clockwise.
                new_tail = jax.tree.map(lambda c: c[ch - look :], cur)
                sent = jax.tree.map(
                    lambda a: lax.ppermute(
                        a, "ring", [(i, i + 1) for i in range(n_dev - 1)]
                    )
                    if n_dev > 1
                    else jnp.zeros_like(a),
                    out_chunk,
                )
                return (recv, new_tail, sent, accum)

            state = (
                chunk_like(g, ch),  # cur
                chunk_like(g, look),  # tail
                chunk_like(g, ch),  # inflow
                jax.tree.map(jnp.zeros_like, g),  # accum
            )
            state = lax.fori_loop(0, n_ticks, tick_body, state)
            accum = state[3]
            # Re-replicate the lap result from the last device (root-style
            # write-back): everyone else contributed zeros.
            return jax.tree.map(
                lambda a: lax.psum(
                    jnp.where(d == n_dev - 1, a, jnp.zeros_like(a)), "ring"
                ),
                accum,
            )

        return lax.fori_loop(0, n_laps, lap_body, g)

    rep = lambda tree: jax.tree.map(lambda _: P(), tree)
    out = jax.shard_map(
        spmd,
        mesh=mesh,
        in_specs=(rep(padded), rep(tf), rep(halo_cell), P(), rep(tdv_aux)),
        out_specs=rep(padded),
        # Per-device values (axis_index, the last device's accumulator) are
        # re-replicated by the final psum, by construction.
        check_vma=False,
    )(padded, tf, halo_cell, offset, tdv_aux)
    return jax.tree.map(
        lambda a, like: a[:H].astype(jnp.bool_) if like.dtype == jnp.bool_ else a[:H],
        out,
        arrays,
    )


class StencilUpdate(StencilUpdateBase):
    """Ring (multi-device temporal pipeline) stencil updater.

    Extra keyword options:

    * ``mesh`` — 1D mesh with axis ``("ring",)`` (default: all devices).
    * ``iters_per_pass`` — p iterations applied per device per lap
      (lap depth = ``n_devices * p``).
    * ``chunk_rows`` — rows per streamed chunk (>= the compound halo
      ``r * p * n_subiterations``; default: an eighth of the grid).
    """

    def __init__(
        self,
        params,
        *,
        mesh: Mesh | None = None,
        iters_per_pass: int = 2,
        chunk_rows: int | None = None,
    ):
        super().__init__(params)
        if mesh is None:
            import numpy as np

            mesh = Mesh(np.asarray(jax.devices()), ("ring",))
        self.mesh = mesh
        self.iters_per_pass = iters_per_pass
        self.chunk_rows = chunk_rows

    def _update(self, grid: Grid) -> Grid:
        prm = self.params
        tf = prm.transition_function
        strategy = self._tdv_strategy()
        halo_cell = resolve_halo(prm.halo_value, grid)
        n = int(prm.n_iterations)
        H, W = grid.shape
        r, k = tf.stencil_radius, tf.n_subiterations

        p = max(1, min(self.iters_per_pass, n or 1))
        look = halo_width(r, p, k)
        ch = self.chunk_rows or max(look, H // 8, 1)
        if ch < look:
            raise ValueError(
                f"chunk_rows={ch} must be >= the compound halo r*p*k={look}; "
                f"raise chunk_rows or lower iters_per_pass"
            )

        offset = jnp.asarray(prm.iteration_offset, jnp.int32)
        tdv_aux = strategy.prepare(tf, int(prm.iteration_offset), n)
        out = _run_ring(
            grid.arrays,
            tf,
            halo_cell,
            offset,
            tdv_aux,
            radius=r,
            n_subiterations=k,
            n_iterations=n,
            strategy=strategy,
            iters_per_pass=p,
            chunk_rows=ch,
            mesh=self.mesh,
            grid_range=(H, W),
        )
        return Grid(out)
