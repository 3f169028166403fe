"""Distributed backend: grid sharded over a device mesh, collective halo
exchange.

The replacement for the reference's multi-FPGA scale-out
(``StencilStream/monotile/internal/StencilUpdateDesign.hpp:221-348``): where
the reference circulates the *whole grid* around a ring of FPGAs — each lap
advancing ``n_ranks * p`` iterations, data moving over two 32-byte serial
channels per hop — this design shards the grid *spatially* over a device
mesh and exchanges only ``halo``-wide boundary strips per pass
(``lax.ppermute``). This is the scheme the reference itself identifies as
the scalable one (overlapped tiling with compound halo,
``tiling/internal/StencilUpdateKernel.hpp:79-91``) but could not build for
lack of an all-to-all fabric.

Per pass each device extends its local block with halo data from its mesh
neighbours (two-phase exchange, :func:`..parallel.exchange_halo`), then
applies ``p`` fused iterations with the shrinking-window discipline in plain
XLA (:func:`.fused.fused_window_pass`).

Everything (pass loop included) runs inside one ``jit`` + ``shard_map``, so
XLA overlaps the ppermute collectives with local compute where profitable.
MPI barriers and rank bookkeeping (``StencilUpdateDesign.hpp:251-258``) have
no analog: SPMD program order and the collectives themselves are the
synchronization.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.grid import Grid
from ..parallel import exchange_halo, make_mesh, round_up
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
        "mesh",
        "grid_range",
    ),
)
def _run_distributed(
    padded,
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
    mesh: Mesh,
    grid_range: tuple[int, int],
):
    if n_iterations == 0:
        return padded

    if isinstance(strategy, PrecomputeOnDeviceTDV):
        tdv_aux = strategy.precompute_traced(tf, offset, n_iterations)

    H, W = grid_range
    r, k, p = radius, n_subiterations, iters_per_pass
    hp = halo_width(r, p, k)
    Hp, Wp = jax.tree.leaves(padded)[0].shape
    ny, nx = mesh.devices.shape
    h, w = Hp // ny, Wp // nx
    n_passes = -(-n_iterations // p)
    offset = jnp.asarray(offset, jnp.int32)
    i_target = offset + n_iterations

    grid_spec = jax.tree.map(lambda _: P("y", "x"), padded)
    rep = lambda tree: jax.tree.map(lambda _: P(), tree)

    def spmd(local, tf, halo_cell, offset, tdv_aux):
        """Two-phase halo exchange + shrinking fused window, per pass."""
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")
        origin = (iy * h - hp, ix * w - hp)

        def tdv_lookup(step_unused, i_abs):
            i_rel = jnp.clip(i_abs - offset, 0, max(n_iterations - 1, 0))
            return strategy.lookup(tf, tdv_aux, i_rel, i_abs)

        def pass_body(i_pass, local):
            i_start = offset + i_pass * p
            window = exchange_halo(local, hp, ("y", "x"), (ny, nx))
            return fused_window_pass(
                window,
                tf,
                halo_cell,
                origin=origin,
                grid_range=(H, W),
                i_start=i_start,
                i_target=i_target,
                tdv_lookup=tdv_lookup,
                radius=r,
                n_subiterations=k,
                n_steps=p,
                row_mode="shrink",
                col_mode="shrink",
            )

        return lax.fori_loop(0, n_passes, pass_body, local)

    return jax.shard_map(
        spmd,
        mesh=mesh,
        in_specs=(grid_spec, rep(tf), rep(halo_cell), P(), rep(tdv_aux)),
        out_specs=grid_spec,
        # Values derived from axis_index (window origins) vary per device;
        # the sharding of the result is by construction (per-device blocks).
        check_vma=False,
    )(padded, tf, halo_cell, offset, tdv_aux)


class StencilUpdate(StencilUpdateBase):
    """Mesh-sharded stencil updater.

    Extra keyword options:

    * ``mesh`` — a :class:`jax.sharding.Mesh` with axes ``("y", "x")``.
      Default: all visible devices as a 1D row mesh ``(n, 1)``.
    * ``iters_per_pass`` — temporal parallelism p: iterations fused between
      halo exchanges; the halo width is ``r * p * n_subiterations`` per side
      (communication/redundant-compute tradeoff, SURVEY.md §2.7.5).
    """

    def __init__(
        self,
        params,
        *,
        mesh: Mesh | None = None,
        iters_per_pass: int = 4,
    ):
        super().__init__(params)
        if mesh is None:
            mesh = make_mesh(shape=(len(jax.devices()), 1))
        self.mesh = mesh
        self.iters_per_pass = iters_per_pass

    def _update(self, grid: Grid) -> Grid:
        prm = self.params
        tf = prm.transition_function
        strategy = self._tdv_strategy()
        halo_cell = resolve_halo(prm.halo_value, grid)
        n = int(prm.n_iterations)
        H, W = grid.shape
        ny, nx = self.mesh.devices.shape
        r, k = tf.stencil_radius, tf.n_subiterations

        p = max(1, min(self.iters_per_pass, n or 1))
        hp = halo_width(r, p, k)

        # Pad the grid so every device gets an equal local block of at least
        # halo size (single-hop neighbor exchange).
        min_local = max(hp, 1)
        Hp = round_up(max(H, ny * min_local), ny)
        Wp = round_up(max(W, nx * min_local), nx)

        halo_typed = jax.tree.map(
            lambda hv, a: jnp.asarray(hv, a.dtype), halo_cell, grid.arrays
        )
        padded = jax.tree.map(
            lambda a, hv: jnp.pad(a, ((0, Hp - H), (0, Wp - W)), constant_values=hv),
            grid.arrays,
            halo_typed,
        )
        sharding = NamedSharding(self.mesh, P("y", "x"))
        padded = jax.tree.map(lambda a: jax.device_put(a, sharding), padded)

        offset = jnp.asarray(prm.iteration_offset, jnp.int32)
        tdv_aux = strategy.prepare(tf, int(prm.iteration_offset), n)
        out = _run_distributed(
            padded,
            tf,
            halo_cell,
            offset,
            tdv_aux,
            radius=r,
            n_subiterations=k,
            n_iterations=n,
            strategy=strategy,
            iters_per_pass=p,
            mesh=self.mesh,
            grid_range=(H, W),
        )
        out = jax.tree.map(lambda a: a[:H, :W], out)
        return Grid(out)
