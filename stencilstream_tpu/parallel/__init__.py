"""Multi-device parallelism: meshes and collective halo exchange.

Replaces the reference's entire distributed stack — MPI for rank identity and
barriers, ``pc2::mpi_queues`` for device assignment, and Intel FPGA I/O pipes
for board-to-board data (``StencilStream/monotile/StencilUpdate.hpp:154-175``,
``StencilStream/internal/DualIOPipeKernels.hpp:28``, SURVEY.md §2.7.6-7) —
with JAX's equivalents: a :class:`jax.sharding.Mesh` over the devices,
``shard_map`` for SPMD, and ``lax.ppermute`` for neighbor data movement
(collectives XLA hands to NCCL on GPUs). No out-of-band topology setup (the
analog of ``scripts/setup_io_pipes.py``) is needed: every device reaches
every other at the same rate, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh

__all__ = [
    "make_mesh",
    "mesh_factor",
    "exchange_halo",
    "round_up",
    "shift_from",
]


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def mesh_factor(n: int) -> tuple[int, int]:
    """Factor ``n`` devices into a near-square ``(ny, nx)`` grid (ny <= nx)."""
    best = (1, n)
    for ny in range(1, int(math.isqrt(n)) + 1):
        if n % ny == 0:
            best = (ny, n // ny)
    return best


def make_mesh(
    n_devices: int | None = None,
    shape: tuple[int, int] | None = None,
    axis_names: tuple[str, str] = ("y", "x"),
) -> Mesh:
    """Build a 2D device mesh for spatial domain decomposition.

    The two axes shard grid rows and columns; a 1-device mesh degenerates
    cleanly so single-chip code paths are identical.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices) if shape is None else shape[0] * shape[1]
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} available"
        )
    if shape is None:
        shape = mesh_factor(n_devices)
    ny, nx = shape
    import numpy as np

    dev_grid = np.asarray(devices[: ny * nx]).reshape(ny, nx)
    return Mesh(dev_grid, axis_names)


def shift_from(x: Any, axis_name: str, direction: int, axis_size: int) -> Any:
    """Shift ``x`` one rank along ``axis_name`` in ``direction``: with
    ``+1`` data flows toward higher ranks (each rank *receives the previous
    rank's* value), with ``-1`` toward lower ranks (each rank receives the
    next rank's value). Mesh-edge devices receive zeros.

    The analog of the reference's inter-FPGA send/recv kernels
    (``internal/DualIOPipeKernels.hpp:28,97``): one ``ppermute`` hop.
    """
    if axis_size == 1:
        return jax.tree.map(jnp.zeros_like, x)
    if direction > 0:
        perm = [(i, i + 1) for i in range(axis_size - 1)]
    else:
        perm = [(i + 1, i) for i in range(axis_size - 1)]
    return jax.tree.map(lambda a: lax.ppermute(a, axis_name, perm), x)


def exchange_halo(
    local: Any,
    halo: int,
    axis_names: Sequence[str] = ("y", "x"),
    axis_sizes: Sequence[int] | None = None,
) -> Any:
    """Extend a local block with ``halo`` rows and columns from mesh
    neighbors.

    Input: cell pytree of ``(h, w)`` leaves (inside ``shard_map``). Output:
    ``(h + 2*halo, w + 2*halo)`` leaves. Corner data arrives for free by
    exchanging columns *after* rows are extended (two-phase exchange).
    Mesh-edge positions receive zeros — callers mask them against the grid
    bounds (the fused-pass out-of-grid re-mask), which is the analog of the
    reference's coordinate-based halo substitution
    (``tiling/internal/HaloTiledInputKernel.hpp:66-107``).
    """
    ay, ax = axis_names
    ny = axis_sizes[0] if axis_sizes else lax.axis_size(ay)
    nx = axis_sizes[1] if axis_sizes else lax.axis_size(ax)
    treedef = jax.tree.structure(local)

    def exchange_axis(ext, axis, axis_name, n_ranks):
        """One axis of the two-phase exchange: slice ``halo`` off both
        edges and move each strip one rank."""
        leaves = jax.tree.leaves(ext)
        n = leaves[0].shape[axis]
        hi_send = [lax.slice_in_dim(a, n - halo, n, axis=axis) for a in leaves]
        lo_send = [lax.slice_in_dim(a, 0, halo, axis=axis) for a in leaves]
        # hi_send -> next rank's lo halo; lo_send -> previous rank's hi halo.
        lo_halo = shift_from(jax.tree.unflatten(treedef, hi_send), axis_name, +1, n_ranks)
        hi_halo = shift_from(jax.tree.unflatten(treedef, lo_send), axis_name, -1, n_ranks)
        return jax.tree.map(
            lambda lo, a, hi: jnp.concatenate([lo, a, hi], axis=axis),
            lo_halo,
            ext,
            hi_halo,
        )

    ext = exchange_axis(local, 0, ay, ny)
    return exchange_axis(ext, 1, ax, nx)
