"""The plain-XLA multi-device paths on the virtual CPU mesh: the fused
shrinking-window pass against the reference loop, the distributed probe
contract over mesh shapes, ring partial laps and the two-phase halo
exchange."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from stencilstream_tpu.backends import create_update
from stencilstream_tpu.backends.fused import fused_window_pass, halo_width
from stencilstream_tpu.backends.reference import apply_iterations
from stencilstream_tpu.core import Grid, Params, transition_function
from stencilstream_tpu.parallel import exchange_halo, make_mesh

from probe import ProbeTransFunc, check_probe_grid, make_probe_grid, probe_halo_cell


def _mixing_kernel(radius: int, n_subiterations: int):
    """A kernel reading every tap of its radius-``radius`` neighbourhood with
    distinct weights, its sub-iteration, iteration and cell coordinates —
    so a wrong tap, origin, step or partial-pass flag shows in the result."""

    @transition_function
    class Mixing:
        stencil_radius = radius
        n_subiterations = 1
        bias: float = 0.01

        def __call__(self, s):
            r = self.stencil_radius
            acc = 0.3 * s[0, 0]
            for dr in range(-r, r + 1):
                for dc in range(-r, r + 1):
                    if (dr, dc) != (0, 0):
                        w = 0.7 / ((2 * r + 1) ** 2 - 1) * (1 + 0.1 * (dr - dc))
                        acc = acc + w * s[dr, dc]
            row, col = s.id
            return (acc + self.bias * (s.subiteration + 1)
                    + 1e-3 * s.iteration + 1e-4 * (row - col).astype(jnp.float32))

        def get_time_dependent_value(self, i):
            return None

    Mixing.n_subiterations = n_subiterations
    return Mixing()


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("radius", [1, 2])
def test_fused_window_pass_matches_reference(radius, k, p):
    """One fused pass of ``p`` iterations over a window framed by the
    compound halo ``r*p*k`` reproduces ``p`` reference iterations exactly on
    the core (the halo law of the reference's tiling kernel). The pass's
    target stops one step short when p > 1, so the last step must pass
    cells through unchanged."""
    tf = _mixing_kernel(radius, k)
    H, W = 11, 13
    rng = np.random.default_rng(radius * 100 + k * 10 + p)
    a = rng.random((H, W)).astype(np.float32)
    n_done = max(p - 1, 1)
    want = apply_iterations(Grid.from_numpy(a), tf, n_done, halo_value=0.25,
                            iteration_offset=3).to_numpy()

    hp = halo_width(radius, p, k)
    window = jnp.pad(jnp.asarray(a), hp, constant_values=-7.0)  # masked away
    got = fused_window_pass(
        window, tf, jnp.float32(0.25), origin=(-hp, -hp), grid_range=(H, W),
        i_start=3, i_target=3 + n_done, tdv_lookup=lambda step, i: None,
        radius=radius, n_subiterations=k, n_steps=p,
        row_mode="shrink", col_mode="shrink",
    )
    assert got.shape == (H, W)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "mesh_shape", [(1, 8), (8, 1), (2, 4), (4, 2), (2, 2), (1, 1)], ids=str
)
def test_distributed_probe_contract_on_mesh(mesh_shape):
    """The probe contract (halo, coordinates, iteration and sub-iteration
    counting, TDV) holds on every mesh shape, with an iteration offset and
    a partial final pass (n=5, p=2)."""
    up = create_update(
        Params(
            transition_function=ProbeTransFunc(),
            halo_value=probe_halo_cell(),
            iteration_offset=2,
            n_iterations=5,
            tdv_strategy="precompute_on_host",
        ),
        backend="distributed",
        mesh=make_mesh(shape=mesh_shape),
        iters_per_pass=2,
    )
    out = up(make_probe_grid(19, 23, iteration_offset=2))
    check_probe_grid(out, 7)
    leaf = jax.tree.leaves(out.arrays)[0]
    assert len(leaf.sharding.device_set) == mesh_shape[0] * mesh_shape[1]


@pytest.mark.parametrize(
    "n,p,chunk", [(1, 1, 8), (5, 2, 8), (11, 1, 4), (17, 2, 16)],
    ids=lambda v: str(v),
)
def test_ring_partial_laps(n, p, chunk):
    """Iteration counts that end mid-lap (lap = 8 devices * p) and runs of
    several laps: cells past the target pass through unchanged."""
    up = create_update(
        Params(
            transition_function=ProbeTransFunc(),
            halo_value=probe_halo_cell(),
            iteration_offset=1,
            n_iterations=n,
        ),
        backend="ring",
        iters_per_pass=p,
        chunk_rows=chunk,
    )
    check_probe_grid(up(make_probe_grid(30, 9, iteration_offset=1)), 1 + n)


def test_ring_rejects_chunks_below_the_halo():
    with pytest.raises(ValueError, match="chunk_rows"):
        create_update(
            Params(transition_function=ProbeTransFunc(),
                   halo_value=probe_halo_cell(), n_iterations=8),
            backend="ring", iters_per_pass=4, chunk_rows=2,
        )(make_probe_grid(16, 8))


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 1)], ids=str)
def test_exchange_halo_moves_neighbour_strips(mesh_shape):
    """Each device's extended block holds its neighbours' boundary rows and
    columns (corners included, from the two-phase exchange) and zeros past
    the mesh edge."""
    ny, nx = mesh_shape
    h, w, halo = 6, 5, 2
    mesh = make_mesh(shape=mesh_shape)
    full = jnp.arange(ny * h * nx * w, dtype=jnp.float32).reshape(ny * h, nx * w) + 1

    spmd = jax.shard_map(
        lambda x: exchange_halo(x, halo, ("y", "x"), (ny, nx)),
        mesh=mesh, in_specs=P("y", "x"), out_specs=P("y", "x"), check_vma=False,
    )
    out = np.asarray(jax.jit(spmd)(full))
    padded = np.pad(np.asarray(full), halo)  # zeros past the grid edge
    eh, ew = h + 2 * halo, w + 2 * halo
    for iy in range(ny):
        for ix in range(nx):
            blk = out[iy * eh:(iy + 1) * eh, ix * ew:(ix + 1) * ew]
            want = padded[iy * h:iy * h + eh, ix * w:ix * w + ew]
            np.testing.assert_array_equal(blk, want, err_msg=str((iy, ix)))
