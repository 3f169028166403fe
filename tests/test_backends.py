"""Cross-backend contract tests: auto / reference / distributed / ring vs
the numpy and reference oracles, driven by the self-verifying probe fixture
and a numeric kernel — the analog of the reference's backend sweeps
(``tests/monotile/StencilUpdate.cpp:38-79``, ``tests/tiling/...``)."""

import numpy as np
import pytest

import jax.numpy as jnp

from stencilstream_tpu.core import Grid, Params
from stencilstream_tpu.backends import create_update
from stencilstream_tpu.models import jacobi

from probe import (
    ProbeTransFunc,
    backend_kwargs,
    check_probe_grid,
    make_probe_grid,
    probe_halo_cell,
)


BACKENDS = [
    ("auto", {}),
    ("reference", {}),
    # Row mesh over all 8 devices, p=2: partial final pass at n=3 and n=5.
    ("distributed", dict(iters_per_pass=2)),
    # 2-D mesh with p=3: halos on both axes, partial final pass.
    ("distributed", dict(mesh_shape=(2, 4), iters_per_pass=3)),
    # n < 8 devices * p: every run ends mid-lap.
    ("ring", dict(iters_per_pass=1, chunk_rows=8)),
    ("ring", dict(iters_per_pass=2, chunk_rows=8)),
]


def jacobi_oracle(grid_np, coefs, n):
    ref = np.asarray(grid_np)
    for _ in range(n):
        p = np.pad(ref, 1)
        ref = (
            coefs[0] * p[:-2, 1:-1]
            + coefs[1] * p[1:-1, :-2]
            + coefs[2] * p[2:, 1:-1]
            + coefs[3] * p[1:-1, 2:]
            + coefs[4] * p[1:-1, 1:-1]
        ).astype(np.float32)
    return ref


@pytest.mark.parametrize("backend,kw", BACKENDS, ids=lambda b: str(b))
def test_jacobi_parity(backend, kw):
    coefs = [0.15, 0.2, 0.25, 0.1, 0.3]
    kernel = jacobi.make_kernel("jacobi5_general", coefs)
    grid = jacobi.init_grid(24, 40)
    up = create_update(
        Params(transition_function=kernel, n_iterations=5, blocking=True),
        backend=backend,
        **backend_kwargs(kw),
    )
    out = up(grid).to_numpy()
    np.testing.assert_allclose(out, jacobi_oracle(grid.to_numpy(), coefs, 5), rtol=1e-5)


@pytest.mark.parametrize("backend,kw", BACKENDS, ids=lambda b: str(b))
@pytest.mark.parametrize("tdv", ["inline", "precompute_on_host", "precompute_on_device"])
def test_probe_contract(backend, kw, tdv):
    """Halo handling, iteration/sub-iteration counting, TDV plumbing, and
    cell-position integrity, asserted from inside the kernel (probe cells),
    with a non-zero iteration offset and a partial final pass."""
    up = create_update(
        Params(
            transition_function=ProbeTransFunc(),
            halo_value=probe_halo_cell(),
            iteration_offset=2,
            n_iterations=3,
            tdv_strategy=tdv,
        ),
        backend=backend,
        **backend_kwargs(kw),
    )
    out = up(make_probe_grid(12, 11, iteration_offset=2))
    check_probe_grid(out, 5)


@pytest.mark.parametrize("backend,kw", BACKENDS, ids=lambda b: str(b))
def test_conway_bool_cells(backend, kw):
    """bool cells (int8/int32 re-encoding paths) — blinker oscillates."""
    from stencilstream_tpu.models.conway import ConwayKernel

    g = np.zeros((8, 8), bool)
    g[3, 2:5] = True  # horizontal blinker
    up = create_update(
        Params(
            transition_function=ConwayKernel(),
            halo_value=jnp.asarray(False),
            n_iterations=2,
            blocking=True,
        ),
        backend=backend,
        **backend_kwargs(kw),
    )
    out = up(Grid.from_numpy(g)).to_numpy()
    np.testing.assert_array_equal(out, g)


def test_mesh_factor():
    from stencilstream_tpu.parallel import mesh_factor

    assert mesh_factor(8) == (2, 4)
    assert mesh_factor(4) == (2, 2)
    assert mesh_factor(1) == (1, 1)
    assert mesh_factor(6) == (2, 3)


def test_distributed_uses_all_devices():
    import jax
    from stencilstream_tpu.parallel import make_mesh

    mesh = make_mesh()
    assert mesh.devices.size == len(jax.devices())


from stencilstream_tpu.core import transition_function


@transition_function
class _SelfClampingKernel:
    """Minimal ``handles_boundary`` kernel: clamps every out-of-grid tap via
    ``stencil.id`` (the HotSpot boundary pattern, hotspot.cpp:77-87). The
    fused backends skip halo-value substitution for it — out-of-window taps
    hold wrapped garbage the kernel must fully discard; parity with the
    oracle (which still presents the halo value) proves the contract."""

    stencil_radius = 1
    n_subiterations = 1
    handles_boundary = True

    def __call__(self, s):
        c = s[0, 0]
        h, w = s.grid_range
        top = jnp.where(s.row == 0, c, s[-1, 0])
        bottom = jnp.where(s.row == h - 1, c, s[1, 0])
        left = jnp.where(s.col == 0, c, s[0, -1])
        right = jnp.where(s.col == w - 1, c, s[0, 1])
        return 0.2 * c + 0.2 * (top + bottom + left + right)

    def get_time_dependent_value(self, i):
        return None


@pytest.mark.parametrize("backend,kw", BACKENDS, ids=lambda b: str(b))
def test_handles_boundary_parity(backend, kw):
    """A handles_boundary kernel must match the oracle bit-for-bit on every
    backend, including at grid edges where wrap garbage must be fully
    clamped away."""
    kernel = _SelfClampingKernel()
    rng = np.random.default_rng(5)
    grid = Grid.from_numpy(rng.random((28, 37), np.float32))
    ref = create_update(
        Params(transition_function=kernel, n_iterations=5, blocking=True),
        backend="reference",
    )
    up = create_update(
        Params(transition_function=kernel, n_iterations=5, blocking=True),
        backend=backend,
        **backend_kwargs(kw),
    )
    a = ref(grid).to_numpy()
    b = up(grid).to_numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (2, 2)], ids=str)
def test_distributed_2d_pallas_probe(mesh_shape):
    """The distributed path on a 2D mesh (two-phase row + column halo
    exchange): the probe contract must hold across both mesh axes,
    including a partial final pass and an iteration offset."""
    from stencilstream_tpu.parallel import make_mesh

    up = create_update(
        Params(
            transition_function=ProbeTransFunc(),
            halo_value=probe_halo_cell(),
            iteration_offset=1,
            n_iterations=3,
        ),
        backend="distributed",
        mesh=make_mesh(shape=mesh_shape),
        iters_per_pass=2,
    )
    out = up(make_probe_grid(13, 21, iteration_offset=1))
    check_probe_grid(out, 4)


def test_distributed_2d_pallas_jacobi_parity():
    coefs = [0.15, 0.2, 0.25, 0.1, 0.3]
    kernel = jacobi.make_kernel("jacobi5_general", coefs)
    grid = jacobi.init_grid(40, 152)
    from stencilstream_tpu.parallel import make_mesh

    up = create_update(
        Params(transition_function=kernel, n_iterations=5, blocking=True),
        backend="distributed",
        mesh=make_mesh(shape=(2, 4)),
        iters_per_pass=2,
    )
    out = up(grid).to_numpy()
    np.testing.assert_allclose(out, jacobi_oracle(grid.to_numpy(), coefs, 5), rtol=1e-5)
