"""bf16-storage wrapper (``backends/storage_cast.py``): taps upcast to f32
for compute, results stored bf16 — the traffic-halving option for the
bandwidth-bound regime."""

import numpy as np
import jax.numpy as jnp
import pytest

from stencilstream_tpu.core import Grid, Params
from stencilstream_tpu.backends import create_update
from stencilstream_tpu.backends.storage_cast import CastStorageKernel, cast_storage

from probe import backend_kwargs


def _jacobi():
    from stencilstream_tpu.models import jacobi

    kernel = jacobi.make_kernel("jacobi5_general", [0.15, 0.2, 0.25, 0.1, 0.3])
    grid = jacobi.init_grid(96, 256)
    return grid, kernel, jnp.float32(0.0)


@pytest.mark.parametrize("backend,kw", [
    ("reference", {}),
    ("distributed", dict(mesh_shape=(2, 4), iters_per_pass=3)),
    ("ring", dict(iters_per_pass=1, chunk_rows=16)),
])
def test_bf16_storage_tracks_f32(backend, kw):
    """bf16 storage must produce bf16 output arrays that track the f32 run
    within bf16 rounding (8 mantissa bits, relative ~1e-2 after a few
    iterations of an averaging kernel)."""
    grid, kernel, halo = _jacobi()
    n = 4
    f32 = create_update(
        Params(transition_function=kernel, halo_value=halo, n_iterations=n,
               blocking=True),
        backend=backend, **backend_kwargs(kw),
    )(grid)
    up = create_update(
        Params(transition_function=CastStorageKernel(kernel), halo_value=halo,
               n_iterations=n, blocking=True),
        backend=backend, **backend_kwargs(kw),
    )
    out = up(cast_storage(grid))
    arr = out.arrays
    assert arr.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(arr, np.float32), f32.to_numpy(), rtol=2e-2, atol=2e-2
    )


def test_contract_passthrough():
    """radius / sub-iterations / TDV / handles_boundary all forward."""
    from stencilstream_tpu.models.hotspot import derive_coefficients

    inner = derive_coefficients(64, 64)
    tf = CastStorageKernel(inner)
    assert tf.stencil_radius == inner.stencil_radius
    assert tf.n_subiterations == inner.n_subiterations
    assert tf.handles_boundary == getattr(inner, "handles_boundary", False)
    i = jnp.asarray(3, jnp.int32)
    assert tf.get_time_dependent_value(i) == inner.get_time_dependent_value(i)


def test_hotspot_bf16_storage_boundary_kernel():
    """hotspot clamps boundaries via stencil.id inside the kernel
    (handles_boundary=True skips halo masks in the fused window passes):
    the cast wrapper must keep that path intact — compare against the f32
    oracle."""
    from stencilstream_tpu.models.hotspot import HotspotCell, derive_coefficients

    rng = np.random.default_rng(3)
    h, w = 64, 256
    grid = Grid.from_numpy(HotspotCell(
        temp=rng.uniform(70, 90, (h, w)).astype(np.float32),
        power=rng.uniform(0, 1e-3, (h, w)).astype(np.float32)))
    kernel = derive_coefficients(h, w)
    halo = HotspotCell(temp=jnp.float32(0), power=jnp.float32(0))
    n = 4
    ref = create_update(
        Params(transition_function=kernel, halo_value=halo, n_iterations=n),
        backend="reference",
    )(grid)
    up = create_update(
        Params(transition_function=CastStorageKernel(kernel), halo_value=halo,
               n_iterations=n, blocking=True),
        backend="ring", iters_per_pass=2, chunk_rows=16,
    )
    out = up(cast_storage(grid))
    assert out.arrays.temp.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(out.arrays.temp, np.float32), ref.to_numpy().temp,
        rtol=2e-2, atol=0.5,
    )


def test_cast_storage_leaves_non_f32_alone():
    arrays = {"a": jnp.ones((8, 8), jnp.float32),
              "i": jnp.ones((8, 8), jnp.int32)}
    out = cast_storage(arrays)
    assert out["a"].dtype == jnp.bfloat16
    assert out["i"].dtype == jnp.int32


def test_bf16_storage_through_distributed_mesh():
    """bf16 storage across the 8-device mesh: the halo exchange moves bf16
    rows and columns, and results track the f32 oracle."""
    grid, kernel, halo = _jacobi()
    n = 4
    ref = create_update(
        Params(transition_function=kernel, halo_value=halo, n_iterations=n,
               blocking=True),
        backend="reference",
    )(grid)
    up = create_update(
        Params(transition_function=CastStorageKernel(kernel), halo_value=halo,
               n_iterations=n, blocking=True),
        backend="distributed", iters_per_pass=2,
    )
    out = up(cast_storage(grid))
    assert out.arrays.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(out.arrays, np.float32), ref.to_numpy(),
        rtol=2e-2, atol=2e-2,
    )


def test_fp8_storage_through_tiling():
    """float8_e4m3 storage: the storage_cast machinery is dtype-parametric,
    so fp8 rides the same wrapper — 1-byte cells quarter the bytes per
    iteration. Numerics: 3 mantissa bits round each stored iteration to ~1
    significant decimal digit; the tolerance contract is correspondingly
    loose (bandwidth-bound throughput studies, not convergence-critical
    runs)."""
    grid, kernel, halo = _jacobi()
    f8 = jnp.float8_e4m3fn
    n = 4
    ref = create_update(
        Params(transition_function=kernel, halo_value=halo, n_iterations=n,
               blocking=True),
        backend="reference",
    )(grid)
    up = create_update(
        Params(transition_function=CastStorageKernel(kernel, f8),
               halo_value=halo, n_iterations=n, blocking=True),
        backend="distributed", iters_per_pass=2)
    out = up(cast_storage(grid, f8))
    assert out.arrays.dtype == f8
    np.testing.assert_allclose(
        np.asarray(out.arrays, np.float32), ref.to_numpy(),
        rtol=0.15, atol=0.15,
    )
