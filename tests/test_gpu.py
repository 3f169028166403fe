"""Card-only tests: the update programs as XLA compiles them for an NVIDIA
GPU. Every test here is marked ``gpu`` and skips without one (decided at run
time by the fixture in conftest.py). Run them on the card with::

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

which is phase (0) of ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stencilstream_tpu.backends import create_update
from stencilstream_tpu.core import Grid, Params
from stencilstream_tpu.models import jacobi

from probe import ProbeTransFunc, check_probe_grid, make_probe_grid, probe_halo_cell

pytestmark = pytest.mark.gpu

COEFS = [0.15, 0.2, 0.25, 0.1, 0.3]


def _on(device, grid):
    return Grid(jax.device_put(grid.arrays, device))


@pytest.mark.parametrize("tdv", ["inline", "precompute_on_host", "precompute_on_device"])
def test_probe_contract_on_gpu(tdv):
    up = create_update(
        Params(
            transition_function=ProbeTransFunc(),
            halo_value=probe_halo_cell(),
            iteration_offset=2,
            n_iterations=3,
            tdv_strategy=tdv,
        ),
        backend="auto",
    )
    out = up(make_probe_grid(256, 256, iteration_offset=2))
    assert up.resolved_backend == "reference"
    assert jax.tree.leaves(out.arrays)[0].devices().pop().platform == "gpu"
    check_probe_grid(out, 5)


def test_distributed_1x1_mesh_probe_on_gpu():
    from stencilstream_tpu.parallel import make_mesh

    up = create_update(
        Params(
            transition_function=ProbeTransFunc(),
            halo_value=probe_halo_cell(),
            iteration_offset=1,
            n_iterations=5,
        ),
        backend="distributed",
        mesh=make_mesh(shape=(1, 1)),
        iters_per_pass=2,
    )
    check_probe_grid(up(make_probe_grid(64, 48, iteration_offset=1)), 6)


def test_conway_on_gpu_matches_numpy():
    from stencilstream_tpu.models import conway
    from test_models_basic import conway_step_np

    rng = np.random.default_rng(0)
    cells = rng.random((512, 512)) < 0.3
    out, update = conway.run(Grid.from_numpy(cells), 8)
    want = cells
    for _ in range(8):
        want = conway_step_np(want)
    np.testing.assert_array_equal(out.to_numpy(), want)


def test_jacobi_on_gpu_matches_cpu_device():
    """f32: FMA contraction and reassociation differ from the CPU by a few
    ulps per step — 1e-5 per iteration."""
    grid = jacobi.init_grid(512, 384)
    params = lambda: Params(transition_function=jacobi.make_kernel("jacobi5_general", COEFS),
                            n_iterations=8)
    gpu = create_update(params(), backend="reference")(grid).to_numpy()
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu = create_update(params(), backend="reference")(_on(cpu_dev, grid)).to_numpy()
    np.testing.assert_allclose(gpu, cpu, rtol=8e-5, atol=8e-5 * np.abs(cpu).max())


def test_convection_f64_on_gpu_matches_cpu_device():
    """The reference cell is 11 doubles: f64 compiles for the card and
    agrees with the CPU device to 1e-12 (relative to each field's scale)."""
    from stencilstream_tpu.models import convection

    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        e = convection.Experiment(
            lx=3.0, ly=1.0, px=1.5, py=0.5, eta0=1.0, DcT=1.0, deltaT=1.0,
            Ra=1e7, Pra=1e3, res=32, iterMax=400, nt=2, nout=1, nerr=50,
            epsilon=1e-3, dmp=2.0,
        )

        def run(device):
            with jax.default_device(device):
                grid = convection.init_grid(e, np.float64)
                up = create_update(
                    Params(
                        transition_function=convection.make_pseudo_transient_kernel(e, np.float64),
                        halo_value=convection.zero_cell(np.float64),
                        n_iterations=8,
                    ),
                    backend="reference",
                )
                return up(_on(device, grid)).to_numpy()

        gpu, cpu = run(jax.devices()[0]), run(jax.devices("cpu")[0])
        assert gpu.Vy.dtype == np.float64
        for f in ("Pt", "Vx", "Vy", "tau_xx", "sigma_xy", "ErrV"):
            g, c = getattr(gpu, f), getattr(cpu, f)
            np.testing.assert_allclose(g, c, rtol=1e-12, atol=1e-12 * np.abs(c).max(), err_msg=f)
    finally:
        jax.config.update("jax_enable_x64", old)


def test_bf16_storage_on_gpu():
    from stencilstream_tpu.backends.storage_cast import CastStorageKernel, cast_storage

    kernel = jacobi.make_kernel("jacobi5_general", COEFS)
    grid = jacobi.init_grid(512, 512)
    ref = create_update(Params(transition_function=kernel, n_iterations=4),
                        backend="reference")(grid)
    out = create_update(
        Params(transition_function=CastStorageKernel(kernel),
               halo_value=jnp.float32(0), n_iterations=4),
        backend="auto",
    )(cast_storage(grid))
    assert out.arrays.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(out.arrays, np.float32), ref.to_numpy(),
                               rtol=2e-2, atol=2e-2)


def test_fdtd_lut_on_gpu():
    """The LUT resolver's select chain and the host-precomputed TDV stream
    compile for the card and match the CPU device."""
    from stencilstream_tpu.models import fdtd

    params = fdtd.Parameters.from_json({
        "tau": 100e-15, "dx": 10e-9,
        "time": {"t_cutoff": 7.0, "t_detect": 4.0, "t_max": 0.01},
        "source": {"frequency": 120e12, "phase": 3.0, "x": 0, "y": 0, "radius": 0.0},
        "cavity_rings": [{"radius": 86e-9, "mu_r": 11.56, "eps_r": 1.0, "sigma": 0.0}],
    })
    resolver = fdtd.LUTResolver(params)
    grid = fdtd.init_grid(params, resolver)
    outs = []
    for device in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(device):
            update, _ = fdtd.build_simulation(
                params, resolver=resolver, backend="reference",
                tdv_strategy="precompute_on_host", n_iterations=8,
            )
            outs.append(update(_on(device, grid)).to_numpy().hz)
    np.testing.assert_allclose(outs[0], outs[1], rtol=8e-5, atol=8e-5 * np.abs(outs[1]).max())


def test_compiled_loop_on_gpu():
    """``lower(grid)`` hands back the program a call runs; compiled for the
    card it holds the iteration loop and reports its memory."""
    grid = jacobi.init_grid(1024, 1024)
    update = create_update(
        Params(transition_function=jacobi.make_kernel("jacobi5_general", COEFS),
               n_iterations=16),
        backend="auto",
    )
    compiled = update.lower(grid).compile()
    mem = compiled.memory_analysis()
    assert mem is not None and mem.argument_size_in_bytes >= 1024 * 1024 * 4
    assert "while" in compiled.as_text()
