"""All example apps through auto and the multi-device backends vs the
reference oracle — the app-level analog of the reference's backend test
sweeps (``tests/monotile/StencilUpdate.cpp:38-79``)."""

import numpy as np
import pytest

import jax.numpy as jnp

from stencilstream_tpu.core import Grid, Params
from stencilstream_tpu.backends import create_update
from stencilstream_tpu.models import convection, fdtd

from probe import backend_kwargs

BACKENDS = [
    ("auto", {}),
    ("distributed", dict(iters_per_pass=2)),
    # 2-D mesh, p=3: partial final pass on every app's iteration count.
    ("distributed", dict(mesh_shape=(2, 4), iters_per_pass=3)),
    # Partial lap: n < 8 devices * p.
    ("ring", dict(iters_per_pass=1, chunk_rows=8)),
]


def fdtd_tiny_config():
    return {
        "tau": 100e-15,
        "dx": 10e-9,
        "time": {"t_cutoff": 7.0, "t_detect": 4.0, "t_max": 0.01},
        "source": {"frequency": 120e12, "phase": 3.0, "x": 0, "y": 0, "radius": 0.0},
        "cavity_rings": [
            {"radius": 86e-9, "mu_r": 11.56, "eps_r": 1.0, "sigma": 0.0}
        ],
    }


@pytest.mark.parametrize("backend,kw", BACKENDS, ids=lambda b: str(b))
def test_hotspot(backend, kw):
    from stencilstream_tpu.models.hotspot import HotspotCell, derive_coefficients

    rng = np.random.default_rng(0)
    grid = Grid.from_numpy(
        HotspotCell(
            temp=rng.uniform(70, 90, (16, 24)).astype(np.float32),
            power=rng.uniform(0, 1e-3, (16, 24)).astype(np.float32),
        )
    )
    kernel = derive_coefficients(16, 24)

    def make_params():
        return Params(
            transition_function=kernel,
            halo_value=HotspotCell(temp=jnp.float32(0), power=jnp.float32(0)),
            n_iterations=5,
        )

    ref = create_update(make_params(), backend="reference")(grid).to_numpy()
    out = create_update(make_params(), backend=backend, **backend_kwargs(kw))(grid).to_numpy()
    np.testing.assert_allclose(out.temp, ref.temp, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend,kw", BACKENDS, ids=lambda b: str(b))
@pytest.mark.parametrize("material", ["coef", "lut", "render"])
def test_fdtd(backend, kw, material):
    """k=2 sub-iterations + TDV source wave + the three material resolvers
    (the LUT one exercises an in-kernel table gather)."""
    params = fdtd.Parameters.from_json(fdtd_tiny_config())
    resolver = fdtd.RESOLVERS[material](params)
    grid = fdtd.init_grid(params, resolver)

    outs = {}
    for b, k in (("reference", {}), (backend, backend_kwargs(kw))):
        update, _ = fdtd.build_simulation(
            params,
            resolver=resolver,
            backend=b,
            tdv_strategy="precompute_on_host",
            n_iterations=4,
            **k,
        )
        outs[b] = update(grid).to_numpy()
    ref, out = outs["reference"], outs[backend]
    for field in ("hz", "hz_sum", "ex", "ey"):
        np.testing.assert_allclose(
            getattr(out, field),
            getattr(ref, field),
            rtol=1e-5,
            atol=1e-7,
            err_msg=f"{material}/{field}",
        )


@pytest.mark.parametrize("backend,kw", BACKENDS, ids=lambda b: str(b))
def test_convection_pseudo_transient(backend, kw):
    """11-field cells, k=3 sub-iterations, non-square active region."""
    e = convection.Experiment(
        lx=3.0, ly=1.0, px=1.5, py=0.5, eta0=1.0, DcT=1.0, deltaT=1.0,
        Ra=1e7, Pra=1e3, res=16, iterMax=400, nt=2, nout=1, nerr=50,
        epsilon=1e-3, dmp=2.0,
    )
    grid = convection.init_grid(e)

    def make_params():
        return Params(
            transition_function=convection.make_pseudo_transient_kernel(e),
            halo_value=convection.zero_cell(),
            n_iterations=2,
        )

    ref = create_update(make_params(), backend="reference")(grid).to_numpy()
    out = create_update(make_params(), backend=backend, **backend_kwargs(kw))(grid).to_numpy()
    for f in ("T", "Vx", "Vy", "Pt", "ErrV", "ErrP"):
        np.testing.assert_allclose(
            getattr(out, f), getattr(ref, f), rtol=1e-4, atol=1e-6, err_msg=f
        )
