"""The reference's host-loop usage patterns on every backend (SURVEY.md
§2.8): resume via iteration_offset, param mutation without recompilation,
and two updaters alternating on one grid."""

import numpy as np
import pytest

import jax

from stencilstream_tpu.core import Params
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
    ("reference", {}),
    # 2-D mesh, p=3: the 3 + 3 resume split and n=2 both end mid-pass.
    ("distributed", dict(mesh_shape=(2, 4), iters_per_pass=3)),
    ("auto", {}),
    # Partial lap: n < 8 devices * p.
    ("ring", dict(iters_per_pass=1, chunk_rows=8)),
]


@pytest.mark.parametrize("backend,kw", BACKENDS, ids=lambda b: str(b))
def test_snapshot_resume_equals_one_shot(backend, kw):
    """n iterations in one call == two calls split by iteration_offset
    (the FDTD snapshot-loop pattern, ``examples/fdtd/src/fdtd.cpp:233-242``)."""
    one = create_update(
        Params(
            transition_function=ProbeTransFunc(),
            halo_value=probe_halo_cell(),
            n_iterations=6,
        ),
        backend=backend,
        **backend_kwargs(kw),
    )
    out_one = one(make_probe_grid(10, 13))
    check_probe_grid(out_one, 6)

    split = create_update(
        Params(
            transition_function=ProbeTransFunc(),
            halo_value=probe_halo_cell(),
            n_iterations=3,
        ),
        backend=backend,
        **backend_kwargs(kw),
    )
    mid = split(make_probe_grid(10, 13))
    split.get_params().iteration_offset = 3
    out_split = split(mid)
    check_probe_grid(out_split, 6)

    np.testing.assert_array_equal(
        out_one.to_numpy().i_iteration, out_split.to_numpy().i_iteration
    )


@pytest.mark.parametrize("backend,kw", BACKENDS, ids=lambda b: str(b))
def test_param_mutation_no_recompile(backend, kw):
    """Mutating a traced transition-function field between calls changes the
    result without recompiling (the convection adaptive-dt pattern,
    ``examples/convection/convection.cpp:452-457``)."""
    kernel = jacobi.make_kernel("jacobi1_general", [0.5])
    grid = jacobi.init_grid(16, 16)
    up = create_update(
        Params(transition_function=kernel, n_iterations=2, blocking=True),
        backend=backend,
        **backend_kwargs(kw),
    )

    out_half = up(grid).to_numpy()
    before = _n_jit_compiles()
    up.get_params().transition_function.coef = 1.0
    out_one = up(grid).to_numpy()
    after = _n_jit_compiles()

    np.testing.assert_allclose(out_one, grid.to_numpy())  # coef=1: identity
    np.testing.assert_allclose(out_half, grid.to_numpy() * 0.25)
    assert after == before, "param mutation must not recompile"


def _n_jit_compiles() -> int:
    # jax exposes compilation counts through the monitoring counter registry
    try:
        from jax._src import monitoring

        return monitoring._counter_events.get("jax_jit_compiles", 0)  # type: ignore
    except Exception:
        return 0


@pytest.mark.parametrize("backend,kw", BACKENDS[:2], ids=lambda b: str(b))
def test_two_updaters_alternate_on_one_grid(backend, kw):
    """Two different transition functions applied alternately to the same
    grid (the convection pseudo-transient + thermal pattern)."""
    scale = create_update(
        Params(
            transition_function=jacobi.make_kernel("jacobi1_general", [0.5]),
            n_iterations=1,
            blocking=True,
        ),
        backend=backend,
        **backend_kwargs(kw),
    )
    avg = create_update(
        Params(
            transition_function=jacobi.make_kernel("jacobi2_constant", []),
            n_iterations=1,
            blocking=True,
        ),
        backend=backend,
        **backend_kwargs(kw),
    )
    grid = jacobi.init_grid(16, 16)
    g = scale(grid)
    g = avg(g)
    g = scale(g)

    ref = grid.to_numpy() * 0.5
    p = np.pad(ref, 1)
    ref = ((p[:-2, 1:-1] + p[2:, 1:-1]) * 0.5).astype(np.float32)
    ref = ref * 0.5
    np.testing.assert_allclose(g.to_numpy(), ref, rtol=1e-6)
