"""Differentiability of stencil updates — a JAX-native capability beyond the
reference: because updates are pure traced functions, gradients flow through
whole simulations (adjoint/sensitivity analysis, parameter fitting)."""

import jax
import jax.numpy as jnp
import numpy as np

from stencilstream_tpu import Grid, Params, reference
from stencilstream_tpu.models import jacobi


def test_grad_through_simulation_wrt_initial_state():
    kernel = jacobi.make_kernel("jacobi5_general", [0.15, 0.2, 0.25, 0.1, 0.3])

    def loss(x0):
        out = reference.apply_iterations(Grid(x0), kernel, 4)
        return jnp.sum(out.arrays**2)

    x0 = jnp.ones((12, 12), jnp.float32)
    g = jax.grad(loss)(x0)
    assert g.shape == (12, 12)
    assert np.isfinite(np.asarray(g)).all()
    # finite-difference check at one point
    eps = 1e-2
    bumped = x0.at[5, 5].add(eps)
    fd = (loss(bumped) - loss(x0)) / eps
    np.testing.assert_allclose(float(g[5, 5]), float(fd), rtol=2e-2)


def test_grad_wrt_kernel_parameter():
    """d(loss)/d(coefficient) — the transition function's runtime parameters
    are traced pytree leaves, so they are differentiable too."""

    def loss(coef):
        kernel = jacobi.Jacobi1General(coef=coef)
        grid = jacobi.init_grid(8, 8)
        out = reference.apply_iterations(grid, kernel, 3)
        return jnp.sum(out.arrays)

    g = jax.grad(loss)(jnp.float32(0.5))
    # loss = sum(init) * coef^3  =>  dloss/dcoef = 3 * coef^2 * sum(init)
    init_sum = float(jacobi.init_grid(8, 8).to_numpy().sum())
    np.testing.assert_allclose(float(g), 3 * 0.25 * init_sum, rtol=1e-5)
