"""Posterior derivative outputs vs autodiff for the SEPARABLE kernel
(gs != gt) — guards the inline polynomial assembly in posterior.py, which
does not go through kernels.grad_coeffs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scasml_gp.gp.kernels import kernel_gammas
from scasml_gp.gp.posterior import posterior_eval

D = 5
N_DOM, N_BDY = 40, 15


@pytest.fixture(scope="module")
def state():
    key = jax.random.PRNGKey(1)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    x_dom = jax.random.uniform(k1, (N_DOM, D + 1), minval=-0.5, maxval=0.5)
    x_bdy = jax.random.uniform(k2, (N_BDY, D + 1), minval=-0.5, maxval=0.5)
    x = jax.random.uniform(k3, (9, D + 1), minval=-0.4, maxval=0.4)
    r = jax.random.normal(k4, (4 * N_DOM + N_BDY,))
    return x, x_dom, x_bdy, r


GAMMAS = [
    kernel_gammas(0.25, D, time_scale=0.35),
    kernel_gammas(0.25, D, time_scale=0.7, ridge_scale=6.0),
]


import pytest


@pytest.mark.parametrize("gamma", GAMMAS)
def test_separable_grad_and_ops_match_autodiff(state, gamma):
    x, x_dom, x_bdy, r = state
    gamma = jnp.asarray(gamma, jnp.float32)

    def u_scalar(v):
        return posterior_eval(v[None, :], x_dom, x_bdy, r, gamma, D).u[0]

    grads = jax.vmap(jax.grad(u_scalar))(x)
    hess = jax.vmap(jax.hessian(u_scalar))(x)

    out = posterior_eval(x, x_dom, x_bdy, r, gamma, D, want_grad=True,
                         want_ops=True)
    np.testing.assert_allclose(np.asarray(out.grad), np.asarray(grads),
                               rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(np.asarray(out.dt_u), np.asarray(grads[:, -1]),
                               rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(
        np.asarray(out.div_u), np.asarray(jnp.sum(grads[:, :-1], axis=1)),
        rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(
        np.asarray(out.lap_u),
        np.asarray(jax.vmap(jnp.trace)(hess[:, :-1, :-1])),
        rtol=5e-4, atol=2e-4)
