"""SineNonlinear: the manufactured-solution semilinear sine family.

Validates (a) the manufactured forcing against a pure-autodiff evaluation of
the PDE operator on the exact solution, (b) the SineForm collocation algebra
(F/dF/d2F) against autodiff of F, (c) the strong-form residual at the exact
solution's own features, and (d) the full GP -> MLP -> ScaSML pipeline
against the closed form — the same oracle strategy the reference uses for
its one family (tests/SimpleUniform.py:87,121-136)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scasml_gp.config import GPConfig
from scasml_gp.equations import SineNonlinear
from scasml_gp.gp.solver import GPSineNonlinear, SineForm
from scasml_gp.picard import MLPFullHistory, ScaSMLFullHistory

D = 4


def _rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_manufactured_solution_satisfies_pde():
    """u_t + mu sum_i u_xi + (sigma^2/2) Lap u + f(x, u, sigma grad u) == 0,
    with every derivative taken by autodiff of exact_solution (no reuse of
    the hand-derived formulas under test)."""
    eq = SineNonlinear(n_input=D + 1)

    def u_scalar(x_t_row):
        return eq.exact_solution(x_t_row[None, :])[0, 0]

    x_t = eq.geometry().sample_domain(jax.random.PRNGKey(0), 64)
    grad_fn = jax.vmap(jax.grad(u_scalar))
    hess_fn = jax.vmap(jax.hessian(u_scalar))
    g = grad_fn(x_t)                      # (n, d+1): spatial cols + time col
    u_t = g[:, -1]
    grad_x = g[:, :-1]
    lap = jax.vmap(jnp.trace)(hess_fn(x_t)[:, :-1, :-1])
    u = eq.exact_solution(x_t)
    z = eq.sigma() * grad_x
    resid = (
        u_t
        + eq.mu() * jnp.sum(grad_x, axis=1)
        + 0.5 * eq.sigma() ** 2 * lap
        + eq.f(x_t, u, z)[:, 0]
    )
    np.testing.assert_allclose(np.asarray(resid), 0.0, atol=5e-6)


def test_exact_solution_derivative_matches_autodiff():
    eq = SineNonlinear(n_input=D + 1)
    x_t = eq.geometry().sample_domain(jax.random.PRNGKey(1), 32)

    def u_scalar(x_t_row):
        return eq.exact_solution(x_t_row[None, :])[0, 0]

    g = jax.vmap(jax.grad(u_scalar))(x_t)[:, :-1]
    np.testing.assert_allclose(
        np.asarray(eq.exact_solution_derivative(x_t)), np.asarray(g),
        atol=5e-6,
    )


def test_sine_form_derivatives_match_autodiff():
    eq = SineNonlinear(n_input=D + 1)
    form = SineForm(eq)
    key = jax.random.PRNGKey(2)
    z1, z3, z5, w = (
        jax.random.normal(k, (16,))
        for k in jax.random.split(key, 4)
    )
    rhs = jnp.zeros_like(z1)

    def F_elem(a, b, c):
        return form.F(a[None], b[None], c[None], rhs[:1])[0]

    f1, f3, f5 = form.dF(z1, z3, z5)
    g = jax.vmap(jax.grad(F_elem, argnums=(0, 1, 2)))(z1, z3, z5)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(g[0]), atol=5e-6)
    np.testing.assert_allclose(np.asarray(f3), np.asarray(g[1]), atol=5e-6)
    np.testing.assert_allclose(np.asarray(f5), np.asarray(g[2]), atol=5e-6)

    # sum_i w_i Hess(F_i) has a single nonzero block: d2F/dz1^2 = sin(z1)
    blocks = form.d2F_contraction(w, z1, z3, z5)
    h11 = jax.vmap(jax.grad(jax.grad(F_elem, argnums=0), argnums=0))(
        z1, z3, z5
    )
    np.testing.assert_allclose(
        np.asarray(blocks[(0, 0)]), np.asarray(w * h11), atol=5e-6
    )
    assert set(blocks) == {(0, 0)}


def test_residual_vanishes_on_exact_features():
    """form.residual fed with the exact solution's own (u, u_t, div, Lap)."""
    eq = SineNonlinear(n_input=D + 1)
    form = SineForm(eq)
    x_t = eq.geometry().sample_domain(jax.random.PRNGKey(3), 48)

    def u_scalar(x_t_row):
        return eq.exact_solution(x_t_row[None, :])[0, 0]

    g = jax.vmap(jax.grad(u_scalar))(x_t)
    lap = jax.vmap(jnp.trace)(jax.vmap(jax.hessian(u_scalar))(x_t)[:, :-1, :-1])
    u = eq.exact_solution(x_t)[:, 0]
    resid = form.residual(x_t, u, g[:, -1], jnp.sum(g[:, :-1], axis=1), lap)
    np.testing.assert_allclose(np.asarray(resid), 0.0, atol=5e-6)
    # and the forcing really is nonzero (the rhs_f path is exercised)
    assert float(jnp.max(jnp.abs(form.rhs_f(x_t)))) > 0.1


@pytest.fixture(scope="module")
def trained_sine_gp():
    eq = SineNonlinear(n_input=D + 1)
    gp = GPSineNonlinear(eq, GPConfig(gn_steps=10))
    x_dom, x_bdy = eq.generate_data(200, 50, key=jax.random.PRNGKey(4))
    gp.GPsolver(x_dom, x_bdy)
    return eq, gp


def test_sine_gp_accuracy_and_residual(trained_sine_gp):
    eq, gp = trained_sine_gp
    x_test = eq.geometry().sample_domain(jax.random.PRNGKey(5), 256)
    rel = _rel(gp.predict(x_test), eq.exact_solution(x_test))
    assert rel < 0.1, rel
    eps = np.asarray(gp.compute_PDE_loss(x_test))
    assert np.isfinite(eps).all()
    # collocation drives the strong-form residual small on average
    assert float(np.abs(eps).mean()) < 0.2


def test_sine_mlp_and_scasml_pipeline(trained_sine_gp):
    eq, gp = trained_sine_gp
    x_test = eq.geometry().sample_domain(jax.random.PRNGKey(6), 200)
    exact = eq.exact_solution(x_test)

    mlp = MLPFullHistory(eq)
    rel_mlp = _rel(mlp.u_solve(2, None, x_test, M=8), exact)
    assert rel_mlp < 0.25, rel_mlp

    sca = ScaSMLFullHistory(eq, gp)
    rel_gp = _rel(gp.predict(x_test), exact)
    rel_sca = _rel(sca.u_solve(2, None, x_test, M=8), exact)
    # the correction must not degrade a good surrogate materially
    assert rel_sca < max(1.5 * rel_gp, 0.1), (rel_sca, rel_gp)
