"""Equation-layer tests: closed forms and native samplers
(reference semantics: equations/equations.py:232-417)."""

import jax
import jax.numpy as jnp
import numpy as np

from scasml_gp.equations import GradDependentNonlinear, HJB


def make_eq(d=6):
    return GradDependentNonlinear(n_input=d + 1)


def test_constants():
    eq = make_eq(20)
    assert eq.sigma() == 0.25
    np.testing.assert_allclose(eq.mu(), -1.0 / 20 - 0.25**2 / 2)
    assert eq.T == 0.5 and eq.t0 == 0.0 and eq.radius == 0.5
    assert eq.uncertainty == 1e-1 and eq.norm_estimation == 1.0


def test_exact_solution_closed_form():
    eq = make_eq(5)
    x_t = jax.random.uniform(jax.random.PRNGKey(0), (7, 6), minval=-0.5, maxval=0.5)
    s = np.asarray(x_t[:, -1] + jnp.sum(x_t[:, :-1], axis=1))
    expected = 1.0 - 1.0 / (1.0 + np.exp(s))
    np.testing.assert_allclose(
        np.asarray(eq.exact_solution(x_t))[:, 0], expected, rtol=1e-6
    )
    # terminal constraint is the same closed form
    np.testing.assert_allclose(
        np.asarray(eq.g(x_t))[:, 0], expected, rtol=1e-6
    )


def test_exact_solution_derivative_matches_autodiff():
    eq = make_eq(5)
    x_t = jax.random.uniform(jax.random.PRNGKey(1), (4, 6), minval=-0.4, maxval=0.4)
    scalar = lambda v: eq.exact_solution(v[None, :])[0, 0]
    grads = jax.vmap(jax.grad(scalar))(x_t)  # (4, 6)
    # derivative is identical in every spatial coordinate
    np.testing.assert_allclose(
        np.asarray(eq.exact_solution_derivative(x_t))[:, 0],
        np.asarray(grads[:, 0]),
        rtol=1e-5,
    )


def test_exact_solution_satisfies_pde():
    """u_t + mu * sum_i u_i + (sigma^2/2) Lap u + f(x, u, sigma grad u) = 0."""
    eq = make_eq(4)
    x_t = jax.random.uniform(jax.random.PRNGKey(2), (8, 5), minval=-0.4, maxval=0.4)
    scalar = lambda v: eq.exact_solution(v[None, :])[0, 0]
    grads = jax.vmap(jax.grad(scalar))(x_t)
    hess = jax.vmap(jax.hessian(scalar))(x_t)
    u = eq.exact_solution(x_t)[:, 0]
    u_t = grads[:, -1]
    div_u = jnp.sum(grads[:, :-1], axis=1)
    lap_u = jax.vmap(jnp.trace)(hess[:, :-1, :-1])
    z = eq.sigma() * grads[:, :-1]
    f_val = eq.f(x_t, u[:, None], z)[:, 0]
    residual = u_t + eq.mu() * div_u + 0.5 * eq.sigma() ** 2 * lap_u + f_val
    np.testing.assert_allclose(np.asarray(residual), 0.0, atol=1e-5)


def test_samplers_shapes_and_ranges():
    eq = make_eq(10)
    dom, bdy = eq.generate_data(128, 64, key=jax.random.PRNGKey(3))
    assert dom.shape == (128, 11) and bdy.shape == (64, 11)
    assert float(jnp.max(jnp.abs(dom[:, :-1]))) <= 0.5
    assert 0.0 <= float(jnp.min(dom[:, -1])) and float(jnp.max(dom[:, -1])) <= 0.5
    # every boundary point has at least one coordinate on a facet
    on_facet = jnp.any(jnp.abs(jnp.abs(bdy[:, :-1]) - 0.5) < 1e-6, axis=1)
    assert bool(jnp.all(on_facet))


def test_sampler_determinism():
    eq = make_eq(3)
    a1, b1 = eq.generate_data(16, 8, key=jax.random.PRNGKey(5))
    a2, b2 = eq.generate_data(16, 8, key=jax.random.PRNGKey(5))
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))


def test_hjb_cole_hopf_terminal_consistency():
    """At t = T the Cole-Hopf MC solution must equal the terminal condition."""
    eq = HJB(n_input=5)
    x = jax.random.uniform(jax.random.PRNGKey(4), (6, 4), minval=-0.5, maxval=0.5)
    x_t = jnp.concatenate([x, jnp.full((6, 1), eq.T)], axis=1)
    np.testing.assert_allclose(
        np.asarray(eq.exact_solution(x_t)),
        np.asarray(eq.terminal_constraint(x_t)),
        rtol=1e-5,
        atol=1e-5,
    )
