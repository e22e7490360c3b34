"""GP surrogate tests: Gram properties, posterior-vs-autodiff consistency,
Newton training convergence, and end-to-end accuracy on a small problem."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scasml_gp.config import GPConfig
from scasml_gp.equations import GradDependentNonlinear
from scasml_gp.gp import (
    GPGradDependentNonlinear,
    GPState,
    gram_matrix,
    kernel_gamma,
    load_state,
    posterior_eval,
    regularized_factorization,
    save_state,
)

D = 4


@pytest.fixture(scope="module")
def trained():
    eq = GradDependentNonlinear(n_input=D + 1)
    gp = GPGradDependentNonlinear(eq, GPConfig(gn_steps=12))
    x_dom, x_bdy = eq.generate_data(120, 40, key=jax.random.PRNGKey(0))
    gp.GPsolver(x_dom, x_bdy)
    return eq, gp


def test_gram_symmetric_and_factorization():
    eq = GradDependentNonlinear(n_input=D + 1)
    x_dom, x_bdy = eq.generate_data(30, 10, key=jax.random.PRNGKey(1))
    gamma = kernel_gamma(eq.sigma(), D)
    K = gram_matrix(x_dom, x_bdy, gamma, D)
    assert K.shape == (4 * 30 + 10, 4 * 30 + 10)
    np.testing.assert_allclose(np.asarray(K), np.asarray(K.T), rtol=0, atol=1e-3)
    K_pert, C = regularized_factorization(K, 1e-2)
    # C must actually invert K + nugget I
    np.testing.assert_allclose(
        np.asarray(K_pert @ C), np.eye(K.shape[0]), atol=5e-3
    )


def test_training_reduces_loss(trained):
    _, gp = trained
    hist = np.asarray(gp.state.loss_history)
    nonzero = hist[hist > 0]
    assert nonzero[-1] < nonzero[0] * 1e-2, f"loss history {hist}"


def test_gp_accuracy_small_problem(trained):
    eq, gp = trained
    x_test, _ = eq.generate_test_data(400, 1, key=jax.random.PRNGKey(2))
    pred = np.asarray(gp.predict(x_test)).ravel()
    exact = np.asarray(eq.exact_solution(x_test)).ravel()
    rel_l2 = np.linalg.norm(pred - exact) / np.linalg.norm(exact)
    # the reference GP reaches ~0.15 rel-L2 at d=20 with 1000+200 points
    # (BASELINE.md); at d=4 with 120+40 points the nugget-regularized fit
    # lands near 0.10 (0.04 with 300+80 — error is data-limited).
    assert rel_l2 < 0.13, f"rel_l2={rel_l2}"


def test_posterior_gradient_matches_autodiff(trained):
    eq, gp = trained
    st = gp.state
    x = jax.random.uniform(jax.random.PRNGKey(3), (7, D + 1), minval=-0.4, maxval=0.4)

    def u_scalar(v):
        out = posterior_eval(v[None, :], st.x_dom, st.x_bdy, st.right_vector,
                             st.gamma, D)
        return out.u[0]

    expected = jax.vmap(jax.grad(u_scalar))(x)
    got = gp.compute_gradient(x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                               rtol=5e-3, atol=5e-4)


def test_posterior_ops_match_autodiff(trained):
    eq, gp = trained
    st = gp.state
    x = jax.random.uniform(jax.random.PRNGKey(4), (5, D + 1), minval=-0.3, maxval=0.3)

    def u_scalar(v):
        out = posterior_eval(v[None, :], st.x_dom, st.x_bdy, st.right_vector,
                             st.gamma, D)
        return out.u[0]

    grads = jax.vmap(jax.grad(u_scalar))(x)
    hess = jax.vmap(jax.hessian(u_scalar))(x)
    out = posterior_eval(x, st.x_dom, st.x_bdy, st.right_vector, st.gamma, D,
                         want_ops=True)
    np.testing.assert_allclose(np.asarray(out.dt_u), np.asarray(grads[:, -1]),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(np.asarray(out.div_u),
                               np.asarray(jnp.sum(grads[:, :-1], axis=1)),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(
        np.asarray(out.lap_u),
        np.asarray(jax.vmap(jnp.trace)(hess[:, :-1, :-1])),
        rtol=5e-3, atol=2e-3,
    )


def test_pde_residual_small_on_trained_gp(trained):
    """The trained GP should nearly satisfy the PDE in the interior
    (reference anchor: residual mean -2.7e-3, std 1.6e-2 at d=20)."""
    eq, gp = trained
    x_test, _ = eq.generate_test_data(200, 1, key=jax.random.PRNGKey(5))
    eps = np.asarray(gp.compute_PDE_loss(x_test)).ravel()
    assert np.abs(eps).mean() < 5e-2, f"residual mean abs {np.abs(eps).mean()}"


def test_posterior_chunking_consistency(trained):
    _, gp = trained
    st = gp.state
    x = jax.random.uniform(jax.random.PRNGKey(6), (33, D + 1), minval=-0.4, maxval=0.4)
    full = posterior_eval(x, st.x_dom, st.x_bdy, st.right_vector, st.gamma, D,
                          want_grad=True, want_ops=True)
    chunked = posterior_eval(x, st.x_dom, st.x_bdy, st.right_vector, st.gamma, D,
                             want_grad=True, want_ops=True, chunk=8)
    for a, b in zip(full, chunked):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_state_save_load(tmp_path, trained):
    _, gp = trained
    path = str(tmp_path / "gp_state.npz")
    save_state(path, gp.state)
    restored = load_state(path)
    assert isinstance(restored, GPState)
    for a, b in zip(gp.state, restored):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
