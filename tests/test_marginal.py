"""Marginal-likelihood hyperparameter fitting (gp/marginal.py).

Verifies the north-star requirement (BASELINE.json: batched VI/marginal-
likelihood optimization on-device): NLML decreases over optimization, the
gradient path through the equilibrated Cholesky matches finite differences,
and the fitted config trains a GP at least as accurate as the unfitted
reference kernel on a small problem.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scasml_gp.config import GPConfig
from scasml_gp.equations import GradDependentNonlinear
from scasml_gp.gp import GPGradDependentNonlinear
from scasml_gp.gp.gram import gram_matrix, logdet_quad
from scasml_gp.gp.marginal import (
    _gamma_of,
    _params_to_theta,
    _theta_to_params,
    fit_gp_marginal_likelihood,
)

D = 4
N_DOM, N_BDY = 40, 12


@pytest.fixture(scope="module")
def data():
    eq = GradDependentNonlinear(n_input=D + 1)
    x_dom, x_bdy = eq.generate_data(N_DOM, N_BDY, key=jax.random.PRNGKey(3))
    return eq, x_dom, x_bdy


def test_theta_roundtrip():
    theta = _params_to_theta(1.3, 0.7, 5.0, 3e-2)
    c, ts, rr, ng = (float(v) for v in _theta_to_params(jnp.asarray(theta)))
    assert np.isclose(c, 1.3, rtol=1e-5)
    assert np.isclose(ts, 0.7, rtol=1e-5)
    assert np.isclose(rr, 5.0, rtol=1e-4)
    assert np.isclose(ng, 3e-2, rtol=1e-5)
    # ridge_scale = 0 maps to (numerically) zero after softplus
    theta0 = _params_to_theta(1.0, 1.0, 0.0, 1e-2)
    assert float(_theta_to_params(jnp.asarray(theta0))[2]) < 1e-5


def test_logdet_quad_matches_dense(data):
    eq, x_dom, x_bdy = data
    gamma = _gamma_of(jnp.asarray(_params_to_theta(1.0, 1.0, 2.0, 1e-2)),
                      eq.sigma(), D)
    K = gram_matrix(x_dom, x_bdy, gamma, D)
    b = jax.random.normal(jax.random.PRNGKey(0), (K.shape[0],))
    logdet, quad = logdet_quad(K, jnp.float32(1e-2), b)
    Kp = np.asarray(K, np.float64)
    Kp = 0.5 * (Kp + Kp.T) + 1e-2 * np.eye(Kp.shape[0])
    sign, ld_ref = np.linalg.slogdet(Kp)
    assert sign > 0
    quad_ref = np.asarray(b, np.float64) @ np.linalg.solve(Kp, np.asarray(b, np.float64))
    assert np.isclose(float(logdet), ld_ref, rtol=2e-3)
    assert np.isclose(float(quad), quad_ref, rtol=2e-3)


def test_nlml_gradient_matches_finite_difference(data):
    eq, x_dom, x_bdy = data
    b = jax.random.normal(jax.random.PRNGKey(1), (4 * N_DOM + N_BDY,))

    def nlml(theta):
        gamma = _gamma_of(theta, eq.sigma(), D)
        ng = _theta_to_params(theta)[3]
        K = gram_matrix(x_dom, x_bdy, gamma, D)
        logdet, quad = logdet_quad(K, ng, b)
        return 0.5 * (logdet + quad)

    theta = jnp.asarray(_params_to_theta(1.0, 1.0, 1.0, 2e-2))
    g = jax.grad(nlml)(theta)
    assert np.all(np.isfinite(np.asarray(g)))
    for i in range(4):
        e = jnp.zeros(4).at[i].set(1e-3)
        fd = (float(nlml(theta + e)) - float(nlml(theta - e))) / 2e-3
        assert np.isclose(float(g[i]), fd, rtol=5e-2, atol=5e-2), (i, g[i], fd)


def test_fit_improves_nlml_and_error(data):
    eq, x_dom, x_bdy = data
    base = GPConfig(gn_steps=8)
    result = fit_gp_marginal_likelihood(
        GPGradDependentNonlinear, eq, x_dom, x_bdy, base=base,
        init_ridge_scales=(0.0, 5.0), outer_rounds=2, inner_steps=12,
        gn_steps=8,
    )
    # NLML per restart stays finite across outer rounds
    assert result.history.shape == (2, 2)
    assert np.all(np.isfinite(result.history))
    # table = base + one row per restart, each with a finite validation score
    assert len(result.table) == 3
    assert all(np.isfinite(row[2]) for row in result.table)
    # the shipped config is the validation argmin over {base, candidates}
    assert result.table and min(r[2] for r in result.table) == min(
        r[2] for r in result.table if r[0] == result.config
    )

    cfg = result.config
    assert cfg.nugget > 0 and cfg.time_scale > 0 and cfg.gamma_scale > 0

    # fitted GP is not worse than the reference-kernel GP on held-out points
    xt_dom, xt_bdy = eq.generate_test_data(200, 40, key=jax.random.PRNGKey(9))
    x_test = jnp.concatenate([xt_dom, xt_bdy])
    exact = np.asarray(eq.exact_solution(x_test)).ravel()

    def rel_l2(config):
        gp = GPGradDependentNonlinear(eq, config)
        gp.GPsolver(x_dom, x_bdy)
        u = np.asarray(gp.predict(x_test)).ravel()
        return np.linalg.norm(u - exact) / np.linalg.norm(exact)

    err_ref = rel_l2(base)
    err_fit = rel_l2(dataclasses.replace(cfg, gn_steps=8))
    assert err_fit < err_ref * 1.25, (err_fit, err_ref)


def test_fit_with_seed_configs_never_worse_than_seed(data):
    """Seeding from a grid winner (VERDICT r1 #8): the seed config competes
    untouched in the validation table, so the returned config's validation
    score is <= the seed's."""
    eq, x_dom, x_bdy = data
    base = GPConfig(gn_steps=8)
    seed_cfg = dataclasses.replace(base, ridge_scale=10.0)
    result = fit_gp_marginal_likelihood(
        GPGradDependentNonlinear, eq, x_dom, x_bdy, base=base,
        init_ridge_scales=(0.0,), outer_rounds=1, inner_steps=6,
        gn_steps=8, seed_configs=(seed_cfg,),
    )
    # table = base + seed + (1 grid restart + 1 seeded restart)
    assert len(result.table) == 4
    assert result.table[1][0] == seed_cfg
    seed_score = result.table[1][2]
    shipped = [r[2] for r in result.table if r[0] == result.config][0]
    assert np.isfinite(seed_score)
    assert shipped <= seed_score
