"""Reaction-semigroup Allen-Cahn surrogate (gp/semigroup.py).

Checks, per backend (exact Bernstein mixture / scattered RBF):
- every posterior derivative feature (space-time gradient, dt, div, lap)
  against nested autodiff of the posterior mean itself;
- the closed-form residual identity eps == -u^3 (the linear PDE is solved
  exactly, so the strong-form Allen-Cahn residual is exactly the dropped
  cubic term);
- the terminal condition is reproduced at t = T;
- accuracy against the deep-MC oracle at small d, and that the ScaSML
  coupling runs and does not degrade the surrogate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scasml_gp.equations import AllenCahn
from scasml_gp.gp.semigroup import GPAllenCahnSemigroup
from scasml_gp.harness.metrics import mc_reference_solution
from scasml_gp.picard.scasml import ScaSMLFullHistory

D = 3


def _trained(backend, d=D, n_dom=120, n_bdy=40, seed=0):
    eq = AllenCahn(n_input=d + 1)
    gp = GPAllenCahnSemigroup(eq, terminal_backend=backend)
    x_dom, x_bdy = eq.generate_data(n_dom, n_bdy,
                                    key=jax.random.PRNGKey(seed))
    gp.GPsolver(x_dom, x_bdy)
    return eq, gp


def _test_points(eq, n=64, seed=5):
    x = eq.geometry().sample_domain(jax.random.PRNGKey(seed), n)
    return jnp.asarray(x, jnp.float32)


@pytest.mark.parametrize("backend", ["mixture", "rbf"])
def test_posterior_derivatives_match_autodiff(backend):
    eq, gp = _trained(backend)
    x = _test_points(eq, n=16)

    def u_scalar(pt):
        return gp.posterior_u(gp.state, pt[None, :]).u[0]

    out = gp.posterior_u(gp.state, x, want_grad=True, want_ops=True)
    g_ad = jax.vmap(jax.grad(u_scalar))(x)                    # (n, d+1)
    np.testing.assert_allclose(np.asarray(out.grad), np.asarray(g_ad),
                               rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(np.asarray(out.dt_u),
                               np.asarray(g_ad[:, -1]), rtol=2e-3,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(out.div_u),
                               np.asarray(jnp.sum(g_ad[:, :-1], axis=1)),
                               rtol=2e-3, atol=2e-5)
    hess = jax.vmap(jax.hessian(u_scalar))(x)                 # (n,d+1,d+1)
    lap_ad = jnp.trace(hess[:, : eq.dim, : eq.dim], axis1=1, axis2=2)
    np.testing.assert_allclose(np.asarray(out.lap_u), np.asarray(lap_ad),
                               rtol=5e-3, atol=5e-5)


@pytest.mark.parametrize("backend", ["mixture", "rbf"])
def test_residual_is_minus_u_cubed(backend):
    """The surrogate solves u_t + (sig^2/2) Lap u + u = 0 exactly, so the
    Allen-Cahn strong-form residual is exactly -u^3 (module docstring)."""
    eq, gp = _trained(backend)
    x = _test_points(eq, n=128)
    u = np.asarray(gp.predict(x)).ravel()
    eps = np.asarray(gp.compute_PDE_loss(x)).ravel()
    np.testing.assert_allclose(eps, -(u**3), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("backend", ["mixture", "rbf"])
def test_terminal_condition_reproduced(backend):
    eq, gp = _trained(backend)
    x = _test_points(eq, n=128)
    x_T = x.at[:, -1].set(eq.T)
    u_T = np.asarray(gp.predict(x_T)).ravel()
    g_T = np.asarray(eq.g(x_T)).ravel()
    tol = 1e-4 if backend == "mixture" else 2e-2
    assert np.max(np.abs(u_T - g_T)) < tol, np.max(np.abs(u_T - g_T))


def test_mixture_beats_oracle_noise_smalld():
    """The Bernstein-mixture surrogate's only error at small d is the
    neglected cubic — rel-L2 vs the deep-MC oracle must sit at the
    few-percent level (measured 0.0073 at d=20, 0.0023 at d=100 vs the
    collocation GP's 0.86/1.23)."""
    eq, gp = _trained("mixture", n_dom=64, n_bdy=16)
    x = _test_points(eq, n=256)
    ref = mc_reference_solution(eq, x, seed=11).ravel()
    u = np.asarray(gp.predict(x)).ravel()
    rel = np.linalg.norm(u - ref) / np.linalg.norm(ref)
    assert rel < 0.05, rel


def test_rbf_width_autoselection_runs():
    """width=None triggers the held-out beta-grid selection; the chosen
    width is recorded in the state and lies inside the grid's range."""
    eq, gp = _trained("rbf", n_dom=100, n_bdy=30)
    width = float(gp.state.gamma[0])
    unit = gp._width_unit
    assert 0.4 * unit < width < 1.1 * unit, (width, unit)


def test_bernstein_panel_nodes_identity():
    """The composite log-panel rule must reproduce (1+bq)^{-k} to near
    machine precision over the reachable q range, for both k = 1
    (Allen-Cahn / HJB at sigma = sqrt(2)) and a fractional k."""
    from scasml_gp.gp.semigroup import bernstein_panel_nodes

    q = np.concatenate([np.linspace(0.0, 30.0, 40), [50.0, 80.0]])
    # k >= 1 (every implemented equation: k = 2/sigma^2 = 1 at
    # sigma = sqrt(2)) is machine-precision; k < 1 has an integrable
    # t^{k-1} singularity the Legendre panels only resolve to ~1e-3 —
    # acceptable headroom for a backend no implemented equation selects
    for k, b, tol in ((1.0, 0.2, 1e-9), (1.0, 1.0, 1e-9),
                      (2.5, 0.7, 1e-9), (0.5, 1.0, 5e-3)):
        t, w = bernstein_panel_nodes(k)
        approx = np.sum(
            w[None, :] * np.exp(-b * t[None, :] * q[:, None]), axis=1
        )
        exact = (1.0 + b * q) ** (-k)
        rel = np.abs(approx - exact) / exact
        assert rel.max() < tol, (k, b, rel.max())


def test_hjb_mixture_backend_near_exact():
    """Round-5 Cole-Hopf mixture backend: v_T = e^{-k g} = a^k (1+b q)^{-k}
    is completely monotone in q, so the Bernstein/log-panel mixture makes
    the HJB surrogate exact up to quadrature error — measured within the
    MC oracle's own noise at d = 20/100/250 (0.00096/0.00023/0.00011 vs
    oracle self-diffs 0.00138/0.00030/0.00015)."""
    from scasml_gp.equations import HJB
    from scasml_gp.gp.cole_hopf import GPHJBColeHopf

    eq = HJB(n_input=D + 1)
    gp = GPHJBColeHopf(eq)  # auto -> mixture
    assert gp.terminal_backend == "mixture"
    x_dom, x_bdy = eq.generate_data(32, 8, key=jax.random.PRNGKey(0))
    gp.GPsolver(x_dom, x_bdy)
    x = _test_points(eq, n=256)
    exact = np.asarray(eq.exact_solution(x, num_mc=16384)).ravel()
    u = np.asarray(gp.predict(x)).ravel()
    rel = np.linalg.norm(u - exact) / np.linalg.norm(exact)
    assert rel < 0.02, rel
    # residual identically zero (exact v-flow + Cole-Hopf cancellation)
    eps = np.asarray(gp.compute_PDE_loss(x))
    assert np.abs(eps).max() == 0.0


def test_hjb_mixture_derivatives_match_autodiff():
    from scasml_gp.equations import HJB
    from scasml_gp.gp.cole_hopf import GPHJBColeHopf

    eq = HJB(n_input=D + 1)
    gp = GPHJBColeHopf(eq)
    x_dom, x_bdy = eq.generate_data(32, 8, key=jax.random.PRNGKey(0))
    gp.GPsolver(x_dom, x_bdy)
    x = _test_points(eq, n=16)

    def u_scalar(pt):
        return gp.posterior_u(gp.state, pt[None, :]).u[0]

    out = gp.posterior_u(gp.state, x, want_grad=True, want_ops=True)
    g_ad = jax.vmap(jax.grad(u_scalar))(x)
    np.testing.assert_allclose(np.asarray(out.grad), np.asarray(g_ad),
                               rtol=3e-3, atol=3e-5)
    hess = jax.vmap(jax.hessian(u_scalar))(x)
    lap_ad = jnp.trace(hess[:, : eq.dim, : eq.dim], axis1=1, axis2=2)
    np.testing.assert_allclose(np.asarray(out.lap_u), np.asarray(lap_ad),
                               rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.div_u),
                               np.asarray(jnp.sum(g_ad[:, :-1], axis=1)),
                               rtol=3e-3, atol=3e-5)


def test_scasml_coupling_runs_and_does_not_degrade():
    """ScaSML on the semigroup surrogate: leaf injection carries the exact
    -u^3 residual; the correction must not degrade the (already
    near-oracle) surrogate by more than the rollout's own MC noise."""
    eq, gp = _trained("mixture", n_dom=64, n_bdy=16)
    x = _test_points(eq, n=128)
    ref = mc_reference_solution(eq, x, seed=11).ravel()
    solver = ScaSMLFullHistory(eq, gp)
    u_sc = np.asarray(solver.u_solve(2, None, x, M=3)).ravel()
    u_gp = np.asarray(gp.predict(x)).ravel()
    rel_sc = np.linalg.norm(u_sc - ref) / np.linalg.norm(ref)
    rel_gp = np.linalg.norm(u_gp - ref) / np.linalg.norm(ref)
    assert np.isfinite(u_sc).all()
    assert rel_sc < max(2.0 * rel_gp, 0.08), (rel_sc, rel_gp)
