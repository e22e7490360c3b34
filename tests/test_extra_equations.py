"""Stretch PDE families end-to-end: Allen-Cahn through the full GP+ScaSML
pipeline (accuracy vs a deep Picard reference), HJB through both the plain
MLP solver and the Cole-Hopf GP + ScaSML pipeline, each checked against the
Cole-Hopf Monte-Carlo solution."""

import jax
import jax.numpy as jnp
import numpy as np

from scasml_gp.config import GPConfig
from scasml_gp.equations import AllenCahn, HJB
from scasml_gp.gp.cole_hopf import GPHJBColeHopf
from scasml_gp.gp.solver import GPAllenCahn
from scasml_gp.harness.metrics import mc_reference_solution
from scasml_gp.picard import MLPFullHistory, ScaSMLFullHistory

D = 4


def _rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_allen_cahn_gp_scasml_pipeline():
    eq = AllenCahn(n_input=D + 1)
    gp = GPAllenCahn(eq, GPConfig(gn_steps=10))
    x_dom, x_bdy = eq.generate_data(150, 40, key=jax.random.PRNGKey(0))
    gp.GPsolver(x_dom, x_bdy)

    x_test = eq.geometry().sample_domain(jax.random.PRNGKey(1), 128)
    ref = mc_reference_solution(eq, x_test, n=3, M=8)

    u_gp = np.asarray(gp.predict(x_test))
    assert np.isfinite(u_gp).all()
    rel_gp = _rel(u_gp, ref)

    sca = ScaSMLFullHistory(eq, gp)
    u_sca = np.asarray(sca.u_solve(2, None, x_test, M=4))
    assert np.isfinite(u_sca).all()
    rel_sca = _rel(u_sca, ref)
    # the GP surrogate must be in the right ballpark and ScaSML must not
    # degrade it catastrophically (Allen-Cahn has no closed form; the MC
    # reference itself carries a few percent error)
    assert rel_gp < 0.5, rel_gp
    assert rel_sca < max(2.0 * rel_gp, 0.2), (rel_sca, rel_gp)


def _trained_hjb_gp(gn_steps=6):
    # the rbf backend: these tests exercise the scattered-bump algebra and
    # the coarse-surrogate regime (the round-5 default is the exact
    # Bernstein mixture backend, tested separately below)
    eq = HJB(n_input=D + 1)
    gp = GPHJBColeHopf(eq, GPConfig(gn_steps=gn_steps),
                       terminal_backend="rbf")
    # terminal-fit centers: m = 600 -> rel-L2 ~0.027 at d=4 (the fit is one
    # m x m Cholesky; accuracy saturates by m ~ 600)
    x_dom, x_bdy = eq.generate_data(500, 100, key=jax.random.PRNGKey(3))
    gp.GPsolver(x_dom, x_bdy)
    return eq, gp


def test_hjb_gp_cole_hopf_accuracy():
    """The semigroup v-GP, mapped back through u = -ln(v)/k, must closely
    match the Cole-Hopf Monte-Carlo solution of HJB (no closed form exists).
    Measured ~0.02 rel-L2 with 250 terminal points at d=4."""
    eq, gp = _trained_hjb_gp()
    x_test = eq.geometry().sample_domain(jax.random.PRNGKey(4), 256)
    exact = np.asarray(eq.exact_solution(x_test, num_mc=16384))
    u_gp = np.asarray(gp.predict(x_test))
    assert np.isfinite(u_gp).all()
    assert _rel(u_gp, exact) < 0.08, _rel(u_gp, exact)


def test_hjb_gp_transform_consistency():
    """Closed-form grad / ops of the semigroup surrogate must equal autodiff
    of u(x,t) = -ln(v(x,t))/k where v is the semigroup-evolved interpolant,
    and the u-space HJB residual of the surrogate must vanish identically
    (the heat semigroup is exact on Gaussian bumps and the Cole-Hopf
    |grad u|^2 terms cancel at k = 2/sigma^2)."""
    eq, gp = _trained_hjb_gp(gn_steps=3)
    st = gp.state
    x_test = eq.geometry().sample_domain(jax.random.PRNGKey(5), 16)
    y, alpha = st.x_bdy[:, :-1], st.right_vector
    s, mbar = st.gamma[0], st.gamma[2]

    def v_scalar(xt_row):
        tau = jnp.maximum(eq.T - xt_row[D], 0.0)
        w = s * s + gp.sig2 * tau
        d2 = jnp.sum((xt_row[:D][None, :] - y) ** 2, axis=1)
        return mbar + (s * s / w) ** (D / 2.0) * jnp.sum(
            alpha * jnp.exp(-d2 / (2.0 * w))
        )

    def u_scalar(xt_row):
        return -jnp.log(jnp.maximum(v_scalar(xt_row), gp.v_floor)) / gp.k

    g_auto = np.asarray(jax.vmap(jax.grad(u_scalar))(x_test))
    g_closed = np.asarray(gp.compute_gradient(x_test))
    # f32: the closed form accumulates d2 via the |x|^2+|y|^2-2xy matmul,
    # autodiff via direct squared differences — tolerances cover the
    # different rounding, not a formula gap
    np.testing.assert_allclose(g_closed, g_auto, rtol=2e-3, atol=2e-4)

    # ops: dt/div/lap of u vs autodiff
    out = gp.posterior_u(st, x_test, want_ops=True)

    def ops_auto(xt_row):
        grad = jax.grad(u_scalar)(xt_row)
        hess = jax.hessian(u_scalar)(xt_row)
        return grad[D], jnp.sum(grad[:D]), jnp.trace(hess[:D, :D])

    dt_a, div_a, lap_a = jax.vmap(ops_auto)(x_test)
    np.testing.assert_allclose(np.asarray(out.dt_u), np.asarray(dt_a),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.div_u), np.asarray(div_a),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.lap_u), np.asarray(lap_a),
                               rtol=2e-3, atol=5e-4)

    # the u-space strong-form residual vanishes identically: check the
    # closed-form claim against autodiff of the surrogate itself
    eps_auto = np.asarray(dt_a) + np.asarray(lap_a) - np.sum(
        np.asarray(g_auto)[:, :D] ** 2, axis=1
    )
    np.testing.assert_allclose(eps_auto, 0.0, atol=5e-4)
    assert np.all(np.asarray(gp.compute_PDE_loss(x_test)) == 0.0)


def test_hjb_gp_scasml_pipeline():
    """Full BASELINE config-5 path: ScaSML's Picard correction must repair a
    coarse Cole-Hopf surrogate and beat the plain MLP at the same budget.

    The calibration regime matters: with a 600-center surrogate (rel-L2
    ~0.03) the MC correction is pure variance (the gradient-quadratic HJB
    generator turns z-noise into a bias, measured corr(u_breve, err_gp) ~= 0)
    — ScaSML is the wrong tool for an already-converged surrogate.  With a
    coarse 100-center surrogate (rel-L2 ~0.45) the correction is nearly all
    signal: measured corr(u_breve, err_gp) = +0.89 at M=8 (+0.99 at M=32),
    rel-L2 0.45 -> 0.16 (M=8) -> 0.047 (M=32)."""
    eq = HJB(n_input=D + 1)
    gp = GPHJBColeHopf(eq, GPConfig(gn_steps=6), terminal_backend="rbf")
    x_dom, x_bdy = eq.generate_data(80, 20, key=jax.random.PRNGKey(30))
    gp.GPsolver(x_dom, x_bdy)
    x_test = eq.geometry().sample_domain(jax.random.PRNGKey(6), 128)
    exact = np.asarray(eq.exact_solution(x_test, num_mc=16384))

    rel_gp = _rel(np.asarray(gp.predict(x_test)), exact)
    assert rel_gp > 0.25, rel_gp  # the surrogate must actually be coarse
    sca = ScaSMLFullHistory(eq, gp)
    u_sca = np.asarray(sca.u_solve(2, None, x_test, M=8))
    assert np.isfinite(u_sca).all()
    rel_sca = _rel(u_sca, exact)
    mlp = MLPFullHistory(eq)
    rel_mlp = _rel(np.asarray(mlp.u_solve(2, None, x_test, M=8)), exact)
    assert rel_sca < 0.6 * rel_gp, (rel_sca, rel_gp)
    assert rel_sca < rel_mlp, (rel_sca, rel_mlp)


def test_hjb_gp_scasml_quadrature():
    """Quadrature-variant ScaSML on HJB: the Gauss-Legendre rollout must
    compile with the semigroup surrogate's posterior traced inside it and
    stay finite/stable.

    It is NOT expected to repair the surrogate the way full-history does
    (0.45 -> 0.16 above): the quadrature z estimator divides by (c_k - t)
    at nodes arbitrarily close to t (reference solvers/MLP.py:245 semantics),
    and the gradient-QUADRATIC HJB generator turns that z variance into bias
    — the same mechanism as the uniform-time 1/sqrt(tau) divergence that
    `time_sampling='sqrt'` fixes for the full-history variant (equations/
    extra.py). Full-history is the supported ScaSML configuration for
    gradient-quadratic generators; measured here quadrature lands at ~1.05x
    the GP error (neutral), not catastrophic."""
    from scasml_gp.picard import ScaSML

    eq = HJB(n_input=D + 1)
    gp = GPHJBColeHopf(eq, GPConfig(gn_steps=6), terminal_backend="rbf")
    x_dom, x_bdy = eq.generate_data(80, 20, key=jax.random.PRNGKey(30))
    gp.GPsolver(x_dom, x_bdy)
    x_test = eq.geometry().sample_domain(jax.random.PRNGKey(6), 96)
    exact = np.asarray(eq.exact_solution(x_test, num_mc=16384))

    rel_gp = _rel(np.asarray(gp.predict(x_test)), exact)
    u_sca = np.asarray(ScaSML(eq, gp).u_solve(2, 2, x_test))
    assert np.isfinite(u_sca).all()
    rel_sca = _rel(u_sca, exact)
    assert rel_sca < 1.3 * rel_gp, (rel_sca, rel_gp)


def test_hjb_mlp_vs_cole_hopf():
    eq = HJB(n_input=D + 1)
    x = jax.random.uniform(jax.random.PRNGKey(2), (64, D), minval=-0.5,
                           maxval=0.5)
    # mid-horizon points, away from t = T where the estimate is exact anyway
    t = jnp.full((64, 1), 0.1)
    x_t = jnp.concatenate([x, t], axis=1)
    exact = np.asarray(eq.exact_solution(x_t, num_mc=8192)).ravel()
    # HJB's gradient-quadratic generator needs the non-reference estimator
    # options the equation enables by default: centered z, sqrt importance
    # time sampling, Stein-corrected terminal z, tight truncation.
    rels = {}
    for n, M in [(1, 8), (3, 16)]:
        solver = MLPFullHistory(eq)
        u = np.asarray(solver.u_solve(n, None, x_t, M=M)).ravel()
        rels[n] = np.linalg.norm(u - exact) / np.linalg.norm(exact)
    assert rels[3] < 0.2, rels
    assert rels[3] < rels[1], rels  # deeper recursion improves
