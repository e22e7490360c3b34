"""Multilevel Picard solver tests: schedules, estimator correctness on a
linear PDE (brute-force MC oracle), terminal-time determinism, and the
ScaSML < MLP/GP error ordering on a small end-to-end problem."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scasml_gp.config import GPConfig
from scasml_gp.equations import GradDependentNonlinear
from scasml_gp.equations.base import Equation
from scasml_gp.gp import GPGradDependentNonlinear
from scasml_gp.picard import (
    MLP,
    MLPFullHistory,
    ScaSML,
    ScaSMLFullHistory,
    approx_parameters,
    count_evaluations_full_history,
    count_evaluations_quadrature,
    leggauss,
)

D = 4


# ---------------------------------------------------------------- schedules
def test_leggauss_exact_for_polynomials():
    x, w = leggauss(3, 0.0, 0.5)
    # 3-point Gauss-Legendre integrates degree-5 polynomials exactly
    for p in range(6):
        np.testing.assert_allclose(
            float(np.sum(w * x**p)), 0.5 ** (p + 1) / (p + 1), rtol=1e-12
        )
    assert np.all(np.diff(x) > 0)  # ascending


def test_tables_rho2():
    t = approx_parameters(2, 0.5)
    # Mf[rho-1,k-1] = round(rho^(k/2)); Mg = round(rho^(k-1)); Mg[rho-1,rho]=rho^rho
    np.testing.assert_array_equal(t.Mf[1, :2], [1, 2])
    np.testing.assert_array_equal(t.Mg[1, :3], [1, 2, 4])
    assert np.all(t.Q[1, :2] >= 1)
    # nodes column k-1 holds k ascending Gauss points on [0, T]
    qmax = t.c.shape[0]
    for k in range(1, qmax + 1):
        assert np.all(t.c[:k, k - 1] >= 0) and np.all(t.c[:k, k - 1] <= 0.5)


def test_evaluation_counters_positive_and_monotone():
    c1 = count_evaluations_quadrature(1, 2, 0.5)
    c2 = count_evaluations_quadrature(2, 2, 0.5)
    assert 0 < c1 < c2
    f1 = count_evaluations_full_history(1, 3)
    f2 = count_evaluations_full_history(2, 3)
    assert 0 < f1 < f2
    # the ScaSML full-history variant counts MC_g in the loop -> larger
    assert count_evaluations_full_history(
        2, 3, scasml_variant=True
    ) >= count_evaluations_full_history(2, 3)


# ------------------------------------------------------- estimator correctness
class _LinearEq(Equation):
    """f == 0, g = sum(x): exact solution u(t,x) = sum(x) + mu*d*(T-t)
    (Feynman-Kac for the drifted heat equation with linear terminal data)."""

    def sigma(self, x_t=0):
        return 0.5

    def mu(self, x_t=0):
        return 0.2

    def f(self, x_t, u, z):
        return jnp.zeros_like(u)

    def terminal_constraint(self, x_t):
        return jnp.sum(x_t[:, :-1], axis=1, keepdims=True)

    def exact_solution(self, x_t):
        dT = self.T - x_t[:, -1]
        return (
            jnp.sum(x_t[:, :-1], axis=1) + self.mu() * self.dim * dT
        )[:, None]


def test_full_history_linear_pde_matches_mc_oracle():
    eq = _LinearEq(n_input=D + 1)
    eq.norm_estimation = 100.0
    solver = MLPFullHistory(eq)
    x_t = jax.random.uniform(jax.random.PRNGKey(0), (64, D + 1),
                             minval=-0.5, maxval=0.4)
    # n=1, M large: u = mean over M samples of g(X_T); linear g makes the
    # estimator exact in expectation with std = sigma*sqrt(d(T-t)/M).
    u = np.asarray(solver.u_solve(1, None, x_t, M=4096)).ravel()
    exact = np.asarray(eq.exact_solution(x_t)).ravel()
    dT = 0.5 - np.asarray(x_t[:, -1])
    tol = 5 * 0.5 * np.sqrt(D * dT / 4096) + 1e-3
    assert np.all(np.abs(u - exact) < tol), np.abs(u - exact).max()


class _ConstantForcingEq(_LinearEq):
    """f == c: the l=0 interior term must integrate EXACTLY to c*(T-t)
    (Gauss-Legendre weights for the quadrature variant, the uniform-time
    importance weight (T-t)*mean for the full-history variant)."""

    C = 0.37

    def f(self, x_t, u, z):
        return jnp.full_like(u, self.C)

    def exact_solution(self, x_t):
        dT = self.T - x_t[:, -1]
        base = jnp.sum(x_t[:, :-1], axis=1) + self.mu() * self.dim * dT
        return (base + self.C * dT)[:, None]


def test_quadrature_weights_integrate_constant_forcing():
    eq = _ConstantForcingEq(n_input=D + 1)
    eq.norm_estimation = 100.0
    x_t = jax.random.uniform(jax.random.PRNGKey(5), (48, D + 1),
                             minval=-0.5, maxval=0.4)
    exact = np.asarray(eq.exact_solution(x_t)).ravel()
    dT = 0.5 - np.asarray(x_t[:, -1])
    for solver, args, mc in [
        (MLP(eq), (1, 2, x_t), None),           # MC_g = Mg[1,1] = 2
        (MLPFullHistory(eq), (1, None, x_t, 4096), 4096),
    ]:
        u = np.asarray(solver.u_solve(*args)).ravel()
        m = mc if mc else 2
        tol = 5 * 0.5 * np.sqrt(D * dT / m) + 1e-3   # terminal-MC noise only
        assert np.all(np.abs(u - exact) < tol), np.abs(u - exact).max()


def test_terminal_time_is_deterministic():
    """At t = T every level reduces to u = g(x), z = 0 (zero-width interval)."""
    eq = GradDependentNonlinear(n_input=D + 1)
    x = jax.random.uniform(jax.random.PRNGKey(1), (16, D), minval=-0.5, maxval=0.5)
    x_t = jnp.concatenate([x, jnp.full((16, 1), eq.T)], axis=1)
    g = np.asarray(eq.g(x_t)).ravel()
    for solver, args in [
        (MLP(eq), (2, 2, x_t)),
        (MLPFullHistory(eq), (2, None, x_t, 3)),
    ]:
        uz = np.asarray(solver.uz_solve(*args))
        np.testing.assert_allclose(uz[:, 0], g, rtol=1e-4, atol=1e-4)


def test_batch_chunking_changes_only_rng():
    eq = GradDependentNonlinear(n_input=D + 1)
    x_t = jax.random.uniform(jax.random.PRNGKey(2), (40, D + 1),
                             minval=-0.4, maxval=0.4)
    a = MLPFullHistory(eq)
    b = MLPFullHistory(eq, batch_chunk=16)
    ua = np.asarray(a.u_solve(2, None, x_t, M=3)).ravel()
    ub = np.asarray(b.u_solve(2, None, x_t, M=3)).ravel()
    # different key streams -> not equal, but both near the exact solution
    exact = np.asarray(eq.exact_solution(x_t)).ravel()
    assert np.linalg.norm(ua - exact) / np.linalg.norm(exact) < 0.5
    assert np.linalg.norm(ub - exact) / np.linalg.norm(exact) < 0.5


def test_counter_increments():
    eq = GradDependentNonlinear(n_input=D + 1)
    solver = MLPFullHistory(eq)
    x_t = jnp.zeros((8, D + 1))
    solver.u_solve(1, None, x_t, M=2)
    assert solver.evaluation_counter == count_evaluations_full_history(1, 2)


# ------------------------------------------------------------ ScaSML ordering
@pytest.fixture(scope="module")
def trained_gp():
    eq = GradDependentNonlinear(n_input=D + 1)
    gp = GPGradDependentNonlinear(eq, GPConfig(gn_steps=12))
    x_dom, x_bdy = eq.generate_data(200, 60, key=jax.random.PRNGKey(0))
    gp.GPsolver(x_dom, x_bdy)
    return eq, gp


def _rel_l2(pred, exact):
    pred = np.asarray(pred).ravel()
    exact = np.asarray(exact).ravel()
    return np.linalg.norm(pred - exact) / np.linalg.norm(exact)


def test_scasml_improves_on_gp_and_mlp(trained_gp):
    """The headline property (BASELINE.md): ScaSML error < GP and < MLP."""
    eq, gp = trained_gp
    x_test, _ = eq.generate_test_data(300, 1, key=jax.random.PRNGKey(3))
    exact = eq.exact_solution(x_test)

    e_gp = _rel_l2(gp.predict(x_test), exact)
    mlp = MLPFullHistory(eq)
    e_mlp = _rel_l2(mlp.u_solve(2, None, x_test, M=3), exact)
    sca = ScaSMLFullHistory(eq, gp)
    e_sca = _rel_l2(sca.u_solve(2, None, x_test, M=3), exact)

    assert e_sca < e_gp, (e_sca, e_gp, e_mlp)
    assert e_sca < e_mlp, (e_sca, e_gp, e_mlp)


def test_scasml_quadrature_runs_and_improves(trained_gp):
    eq, gp = trained_gp
    x_test, _ = eq.generate_test_data(200, 1, key=jax.random.PRNGKey(4))
    exact = eq.exact_solution(x_test)
    e_gp = _rel_l2(gp.predict(x_test), exact)
    sca = ScaSML(eq, gp)
    e_sca = _rel_l2(sca.u_solve(2, 2, x_test), exact)
    assert e_sca < e_gp, (e_sca, e_gp)


def test_skip_zero_fbreve_is_bitwise_exact(trained_gp):
    """f_zero_at_zero=True (the ScaSML default) skips the level-0 f_breve
    posterior sweeps; since those contributions are bitwise zero (val1 ==
    val2 on identical inputs, and x + 0 == x), the estimator must be
    BITWISE identical with the flag off."""
    from scasml_gp.picard.core import (
        build_full_history_uz,
        build_quadrature_uz,
    )
    from scasml_gp.picard.schedule import approx_parameters as ap

    eq, gp = trained_gp
    sca = ScaSMLFullHistory(eq, gp)
    model = sca._model()
    assert model.f_zero_at_zero
    x_t = eq.geometry().sample_domain(jax.random.PRNGKey(5), 16)
    key = jax.random.PRNGKey(9)
    params = sca._params()

    fast = build_full_history_uz(model, 2, 3)(x_t, key, params)
    slow = build_full_history_uz(
        model._replace(f_zero_at_zero=False), 2, 3
    )(x_t, key, params)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(slow))

    tables = ap(2, eq.T)
    fast_q = build_quadrature_uz(model, 2, 2, tables)(x_t, key, params)
    slow_q = build_quadrature_uz(
        model._replace(f_zero_at_zero=False), 2, 2, tables
    )(x_t, key, params)
    np.testing.assert_array_equal(np.asarray(fast_q), np.asarray(slow_q))


# ------------------------------------------------------- debug mode (checkify)
def test_debug_checks_clean_run_matches_unchecked():
    """debug_checks=True is semantics-preserving on finite inputs."""
    eq = GradDependentNonlinear(n_input=D + 1)
    x_t = eq.geometry().sample_domain(jax.random.PRNGKey(0), 32)
    ref = MLPFullHistory(eq)
    dbg = MLPFullHistory(eq, debug_checks=True)
    ref.key = dbg.key = jax.random.PRNGKey(7)
    u_ref = np.asarray(ref.u_solve(2, None, x_t, M=2))
    u_dbg = np.asarray(dbg.u_solve(2, None, x_t, M=2))
    np.testing.assert_allclose(u_dbg, u_ref, rtol=1e-6, atol=1e-7)


def test_debug_checks_localizes_nonfinite():
    """A NaN in the input raises a checkify error with an op location,
    instead of silently propagating into the output (SURVEY §5 sanitizers)."""
    from jax.experimental import checkify

    eq = GradDependentNonlinear(n_input=D + 1)
    x_t = np.array(eq.geometry().sample_domain(jax.random.PRNGKey(0), 8))
    x_t[0, 0] = np.nan
    dbg = MLPFullHistory(eq, debug_checks=True)
    with pytest.raises(checkify.JaxRuntimeError, match="nan"):
        dbg.u_solve(2, None, jnp.asarray(x_t), M=2)
    # the unchecked solver silently propagates (this is what the harness
    # NaN mask used to be the only guard for)
    plain = MLPFullHistory(eq)
    out = np.asarray(plain.u_solve(2, None, jnp.asarray(x_t), M=2))
    assert np.isnan(out[0]).any() or np.isfinite(out).all()


# ------------------------------------------------- variance guard (James-Stein)
def test_variance_column_matches_empirical_variance(trained_gp):
    """The rollout's variance column is an honest estimate: across fresh
    keys, the empirical variance of u_breve should match the in-rollout
    estimate within a loose statistical factor."""
    eq, gp = trained_gp
    sca = ScaSMLFullHistory(eq, gp, variance_guard=True)
    x_t = eq.geometry().sample_domain(jax.random.PRNGKey(11), 24)
    fn = sca._get_fn((2, 2))
    params = sca._params()
    outs = np.stack([
        np.asarray(fn(x_t, jax.random.PRNGKey(100 + i), params))
        for i in range(40)
    ])
    u_breves = outs[:, :, 0]
    var_est = outs[:, :, -1].mean(axis=0)       # mean estimated variance
    var_emp = u_breves.var(axis=0, ddof=1)      # empirical across keys
    # aggregate ratio within 2x (per-point is noisy at 40 reps)
    ratio = var_est.sum() / max(var_emp.sum(), 1e-30)
    assert 0.5 < ratio < 2.0, ratio


def test_variance_guard_keeps_informative_corrections(trained_gp):
    """On the reference PDE the correction is real: lambda ~ 1 and the
    guarded solve still beats the GP (VERDICT #5: 'reference-PDE results
    unchanged')."""
    eq, gp = trained_gp
    x_test, _ = eq.generate_test_data(200, 1, key=jax.random.PRNGKey(3))
    exact = eq.exact_solution(x_test)
    e_gp = _rel_l2(gp.predict(x_test), exact)

    guarded = ScaSMLFullHistory(eq, gp, variance_guard=True)
    plain = ScaSMLFullHistory(eq, gp, variance_guard=False)
    guarded.key = plain.key = jax.random.PRNGKey(5)
    e_guard = _rel_l2(guarded.u_solve(2, None, x_test, M=3), exact)
    e_plain = _rel_l2(plain.u_solve(2, None, x_test, M=3), exact)
    assert guarded.last_lambda is not None and guarded.last_lambda > 0.8, (
        guarded.last_lambda
    )
    assert e_guard < e_gp
    assert abs(e_guard - e_plain) < 0.2 * e_plain + 1e-4


def test_variance_guard_abstains_on_pure_noise(trained_gp):
    """When the correction is statistically indistinguishable from its own
    MC noise, lambda -> 0 and the guarded solve returns ~u_hat."""
    import jax.numpy as jnp

    eq, gp = trained_gp
    sca = ScaSMLFullHistory(eq, gp, variance_guard=True)
    x_t = eq.geometry().sample_domain(jax.random.PRNGKey(13), 16)
    u_hat = np.asarray(sca._u_hat(x_t))
    # synthetic rollout output: small zero-mean correction, huge variance
    B = x_t.shape[0]
    fake = jnp.concatenate(
        [
            1e-3 * jax.random.normal(jax.random.PRNGKey(0), (B, 1)),
            jnp.zeros((B, eq.dim)),
            jnp.full((B, 1), 10.0),  # variance >> correction^2
        ],
        axis=1,
    )
    out = np.asarray(sca._guarded_u(fake, x_t))
    assert sca.last_lambda == 0.0
    np.testing.assert_allclose(out, u_hat, rtol=0, atol=1e-7)


def test_hjb_enables_variance_guard_by_default():
    from scasml_gp.equations.extra import HJB

    eq = HJB(n_input=5)
    assert getattr(eq, "variance_guard") is True
