"""ScaSML: GP-calibrated multilevel Picard solvers.

The Picard recursion runs on the RESIDUAL u_breve = u - u_hat of the trained
GP surrogate (reference ``solvers/ScaSML.py`` / ``ScaSML_full_history.py``):

    f_breve(x, ub, zb) = f(x, ub + u_hat, sigma grad u_hat + zb)
                       - f(x, u_hat, sigma grad u_hat)        (ScaSML.py:29-47)
    g_breve(x)         = g(x) - u_hat(x)                      (ScaSML.py:49-63)
    leaf level l == 0  : inject eps = PDE residual of u_hat   (ScaSML.py:274-280)
    u_solve            = u_hat + u_breve                      (ScaSML.py:286-304)

Design: the GP posterior mean + gradient (and the residual at leaves) are
evaluated by the FUSED single-pass kernel of :mod:`scasml_gp.gp.posterior`
on the whole (batch x MC) node block at once, inside the same compiled rollout
— the reference instead re-enters three separate autodiff evaluators per tree
node, which is why its ScaSML is 8x slower than plain MLP (SURVEY.md §3.4).
The trained surrogate is threaded through as a GPState pytree argument, so a
retrained GP does not retrigger compilation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from scasml_gp.gp.solver import GP
from scasml_gp.picard.core import (
    PicardModel,
    build_full_history_uz,
    build_quadrature_uz,
)
from scasml_gp.picard.mlp import _PicardBase
from scasml_gp.picard.schedule import (
    approx_parameters,
    count_evaluations_full_history,
    count_evaluations_quadrature,
)


class _ScaSMLBase(_PicardBase):
    def __init__(self, equation, gp: GP, batch_chunk=None, center_z=None,
                 time_sampling=None, precision=None, mesh=None,
                 debug_checks=False, variance_guard=None,
                 terminal_crn=False, adaptive_clip=None):
        super().__init__(equation, batch_chunk=batch_chunk,
                         center_z=center_z, time_sampling=time_sampling,
                         precision=precision, mesh=mesh,
                         debug_checks=debug_checks, terminal_crn=terminal_crn)
        self.GP = gp
        self.eval_chunk = gp.eval_chunk
        # Opt-in adaptive correction clip (VERDICT round-3 Next #4): clamp
        # the final u_breve per point to +- adaptive_clip * predict_std(x)
        # — the GP's own posterior uncertainty — instead of relying only on
        # the reference's FIXED +-equation.uncertainty rollout clip
        # (solvers/ScaSML.py:282-284).  None keeps reference semantics.
        # Requires a standard collocation GP (predict_std; the Cole-Hopf
        # surrogate's state does not carry a collocation kernel).
        self.adaptive_clip = adaptive_clip
        # Variance-guarded correction (VERDICT round-2 #5): estimate the MC
        # variance of u_breve inside the rollout (one extra output column)
        # and SHRINK the correction toward zero when it is statistically
        # indistinguishable from its own noise — positive-part James-Stein
        # over the batch, lambda = max(0, 1 - sum var_i / sum u_breve_i^2).
        # With a converged surrogate the true correction is ~0 and the
        # estimate is pure MC noise (worse, a gradient-quadratic f turns
        # that noise into bias — the d=250 HJB 0.161 -> 0.204 regression);
        # the guard abstains there and leaves genuinely informative
        # corrections (lambda ~ 1) untouched.  Default comes from the
        # equation (HJB sets variance_guard=True); explicit bool overrides.
        self.variance_guard = (
            getattr(equation, "variance_guard", False)
            if variance_guard is None else variance_guard
        )
        self.last_lambda = None  # shrink factor of the latest u_solve

    def _params(self):
        if self.GP.state is None:
            raise RuntimeError("GP surrogate not trained; call GP.GPsolver first.")
        return self.GP.state

    def _model(self) -> PicardModel:
        eq = self.equation
        dim = self.dim
        gp = self.GP  # posterior_u/residual_u are pure in (params, x_t)

        def f_breve(params, x_t, u_breve, z_breve):
            out = gp.posterior_u(params, x_t, want_grad=True)
            u_hat = out.u[:, None]
            grad_sp = out.grad[:, :-1]  # spatial part (reference ScaSML.py:44)
            sig = eq.sigma(x_t)
            val1 = eq.f(x_t, u_breve + u_hat, sig * grad_sp + z_breve)
            val2 = eq.f(x_t, u_hat, sig * grad_sp)
            return val1 - val2

        def g_breve(params, x_t):
            return eq.g(x_t) - gp.posterior_u(params, x_t).u[:, None]

        def leaf(params, x_t):
            return gp.residual_u(params, x_t)

        return PicardModel(
            f=f_breve,
            g=g_breve,
            leaf=leaf,
            mu=float(eq.mu()),
            sigma=float(eq.sigma()),
            T=self.T,
            dim=dim,
            clip=float(eq.uncertainty),  # reference ScaSML.py:282-284
            center_z=self.center_z,
            time_sampling=self.time_sampling,
            terminal_z=self.terminal_z,
            path_dtype=self.precision.rollout,
            terminal_crn=self.terminal_crn,
            # f_breve(x, 0, 0) is bitwise zero (val1 == val2), so the
            # builders skip the level-0 f sweep — a full posterior+gradient
            # evaluation at the largest mf of every level — exactly.
            f_zero_at_zero=True,
        )

    def _u_hat(self, x_t) -> jax.Array:
        return self.GP.predict(x_t)

    def _guarded_u(self, out, x_t, u_breve_half=None, num_valid=None,
                   probe_var_ratio=0.25) -> jax.Array:
        """u_hat + lambda * u_breve with the James-Stein shrink computed
        from the rollout's variance column (no-op when the guard is off).

        ``num_valid`` restricts the lambda statistics to the first rows (the
        serving path pads requests to bucket sizes; duplicated pad rows must
        not weight the batch-global shrink — ADVICE round-3 #1).  lambda is
        a batch statistic, so a chunked/bucketed solve computes it per chunk
        over the REAL rows; callers needing one global lambda must solve the
        whole batch in one call.

        ``probe_var_ratio`` is Var(u_breve at full samples)/Var(u_breve at
        probe samples) for the paired half-sample probe — 2^-n for the
        full-history variant (terminal MC count M^n; M -> M//2 scales the
        variance by (M//(M//2))^n = 2^n for even M), and computed from the
        schedule's terminal Mg table by the quadrature variant.

        The variance column sees only MC *variance*; a gradient-quadratic f
        additionally turns z-estimator noise into a systematic BIAS
        (E f(z + eps) != f(z)) that is invisible to any variance estimate.
        That bias scales like an inverse power of the sample base M, so a
        second rollout at M/2 exposes it: the systematic disagreement
        delta = u_breve(M/2) - u_breve(M) is a (conservative, since
        bias(M/2) - bias(M) >= bias(M) for 1/M^p scaling with p >= 1)
        per-point bias proxy, and it joins the variance in the shrink
        denominator. Signal-dominated corrections (repair regime) have
        |u_breve| >> |delta| and keep lambda ~ 1."""
        u_breve = out[:, :1]
        bound = None
        if self.adaptive_clip is not None:
            bound = float(self.adaptive_clip) * self.GP.predict_std(x_t)
            u_breve = jnp.clip(u_breve, -bound, bound)
        if not self.variance_guard:
            return self._u_hat(x_t) + u_breve
        nv = u_breve.shape[0] if num_valid is None else int(num_valid)
        ub_v = u_breve[:nv]
        if u_breve_half is not None:
            # Paired half-sample probes (two INDEPENDENT reduced-sample
            # rollouts):
            #   a - b      has the bias cancelled -> unbiased estimate of
            #              2 Var_half (the rollout's own variance column
            #              sees only the terminal pass and underestimates);
            #   (a+b)/2 vs u_breve isolates the bias difference
            #              beta_half - beta_full, which bounds ||beta_full||
            #              from above for any bias decaying in the sample
            #              count (p >= 1 power law).
            # A gradient-quadratic f turns z-estimator noise into exactly
            # such a bias (the d=250 HJB regression); no variance column
            # can see it, the probe pair can.
            a, b = u_breve_half
            if bound is not None:
                # same predict_std clip as the main estimate: comparing a
                # clipped u_breve against unclipped probes would let
                # clipping-induced differences masquerade as bias and
                # over-shrink lambda (ADVICE round-4 #2)
                a = jnp.clip(a, -bound, bound)
                b = jnp.clip(b, -bound, bound)
            a, b = a[:nv], b[:nv]
            var_half = 0.5 * jnp.sum((a - b) ** 2)
            var_m = probe_var_ratio * var_half
            delta = 0.5 * (a + b) - ub_v
            bias_sq = jnp.maximum(
                jnp.sum(delta * delta) - 0.5 * var_half - var_m, 0.0
            )
            num = var_m + bias_sq
        else:
            bias_sq = None
            num = jnp.sum(out[:nv, -1:])
        den = jnp.sum(ub_v * ub_v)
        lam = jnp.clip(1.0 - num / jnp.maximum(den, 1e-30), 0.0, 1.0)
        if bias_sq is not None:
            # Bias-dominance abstention (VERDICT round-4 Next #2): the
            # James-Stein shrink only scales the correction, so lam * bias
            # survives as a SYSTEMATIC offset — and when the bias is
            # correlated with the true correction (the gradient-quadratic
            # HJB case: z-noise biases u_breve in one direction everywhere),
            # a scaled correction is worse than none.  When the probe's
            # bias power exceeds the inferred signal power
            # S = den - var - bias^2, abstain outright instead of shipping
            # a half-damaged answer (the round-4 HJB x quadrature failure:
            # shrunk SCaSML 0.312 vs GP 0.122 at d=100).
            signal_sq = jnp.maximum(den - num, 0.0)
            lam = jnp.where(bias_sq > signal_sq, 0.0, lam)
        self.last_lambda = float(lam)
        return self._u_hat(x_t) + lam * u_breve

    def _auto_schedule_solve(self, solve_at, candidates, x_t):
        """Probe-driven schedule selection for gradient-quadratic equations
        (``equation.escalate_M``; VERDICT round-4 Next #2/#3).

        ``candidates`` is SHALLOW-FIRST: for a gradient-quadratic generator,
        recursion level l estimates z from a number of paths that shrinks
        with depth (full-history: M^(n-l); quadrature: the Mf table, whose
        deepest entries are 1-2), and f turns that z-variance into a bias
        no sample count removes — measured at d = 100, n = 2 the correction
        is ANTI-correlated with the truth (rel-L2 0.25-0.45 applied full,
        vs GP 0.12) while every depth-1 schedule is in the repair regime
        (0.03-0.06).  Worse, the deepest table entries are unmodulated by
        the half-sample probe (max(1//2, 1) == 1), so the deep candidate's
        own bias estimate is a lower bound that can read spuriously
        signal-dominated (measured lambda = 0.6 on a candidate that
        doubles the error).  Hence: prefer the shallowest candidate whose
        guard accepts (lambda >= accept threshold, short-circuit); only
        when every shallow candidate is noise-dominated fall through to
        deeper ones.  When EVERY candidate is below threshold, ABSTAIN
        outright (return u_hat) instead of applying the best
        sub-threshold shrink — for a depth-poisoned generator a
        lambda ~ 0.5 application is statistically neutral at best
        (measured at d = 20: anywhere from -35% to +1% vs the surrogate
        depending on the draw), and the equation opted into this guard
        precisely because its bias correlates with the signal.  Every
        candidate rollout is charged to ``evaluation_counter``, so budget
        harnesses see the true cost."""
        lam_accept = float(getattr(self.equation, "escalate_M_accept", 0.5))
        best, best_lam = None, -1.0
        for cand in candidates:
            u = solve_at(cand)
            lam = 0.0 if self.last_lambda is None else self.last_lambda
            if lam > best_lam:
                best, best_lam = u, lam
            if best_lam >= lam_accept:
                self.last_lambda = best_lam
                return best
        self.last_lambda = 0.0
        return self._u_hat(x_t)

    def _measured_probe_ratio(self, out, a_out, b_out, fallback,
                              num_valid=None):
        """Var(full)/Var(probe) measured from the rollouts' OWN variance
        columns (the guard builds want_variance rollouts, so every output
        carries one).  Replaces a hardcoded scaling-exponent assumption with
        a per-call measurement (ADVICE round-3 #4); falls back to the
        analytic terminal-MC ratio when the columns are degenerate."""
        nv = out.shape[0] if num_valid is None else int(num_valid)
        v_full = float(jnp.sum(out[:nv, -1]))
        v_half = 0.5 * float(
            jnp.sum(a_out[:nv, -1]) + jnp.sum(b_out[:nv, -1])
        )
        if not (v_half > 0.0 and v_full > 0.0):
            return fallback
        # probes use fewer samples, so the true ratio lives in (0, 1)
        return float(min(max(v_full / v_half, 1e-3), 1.0))


class ScaSML(_ScaSMLBase):
    """Quadrature ScaSML (reference ``solvers/ScaSML.py``)."""

    def _build(self, schedule_key):
        n, rho, *probe = schedule_key
        tables = approx_parameters(rho, self.T)
        if probe:
            # bias-probe variant: same (n, rho) tree, HALVED MC counts —
            # the quadrature analog of the full-history M//2 probe
            tables = tables._replace(
                Mf=np.maximum(tables.Mf // 2, 1),
                Mg=np.maximum(tables.Mg // 2, 1),
            )
        return build_quadrature_uz(
            self._model(), n, rho, tables,
            want_variance=self.variance_guard,
        )

    def uz_solve(self, n: int, rho: int, x_t) -> jax.Array:
        out = self._run((int(n), int(rho)), x_t)
        self.evaluation_counter += count_evaluations_quadrature(
            int(n), int(rho), self.T, count_fg=True
        )
        return out

    def u_solve(self, n: int, rho: int, x_t, num_valid=None) -> jax.Array:
        """u_hat + [lambda] u_breve (reference solvers/ScaSML.py:286-304;
        lambda is the optional variance-guard shrink).

        A guarded solve adds the paired half-sample bias probe (two
        independent rollouts of the same (n, rho) tree with HALVED MC
        tables) that the full-history variant carries (VERDICT round-3
        Next #4): the variance column alone is blind to the systematic bias
        a gradient-quadratic generator turns z-noise into.  ``num_valid``
        masks trailing pad rows out of the shrink statistics (serving
        path).

        For equations flagged ``escalate_M`` (HJB), the schedule itself is
        auto-selected from a shallow-first candidate ladder — see
        ``_auto_schedule_solve`` for the measured rationale."""
        if getattr(self.equation, "escalate_M", False) and (
            self.variance_guard
        ):
            ladder = [(1, int(rho)), (1, int(rho) + 1)]
            if int(n) > 1:
                ladder.append((int(n), int(rho)))
            return self._auto_schedule_solve(
                lambda c: self._u_solve_at(c[0], c[1], x_t, num_valid),
                ladder, x_t,
            )
        return self._u_solve_at(n, rho, x_t, num_valid)

    def _u_solve_at(self, n: int, rho: int, x_t, num_valid=None) -> jax.Array:
        out = self.uz_solve(n, rho, x_t)
        u_half = None
        ratio = 0.25
        if self.variance_guard and rho >= 2:
            probes = []
            for _ in range(2):
                probes.append(self._run((int(n), int(rho), "probe"), x_t))
                # probe trees run every MC axis at half width; the exact
                # count is within a factor ~2^depth of this, close enough
                # for the cost-scaling plots the counter feeds
                self.evaluation_counter += count_evaluations_quadrature(
                    int(n), int(rho), self.T, count_fg=True
                ) // 2
            a, b = probes
            # analytic fallback: terminal MC count Mg -> Mg//2 halves the
            # leading (terminal-pass) variance
            fallback = 0.5
            ratio = self._measured_probe_ratio(
                out, a, b, fallback, num_valid=num_valid
            )
            u_half = (a[:, :1], b[:, :1])
        return self._guarded_u(out, x_t, u_breve_half=u_half,
                               num_valid=num_valid, probe_var_ratio=ratio)


class ScaSMLFullHistory(_ScaSMLBase):
    """Full-history ScaSML (reference ``solvers/ScaSML_full_history.py``)."""

    def _build(self, schedule_key):
        n, M = schedule_key
        return build_full_history_uz(
            self._model(), n, M, want_variance=self.variance_guard
        )

    def uz_solve(self, n: int, rho: int, x_t, M: int = 3) -> jax.Array:
        out = self._run((int(n), int(M)), x_t)
        self.evaluation_counter += count_evaluations_full_history(
            int(n), int(M), scasml_variant=True, count_fg=True
        )
        return out

    def u_solve(self, n: int, rho: int, x_t, M: int = 3,
                num_valid=None) -> jax.Array:
        """u_hat + [lambda] u_breve, with optional schedule auto-selection.

        When the equation opts in (``equation.escalate_M``, set by HJB),
        the schedule is picked from a shallow-first candidate ladder —
        depth-1 rollouts at escalating sample base (2M, 4M up to
        ``escalate_M_max``), then the requested (n, M) — by the guard's
        own probe statistics (``_auto_schedule_solve`` documents the
        measured rationale; the flagless HJB d = 100 default moves from an
        abstained 0.122 to ~0.05 this way, VERDICT round-4 Next #3)."""
        escalate = getattr(self.equation, "escalate_M", False) and (
            self.variance_guard
        )
        if not escalate:
            return self._u_solve_at(n, rho, x_t, M, num_valid)
        m_max = int(getattr(self.equation, "escalate_M_max", 12))
        ladder = []
        base = max(2 * int(M), 4)
        while base <= m_max:
            ladder.append((1, base))
            base *= 2
        if not ladder:
            ladder.append((1, max(int(M), 2)))
        if (int(n), int(M)) not in ladder:
            ladder.append((int(n), int(M)))
        return self._auto_schedule_solve(
            lambda c: self._u_solve_at(c[0], rho, x_t, c[1], num_valid),
            ladder, x_t,
        )

    def _u_solve_at(self, n: int, rho: int, x_t, M: int,
                    num_valid=None) -> jax.Array:
        out = self.uz_solve(n, rho, x_t, M)
        u_half = None
        ratio = 0.25
        if self.variance_guard and M >= 4:
            # paired independent half-sample probes (2 x (1/2)^n of the
            # main rollout's work; the stateful key advances per call)
            a = self.uz_solve(n, rho, x_t, M // 2)
            b = self.uz_solve(n, rho, x_t, M // 2)
            # analytic fallback: terminal MC count M^n -> ((M//2)/M)^n
            fallback = float(((M // 2) / M) ** n)
            ratio = self._measured_probe_ratio(
                out, a, b, fallback, num_valid=num_valid
            )
            u_half = (a[:, :1], b[:, :1])
        return self._guarded_u(out, x_t, u_breve_half=u_half,
                               num_valid=num_valid, probe_var_ratio=ratio)


# Reference-spelling alias.
ScaSML_full_history = ScaSMLFullHistory
