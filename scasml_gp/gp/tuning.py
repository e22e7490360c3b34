"""Validation-based GP hyperparameter selection (on-device).

The reference has no hyperparameter fitting at all — kernel width and nugget
are hardcoded (models/GP.py:25-26).  BASELINE.json's north star asks for
on-device GP hyperparameter fitting; this module implements it WITHOUT
peeking at the exact solution.

Candidates are judged by the framework's own calibrated estimator
(round 5):

    score = mean over held-out interior points of  u_breve(X_val)^2,

where ``u_breve`` is the candidate surrogate's ScaSML residual-Picard
correction (picard/scasml.py) — a direct, low-variance Monte-Carlo
estimate of the candidate's OWN error field u - u_hat (the rollout runs on
the residual PDE, so its variance scales with the error it measures, not
with u).  Common random numbers across candidates (the rollout key is
reset per candidate) cancel most of the remaining MC noise from the
comparison.

Two earlier scores measurably mis-rank at d >= 60 and are retired:

- out-of-sample PDE residual eps^2 + boundary mismatch (rounds 2-4): a
  residual metric structurally REWARDS over-smooth kernels (damped
  derivatives shrink eps regardless of solution error — the same pathology
  as the profile-NLML objective, reports/ml_tuner_diagnosis.md); at d=60
  it stably ranked a config testing 0.116 above one testing 0.051.
- distance to an independent plain-MLP MC anchor: the shallow estimator's
  own bias correlates with exactly the over-smooth candidates' error
  pattern, reproducing the same mis-ranking at any tested anchor strength
  (n=2 M=8 and n=3 M=16).

Measured with the ScaSML judge at d=60: the score's top-3 candidates ARE
the test top-3 (0.052/0.060/0.049), and the previously mis-chosen config
drops to 4th-from-bottom.  (reports/tuner_judge.md)

Candidates train at FULL size and are judged on freshly sampled interior
points (two independent sets, averaged): the judge needs no held-out data
— u_breve estimates the surrogate's error wherever it is evaluated — and
selection on subsample-trained candidates measurably mis-ranks (the
config landscape shifts with N; the d=60 winner at N=800 tests 2.3x worse
retrained at N=1000).

The search is a small grid over (time_scale, ridge_scale, gamma_scale,
nugget); every candidate shares compiled train+rollout programs (traced
gamma/nugget and a GPState pytree).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from scasml_gp.config import GPConfig


@dataclasses.dataclass
class TuneResult:
    config: GPConfig
    score: float
    table: list  # [(config, score), ...] over all candidates


def validation_score(gp, x_val_dom, x_val_bdy, boundary_weight: float = 1.0):
    """Out-of-sample PDE residual + boundary mismatch of a trained GP.

    DIAGNOSTIC ONLY (round 5): this residual-based score structurally
    rewards over-smooth kernels and is NOT used for selection anymore
    (module docstring); `tune_gp`/`fit_gp_marginal_likelihood` judge by
    ScaSML correction energy.  Kept for the attribution experiments
    (scripts/ml_tuner_diagnosis.py)."""
    eps = np.asarray(gp.compute_PDE_loss(x_val_dom), np.float64).ravel()
    u_b = np.asarray(gp.predict(x_val_bdy), np.float64).ravel()
    g_b = np.asarray(gp.equation.g(x_val_bdy), np.float64).ravel()
    return float(np.mean(eps**2) + boundary_weight * np.mean((u_b - g_b) ** 2))


def tune_gp(
    gp_cls,
    equation,
    x_dom,
    x_bdy,
    base: Optional[GPConfig] = None,
    time_scales: Sequence[float] = (1.0,),
    ridge_scales: Sequence[float] = (0.0, 3.0, 10.0, 30.0),
    gamma_scales: Sequence[float] = (1.0,),
    nuggets: Optional[Sequence[float]] = None,
    val_fraction: float = 0.4,
    gn_steps: Optional[int] = None,
    seed: int = 0,
    train_backend: str = "auto",
    judge_n: Optional[int] = None,
    judge_M: int = 8,
    judge_score: str = "energy",
    judge_val_sets: int = 3,
) -> TuneResult:
    """Grid-search GP hyperparameters; candidates train at full size and
    are judged by their own ScaSML correction energy on fresh interior
    points (module docstring).

    Returns the winning GPConfig; the returned ``gp_cls(equation, config)``
    trained on all of (x_dom, x_bdy) is what callers should use.

    All candidates share ONE compiled train+score program (kernel gammas and
    nugget are traced arguments of ``GP._train_jit``), so a grid point costs
    an execution, not a retrace.  Candidates run one after another.
    """
    base = base or GPConfig()
    nuggets = nuggets or (base.nugget,)
    if judge_n is None:
        # Depth auto-selection (measured, scripts/tuner_probe.py): the
        # n=2 residual-Picard judge under-estimates large-residual
        # candidates (its truncation misses the nonlinear-feedback tail
        # of the error) and at d=100 stably picks a rank-2 candidate
        # (test 0.149 vs grid-best 0.125) under both val seeds tested;
        # the n=3 judge picks the test optimum with zero regret.  At
        # d = 40..80 the n=2 judge already picks optimally, so the ~4x
        # deeper rollout is reserved for d >= 100.
        judge_n = 3 if equation.dim >= 100 else 2
    x_dom = jnp.asarray(x_dom, jnp.float32)
    x_bdy = jnp.asarray(x_bdy, jnp.float32)

    n_dom, n_bdy = x_dom.shape[0], x_bdy.shape[0]

    gp = gp_cls(equation, base)
    steps = base.gn_steps if gn_steps is None else int(gn_steps)
    dim = equation.dim
    bg = equation.g(x_bdy)[:, 0].astype(jnp.float32)
    rhs = gp.form.rhs_f(x_dom).astype(jnp.float32)

    # Large-N candidates train through the distributed dual-CG trainer
    # (gp/distributed.py): gamma/nugget are traced there too, so the grid
    # still shares ONE compiled program.  The dense trainer would need the
    # phi^2 inverse per candidate, which caps out around phi ~ 8k.
    backend = gp._resolve_train_backend(x_dom, x_bdy) if (
        train_backend == "auto"
    ) else train_backend
    if backend == "distributed":
        from scasml_gp.gp.distributed import make_distributed_train
        from scasml_gp.parallel.mesh import make_mesh

        mesh = make_mesh(data=1, model=len(jax.devices()))
        dist_train = make_distributed_train(
            gp.form, mesh, dim, gn_steps=base.dist_gn_steps,
            cg_tol=base.dist_cg_tol, cg_maxiter=base.dist_cg_maxiter,
        )

        def train_rv(gamma, nugget):
            out, _ = dist_train(x_dom, x_bdy, bg, rhs, gamma, nugget)
            return out.right_vector
    else:
        def train_rv(gamma, nugget):
            return gp._train_jit(
                x_dom, x_bdy, bg, rhs, gamma, nugget,
                steps=steps, damping=base.damping, grad_tol=base.grad_tol,
                init_scale=base.init_scale,
            ).right_vector

    # The ScaSML judge: one shared solver instance whose compiled rollout
    # takes the trained GPState as a pytree argument, so every candidate
    # (and both val sets) reuses ONE compiled program.  variance_guard
    # off: the raw correction energy IS the score.
    #
    # Candidates train at FULL size and are judged on FRESHLY SAMPLED
    # interior points: the judge needs no held-out data (u_breve estimates
    # the surrogate's error wherever it is evaluated), and selection on
    # 80/20-subsample-trained candidates measurably mis-ranks — the
    # config landscape shifts with N (the d=60 winner at N=800 tests 2.3x
    # worse at N=1000).  Two independent val sets are averaged.
    from scasml_gp.gp.state import GPState
    from scasml_gp.picard.scasml import ScaSMLFullHistory

    judge_gp = gp_cls(equation, base)
    judge = ScaSMLFullHistory(equation, judge_gp, variance_guard=False)
    geom = equation.geometry()
    # Judge-noise sizing (measured, scripts/tuner_probe.py at d=40): with
    # 2 x 200 val points the near-tie between the top-2 candidates flips
    # with the val seed (scores 5.92e-4 vs 5.99e-4 at seed 0 but 7.41e-4
    # vs 6.20e-4 at seed 1234 — a ~25% per-config seed swing), and the
    # wrong side of the flip tests 0.052 vs 0.037.  3 x 400 points cuts
    # the val-sampling term ~sqrt(3)x; rollouts are ~1-2 s each, so the
    # extra coverage costs seconds per candidate.
    n_val = max(64, int(n_dom * val_fraction))
    val_sets = [
        geom.sample_domain(jax.random.PRNGKey(seed + 7 * (i + 1)), n_val)
        for i in range(judge_val_sets)
    ]

    def score_one(gamma, nugget):
        rv = train_rv(gamma, nugget)
        judge_gp.state = GPState(
            x_dom=x_dom, x_bdy=x_bdy, right_vector=rv,
            sol=jnp.zeros((3 * n_dom,), jnp.float32),
            gamma=gamma,
            loss_history=jnp.zeros((1,), jnp.float32),
        )
        total = 0.0
        for si, val_d in enumerate(val_sets):
            # common random numbers: every candidate judges with the SAME
            # rollout keys, cancelling most MC noise from the comparison
            judge.key = jax.random.PRNGKey(seed + 101 * (si + 1))
            ub = judge.uz_solve(judge_n, None, val_d, M=judge_M)[:, :1]
            if judge_score == "cross":
                # cross-product of two INDEPENDENT rollouts on the same
                # points: E[ub1*ub2] = (u - u_hat)^2 exactly, removing the
                # additive MC-variance term the single-rollout energy
                # E[ub^2] carries.  Measured at d=100 (scripts/
                # tuner_probe.py): the two scores differ < 4% on every
                # grid candidate and pick identically — MC variance is
                # NOT the judge's limiting error at the default judge_M,
                # so 'energy' (half the rollout cost) stays the default.
                judge.key = jax.random.PRNGKey(seed + 101 * (si + 1) + 53)
                ub2 = judge.uz_solve(judge_n, None, val_d, M=judge_M)[:, :1]
                total += float(jnp.mean(ub * ub2))
            else:
                total += float(jnp.mean(ub * ub))
        return total / len(val_sets)

    table = []
    best = None
    for ts, rs, gsc, ng in itertools.product(
        time_scales, ridge_scales, gamma_scales, nuggets
    ):
        config = dataclasses.replace(
            base, time_scale=ts, ridge_scale=rs, gamma_scale=gsc, nugget=ng
        )
        gamma = jnp.asarray(gp_cls(equation, config).gamma, jnp.float32)
        score = float(score_one(gamma, jnp.float32(ng)))
        table.append((config, score))
        if best is None or score < best[1]:
            best = (config, score)

    return TuneResult(config=best[0], score=best[1], table=table)
