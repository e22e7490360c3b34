"""Trace-time-flattened multilevel Picard recursion.

The reference's ``uz_solve`` is a Python recursion with data-dependent shapes
(``int(Mf[...])``), so every tree node re-traces and every Newton-level loop
syncs with the host (reference ``solvers/MLP.py:141-274``; SURVEY.md §3.3
"Hot loop").  Here the (n, rho) schedule is static (host tables from
:mod:`scasml_gp.picard.schedule`), and the recursion is expanded at TRACE
time into one XLA program:

- the quadrature-point loop is a ``lax.scan`` (carrying the Brownian path X, W
  and the accumulators), so each sub-level is traced once per caller level,
  not once per quadrature point;
- all Monte-Carlo shapes are static; Brownian increments use properly split
  threefry keys (the reference reuses ``PRNGKey(0)`` at every node,
  solvers/MLP.py:167 — a correlated-samples bug we do not reproduce);
- the terminal pass chunks its MC axis so rho^rho-sample levels fit in HBM.

Both solver families share this module: the plain MLP passes the equation's
(f, g); ScaSML passes residual-calibrated (f, g) plus a leaf residual
injection (reference ``solvers/ScaSML.py:29-63,274-280``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from scasml_gp.picard.schedule import PicardTables

_TERMINAL_MC_CHUNK = 1024  # bounds (B * chunk * dim) terminal buffers


class PicardModel(NamedTuple):
    """Problem spec consumed by the recursion builders.

    ``params`` (e.g. a trained GPState) is threaded through every callable so
    the compiled program is reusable when the surrogate is retrained.
    """

    f: Callable      # (params, x_t, u, z) -> (rows, 1)
    g: Callable      # (params, x_t) -> (rows, 1)
    leaf: Optional[Callable]  # (params, x_t) -> (rows, 1) residual injection
    mu: float
    sigma: float
    T: float
    dim: int
    clip: float      # output clip (norm_estimation / uncertainty)
    center_z: bool = False  # centered (control-variate) z estimators
    # Full-history interior-time sampling: 'uniform' (reference
    # solvers/MLP_full_history.py:133-135) or 'sqrt' (importance density
    # p(tau) ~ 1/(2 sqrt(tau)), i.e. tau = v^2 with v uniform). The
    # uniform scheme's z weight 1/sqrt(tau) has INFINITE variance; 'sqrt'
    # cancels the singularity (Hutzenthaler-Jentzen-Kruse-Nguyen style)
    # and is required for gradient-quadratic generators like HJB.
    time_sampling: str = "uniform"
    # Terminal z denominator: 'reference' divides sum(g xi) by (T - t)
    # (solvers/MLP.py:201-202), which inflates z by 1/sqrt(T-t) relative
    # to the Stein identity E[g(X) xi] = sigma sqrt(T-t) E[grad g];
    # 'corrected' divides by sqrt(T - t). The linear-in-z reference PDE
    # is insensitive (the bias telescopes); gradient-quadratic ones are not.
    terminal_z: str = "reference"
    # Storage dtype of the Brownian sample paths (xi, X, W) — the dominant
    # (B x MC x dim) HBM buffers of the rollout. 'bfloat16' halves their
    # traffic; the u/z accumulators, weights and all reductions stay fp32
    # (PrecisionPolicy.rollout; VERDICT.md Next-round #3).
    path_dtype: str = "float32"
    # Reference-RNG parity probe (VERDICT round-2 #7): the reference's
    # terminal pass derives its normals from PRNGKey(0) at EVERY tree node
    # (solvers/MLP.py:167-179) — all calls with the same (rows, mc) shape
    # reuse identical draws.  That bug is accidentally a common-random-
    # numbers coupling: sim_l and sim_{l-1} share terminal noise, so the
    # telescoped difference f(sim_l) - f(sim_{l-1}) has REDUCED variance
    # (free MLMC coupling) — but the estimate keeps the luck of ONE noise
    # realization instead of averaging it out.  True reproduces it (fixed
    # PRNGKey(0) terminal key); an int freezes PRNGKey(int) instead, so the
    # parity probe can measure the ACROSS-REALIZATION spread of the frozen
    # estimator (scripts/quadrature_parity.py --frozen-seeds); False
    # (default) uses properly split independent keys.
    terminal_crn: "bool | int" = False
    # Faithful reference-estimator probe (VERDICT round-3 Next #8) for the
    # quadrature variant, combining the reference's remaining structural
    # quirks in one rollout (reference solvers/MLP.py:178,201-202,219-274):
    # - interior Brownian normals DRAWN in path_dtype (the reference draws
    #   fp16 normals, solvers/MLP.py:221) then accumulated fp32;
    # - the z denominator delta_t is a CARRIED variable: initialized to
    #   (T - t + 1e-6) by the terminal pass, used by the positive f term,
    #   and only reassigned to (c_k - t + 1e-6) inside the `if l:` branch —
    #   so level-0 positive terms divide by (T - t) at EVERY quadrature
    #   point, and l >= 1 positive terms use the PREVIOUS k's value;
    # - every recursion level's output is quantized through float16
    #   (solvers/MLP.py:274 casts each uz_solve return to fp16).
    # False (default) = our corrected estimator ((c_k - t) denominators,
    # fp32 draws, no per-level quantization).
    reference_semantics: bool = False
    # f applied to the level-0 (identically zero) Picard estimate is itself
    # identically zero.  True for the ScaSML residual generator: f_breve(x,
    # 0, 0) = f(x, u_hat, sigma grad u_hat) - f(x, u_hat, sigma grad u_hat)
    # is BITWISE zero (0 + a == a in IEEE fp), so the builders skip the whole
    # f evaluation — which is a full GP-posterior-with-gradient sweep at the
    # LARGEST mf of every level, ~1/3 of all rollout posterior work — with no
    # change to the estimator.  The reference evaluates it anyway
    # (solvers/ScaSML.py:205-233 at l==0).  False for plain MLP, whose
    # f(x, 0, 0) is the true generator at the origin and nonzero.
    f_zero_at_zero: bool = False


def _z_accum(vals, weights, mf: int, centered: bool):
    """Per-sample z contribution sum: sum_i vals_i * weights_i, optionally in
    unbiased covariance form (centered control variate), normalized by the
    effective sample count. vals: (B, mf); weights: (B, mf, dim)."""
    weights = weights.astype(jnp.float32)  # f32 accumulate (paths may be bf16)
    prod = jnp.sum(vals[..., None] * weights, axis=1)          # (B, dim)
    if centered and mf > 1:
        corr = (
            jnp.sum(vals, axis=1)[:, None]
            * jnp.sum(weights, axis=1) / mf
        )
        return (prod - corr) / (mf - 1)
    return prod / mf


def _sample_var_of_mean(vals, mf: int):
    """Unbiased variance of mean(vals, axis=1): S^2/mf with
    S^2 = sum (v - mean)^2 / (mf - 1).  Zero when mf < 2."""
    if mf < 2:
        return jnp.zeros((vals.shape[0], 1), jnp.float32)
    m = jnp.mean(vals, axis=1, keepdims=True)
    s2 = jnp.sum((vals - m) ** 2, axis=1, keepdims=True) / (mf - 1)
    return s2 / mf


def _terminal_pass(
    model: PicardModel, params, x, t, key, mc: int, want_var: bool = False
):
    """Terminal Monte-Carlo estimate:
        u = mean g(X_T),  z = mean(g(X_T) * xi) / (T - t + 1e-6)
    (reference solvers/MLP.py:167-203), chunked over the MC axis.
    ``want_var`` additionally returns the unbiased variance of the u
    estimate (S^2/mc across the MC axis) for the ScaSML variance guard."""
    B = x.shape[0]
    dim = model.dim
    pd = jnp.dtype(model.path_dtype)
    if model.terminal_crn is not False:
        # reference semantics: frozen per shape (True -> the reference's
        # literal PRNGKey(0); an int seed probes other frozen realizations)
        seed = 0 if model.terminal_crn is True else int(model.terminal_crn)
        key = jax.random.PRNGKey(seed)
    dT = (model.T - t)[:, None]
    u_sum = jnp.zeros((B, 1), jnp.float32)
    usq_sum = jnp.zeros((B, 1), jnp.float32)
    z_sum = jnp.zeros((B, dim), jnp.float32)
    xi_sum = jnp.zeros((B, dim), jnp.float32)
    done = 0
    while done < mc:
        cur = min(_TERMINAL_MC_CHUNK, mc - done)
        key, sub = jax.random.split(key)
        xi = jax.random.normal(sub, (B, cur, dim), pd)
        XT = (
            x[:, None, :]
            + model.mu * dT[..., None]
            + model.sigma * jnp.sqrt(dT)[..., None] * xi
        )
        xt_T = jnp.concatenate(
            [XT, jnp.full((B, cur, 1), model.T, XT.dtype)], axis=2
        ).reshape(-1, dim + 1).astype(jnp.float32)
        gv = model.g(params, xt_T).reshape(B, cur).astype(jnp.float32)
        u_sum = u_sum + jnp.sum(gv, axis=1, keepdims=True)
        if want_var:
            usq_sum = usq_sum + jnp.sum(gv * gv, axis=1, keepdims=True)
        z_sum = z_sum + jnp.sum(gv[..., None] * xi, axis=1)  # f32 accumulate
        xi_sum = xi_sum + jnp.sum(xi.astype(jnp.float32), axis=1)
        done += cur
    u = u_sum / mc
    u_var = None
    if want_var:
        # Var(mean) = (sum g^2 - mc * mean^2) / ((mc - 1) * mc)
        s2 = (usq_sum - mc * u * u) / max(mc - 1, 1)
        u_var = jnp.maximum(s2, 0.0) / mc
    if model.terminal_z == "corrected":
        denom_t = jnp.sqrt(dT) + 1e-6
    else:
        denom_t = dT + 1e-6
    if model.center_z and mc > 1:
        # unbiased covariance form: (sum g xi - (sum g)(sum xi)/M) / (M-1)
        # — a baseline control variate that removes the O(|g|) variance of
        # the reference's raw estimator (solvers/MLP.py:202)
        z_sum = z_sum - u_sum * xi_sum / mc
        z = z_sum / ((mc - 1) * denom_t)
    else:
        z = z_sum / (mc * denom_t)
    if want_var:
        return u, z, u_var
    return u, z


def build_quadrature_uz(
    model: PicardModel, n: int, rho: int, tables: PicardTables,
    want_variance: bool = False,
) -> Callable:
    """Build fn(x_t, key, params) -> (B, 1+dim) for the quadrature variant
    (semantics of reference solvers/MLP.py:141-274 / ScaSML.py:149-284).

    ``want_variance`` appends the top-level u-estimate MC variance column
    (see build_full_history_uz), for the ScaSML variance guard."""
    Mf, Mg, Q, c, w = tables
    T, dim = model.T, model.dim
    pd = jnp.dtype(model.path_dtype)

    def uz(lvl: int, x_t, key, params, want_var: bool = False):
        B = x_t.shape[0]
        if lvl <= 0:
            # Level-0 estimate is zero (reference solvers/MLP.py:205-207).
            return jnp.zeros((B, 1 + dim), jnp.float32)
        x = x_t[:, :-1].astype(jnp.float32)
        t = x_t[:, -1].astype(jnp.float32)

        key, kterm = jax.random.split(key)
        term = _terminal_pass(
            model, params, x, t, kterm, int(Mg[rho - 1, lvl]),
            want_var=want_var,
        )
        if want_var:
            u, z, var = term
        else:
            (u, z), var = term, None

        for l in range(lvl):
            q = int(Q[rho - 1, lvl - l - 1])
            mf = int(Mf[rho - 1, lvl - l - 1])
            nodes = jnp.asarray(c[:q, q - 1], jnp.float32)    # ascending on [0,T]
            weights = jnp.asarray(w[:q, q - 1], jnp.float32)
            cloc = t[:, None] + (T - t)[:, None] * nodes[None, :] / T  # (B, q)
            wloc = (T - t)[:, None] * weights[None, :] / T             # (B, q)
            dts = jnp.diff(
                jnp.concatenate([t[:, None], cloc], axis=1), axis=1
            )                                                          # (B, q)
            key, kl = jax.random.split(key)
            kks = jax.random.split(kl, q)

            # Brownian path carries in the storage dtype (PrecisionPolicy.
            # rollout); the per-step updates compute in f32 and round once.
            X0 = jnp.broadcast_to(x[:, None, :], (B, mf, dim)).astype(pd)
            W0 = jnp.zeros((B, mf, dim), pd)

            def step(carry, inp):
                X, W, u, z, var_c, dt_ref = carry
                kk, dt_k, c_k, w_k = inp
                samp = (
                    jnp.zeros((B, mf), jnp.float32) if want_var else None
                )
                draw_dtype = pd if model.reference_semantics else jnp.float32
                dW = jnp.sqrt(dt_k)[:, None, None] * jax.random.normal(
                    kk, (B, mf, dim), draw_dtype
                ).astype(jnp.float32)
                W = (W.astype(jnp.float32) + dW).astype(pd)
                X = (
                    X.astype(jnp.float32)
                    + model.mu * dt_k[:, None, None]
                    + model.sigma * dW
                ).astype(pd)
                xt_k = jnp.concatenate(
                    [
                        X.astype(jnp.float32),
                        jnp.broadcast_to(c_k[:, None, None], (B, mf, 1)),
                    ],
                    axis=2,
                ).reshape(-1, dim + 1)
                denom_k = (c_k - t + 1e-6)[:, None]
                # the reference's carried delta_t (see PicardModel.
                # reference_semantics): positive terms divide by the value
                # LAST assigned — (T - t) until an `if l:` body runs
                denom_pos = dt_ref if model.reference_semantics else denom_k

                if l > 0 or not model.f_zero_at_zero:
                    sim_l = uz(l, xt_k, jax.random.fold_in(kk, 1), params)
                    y = model.f(
                        params, xt_k, sim_l[:, :1], sim_l[:, 1:]
                    ).reshape(B, mf)
                    u = u + w_k[:, None] * jnp.mean(y, axis=1, keepdims=True)
                    z = z + w_k[:, None] * _z_accum(
                        y, W, mf, model.center_z
                    ) / denom_pos
                    if want_var:
                        samp = samp + y
                if l:
                    if l - 1 > 0 or not model.f_zero_at_zero:
                        sim_lm1 = uz(
                            l - 1, xt_k, jax.random.fold_in(kk, 2), params
                        )
                        y2 = model.f(
                            params, xt_k, sim_lm1[:, :1], sim_lm1[:, 1:]
                        ).reshape(B, mf)
                        u = u - w_k[:, None] * jnp.mean(y2, axis=1, keepdims=True)
                        z = z - w_k[:, None] * _z_accum(
                            y2, W, mf, model.center_z
                        ) / denom_k
                        if want_var:
                            samp = samp - y2
                    # reference reassigns delta_t inside `if l:` only
                    dt_ref = denom_k
                elif model.leaf is not None:
                    # GP PDE-residual injection at leaf level
                    # (reference solvers/ScaSML.py:274-280).
                    eps = model.leaf(params, xt_k).reshape(B, mf)
                    u = u + w_k[:, None] * jnp.mean(eps, axis=1, keepdims=True)
                    z = z + w_k[:, None] * _z_accum(
                        eps, W, mf, model.center_z
                    ) / denom_pos
                if want_var:
                    # quadrature nodes use fresh Brownian increments per
                    # step; per-step contribution is w_k * mean(samp)
                    var_c = var_c + (
                        w_k[:, None] ** 2 * _sample_var_of_mean(samp, mf)
                    )
                return (X, W, u, z, var_c, dt_ref), None

            if var is None:
                var = jnp.zeros((B, 1), jnp.float32)
            dt0 = (model.T - t + 1e-6)[:, None]  # terminal-pass delta_t
            (X0, W0, u, z, var, _), _ = jax.lax.scan(
                step,
                (X0, W0, u, z, var, dt0),
                (kks, dts.T, cloc.T, wloc.T),
            )

        out = jnp.concatenate([u, z], axis=1)
        out = jnp.clip(out, -model.clip, model.clip)
        if model.reference_semantics:
            # the reference quantizes EVERY recursion level's output
            # (solvers/MLP.py:274).  NOTE: the carried-delta_t emulation
            # resets to (T - t) per level, which is exact for n <= 2 (the
            # parity cell under test); at n >= 3 the reference would carry
            # the previous LEVEL's last value across levels too.
            out = out.astype(jnp.float16).astype(jnp.float32)
        if want_var:
            out = jnp.concatenate([out, var], axis=1)  # var column unclipped
        return out

    def fn(x_t, key, params):
        return uz(n, x_t, key, params, want_var=want_variance)

    return fn


def build_full_history_uz(
    model: PicardModel, n: int, M: int, want_variance: bool = False
) -> Callable:
    """Build fn(x_t, key, params) -> (B, 1+dim) for the full-history variant
    (semantics of reference solvers/MLP_full_history.py:64-180 /
    ScaSML_full_history.py): interior times are sampled uniformly on [t, T]
    instead of by quadrature; updates are
        u += (T-t) mean y,   z += (T-t) mean(y * xi / sqrt(tau (T-t) + 1e-6)).

    ``want_variance`` appends one extra output column: the unbiased MC
    variance of the TOP-LEVEL u estimate (sum over the terminal pass and
    each level's sample variance of the mean — levels use independent
    samples, and the per-level sample spread already contains all nested
    sub-estimator noise).  Used by the ScaSML variance guard
    (picard/scasml.py; VERDICT round-2 #5); costs one (B, mf) square +
    reduction per level.
    """
    T, dim = model.T, model.dim
    pd = jnp.dtype(model.path_dtype)

    def uz(lvl: int, x_t, key, params, want_var: bool = False):
        B = x_t.shape[0]
        if lvl <= 0:
            return jnp.zeros((B, 1 + dim), jnp.float32)
        x = x_t[:, :-1].astype(jnp.float32)
        t = x_t[:, -1].astype(jnp.float32)
        dT = (T - t)[:, None]

        key, kterm = jax.random.split(key)
        term = _terminal_pass(
            model, params, x, t, kterm, int(M**lvl), want_var=want_var
        )
        if want_var:
            u, z, var = term
        else:
            (u, z), var = term, None

        for l in range(lvl):
            mf = int(M ** (lvl - l))
            key, ktau, kxi = jax.random.split(key, 3)
            v = jax.random.uniform(ktau, (B, mf), jnp.float32)
            if model.time_sampling == "sqrt":
                # tau ~ p(tau) = 1/(2 sqrt(tau)); importance weight 2 sqrt(tau)
                tau = v * v
                wgt = (2.0 * v)[..., None]                   # (B, mf, 1)
            else:
                tau = v
                wgt = jnp.ones((B, mf, 1), jnp.float32)
            ts = (tau * dT)[..., None]                       # (B, mf, 1)
            xi = jax.random.normal(kxi, (B, mf, dim), pd)
            X = x[:, None, :] + model.mu * ts + model.sigma * jnp.sqrt(ts) * xi
            xt_k = jnp.concatenate([X, t[:, None, None] + ts], axis=2).reshape(
                -1, dim + 1
            ).astype(jnp.float32)
            inv_sqrt = 1.0 / jnp.sqrt(ts + 1e-6)             # (B, mf, 1)

            eta = xi * inv_sqrt * wgt                        # (B, mf, dim)
            wflat = wgt[..., 0]                              # (B, mf)
            samp = jnp.zeros((B, mf), jnp.float32) if want_var else None
            key, k1 = jax.random.split(key)
            if l > 0 or not model.f_zero_at_zero:
                sim_l = uz(l, xt_k, k1, params)
                y = model.f(
                    params, xt_k, sim_l[:, :1], sim_l[:, 1:]
                ).reshape(B, mf)
                u = u + dT * jnp.mean(y * wflat, axis=1, keepdims=True)
                z = z + dT * _z_accum(y, eta, mf, model.center_z)
                if want_var:
                    samp = samp + y * wflat
            if l:
                key, k2 = jax.random.split(key)
                if l - 1 > 0 or not model.f_zero_at_zero:
                    sim_lm1 = uz(l - 1, xt_k, k2, params)
                    y2 = model.f(
                        params, xt_k, sim_lm1[:, :1], sim_lm1[:, 1:]
                    ).reshape(B, mf)
                    u = u - dT * jnp.mean(y2 * wflat, axis=1, keepdims=True)
                    z = z - dT * _z_accum(y2, eta, mf, model.center_z)
                    if want_var:
                        samp = samp - y2 * wflat
            elif model.leaf is not None:
                eps = model.leaf(params, xt_k).reshape(B, mf)
                u = u + dT * jnp.mean(eps * wflat, axis=1, keepdims=True)
                z = z + dT * _z_accum(eps, eta, mf, model.center_z)
                if want_var:
                    samp = samp + eps * wflat
            if want_var:
                # per-level u contribution is dT * mean(samp); the levels use
                # independent samples so their variances add
                var = var + dT * dT * _sample_var_of_mean(samp, mf)

        out = jnp.concatenate([u, z], axis=1)
        out = jnp.clip(out, -model.clip, model.clip)
        if want_var:
            out = jnp.concatenate([out, var], axis=1)  # var column unclipped
        return out

    def fn(x_t, key, params):
        return uz(n, x_t, key, params, want_var=want_variance)

    return fn
