"""Reaction-semigroup surrogate for the Allen-Cahn equation.

Round-4 VERDICT #1: the space-time collocation GP (gp/solver.py
AllenCahnForm) lands at rel-L2 0.86 (d=20) to 1.23 (d=100) on Allen-Cahn —
worse than predicting zero.  The cause is the SAME terminal-value
ill-posedness already attributed for HJB (gp/cole_hopf.py docstring):
Allen-Cahn here is

    u_t + Lap u + u - u^3 = 0,   u(x, T) = g(x) = 1/(2 + 0.4 |x|^2)

with sigma = sqrt(2), T = 0.3, terminal-only boundary data on the box
[-0.5, 0.5]^d.  The diffusion reach sigma*sqrt(T) = 0.775 exceeds the box
half-width 0.5, so the solution at every interior point is dominated by
terminal data OUTSIDE the box; the interior PDE rows cannot pin it down and
the zero-mean prior fills the null space (measured widening sweep:
scripts/allen_cahn_attribution.py -> reports/allen_cahn_attribution.md).

This surrogate exploits the PDE's exact structures instead, the same move
that fixed HJB (gp/cole_hopf.py), adapted to a reaction-diffusion generator:

1. **Linearized reaction semigroup.**  Split f(u) = u - u^3 into its
   linearization at 0 (lam = f'(0) = 1) plus the cubic remainder.  The
   linear flow   u_t + (sigma^2/2) Lap u + lam u = 0   factorizes exactly:

       u(x, t) = e^{lam tau} (P_tau g)(x),   tau = T - t,

   with P the heat semigroup — the reaction is a scalar exponential.

2. **The heat semigroup acts on Gaussians in closed form.**  Two terminal
   representations, both exactly evolvable:

   - ``mixture`` (default when the equation exposes the structure): the
     terminal condition g = 1/(a + b |x|^2) is COMPLETELY MONOTONE in
     q = |x|^2, so by Bernstein's theorem it is an exact nonnegative
     mixture of origin-centered Gaussians,

         1/(a + b q) = (1/a) int_0^inf e^{-t} e^{-(b/a) t q} dt,

     discretized by Gauss-Laguerre quadrature (spectrally accurate: 64
     nodes give < 1e-6 relative error over the reachable q range at any
     d).  Each component evolves as

         P_tau[e^{-c|y|^2}](x) = (1 + 2 c sigma^2 tau)^{-d/2}
                                  exp(-c |x|^2 / (1 + 2 c sigma^2 tau)),

     so the linear flow is essentially EXACT — measured rel-L2 vs the
     deep-MC oracle: 0.0073 at d=20 and 0.0023 at d=100, both within the
     oracle's own half-run disagreement (0.0085 / 0.0046); plain MLP sits
     at 0.039 / 0.023 on the same protocol.

   - ``rbf``: a constant-mean scattered Gaussian-RBF interpolant of g on
     points pushed to the terminal surface along each training point's
     diffusion cone (the Cole-Hopf construction), each bump widening
     s^2 -> s^2 + sigma^2 tau.  Works for ANY terminal condition; width
     selected by held-out terminal-fit error over a beta grid (the
     criterion tracks the true evolved error: both minimize at beta = 0.7,
     reports/allen_cahn_attribution.md).  Measured: 0.016 at d=20, 0.17 at
     d=100 (scattered interpolation cannot cover the d=100 reachable set
     with ~1k centers — the mixture backend exists for exactly this
     reason).

The surrogate solves the LINEAR PDE exactly at every (x, t), so its
Allen-Cahn strong-form residual is closed-form and exact:

    eps = u_t + (sigma^2/2) Lap u + u - u^3 = (1 - lam) u - u^3 = -u^3

(lam = 1) — ScaSML's leaf injection then carries precisely the dropped
cubic term while g_breve carries the terminal-fit error: the rollout
corrects exactly the two approximations the surrogate makes, and nothing
else.  (f = u - u^3 has no z dependence, so unlike HJB the correction's MC
noise stays unbiased variance — no guard needed.)

Device notes: the mixture posterior is (n,) elementwise math against 64
broadcast nodes (one (n, nq) block, fused by XLA); the rbf posterior is one
(n, m) distance matmul + fused bump math + one (n,m)@(m,d) matmul for
the gradient; training is at most a single m x m Cholesky.

The reference has no Allen-Cahn capability at all; the collocation
GPAllenCahn (gp/solver.py) remains importable for the attribution
experiments.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from scasml_gp.gp.cole_hopf import _v_block
from scasml_gp.gp.kernels import sq_dists
from scasml_gp.gp.posterior import PosteriorOut
from scasml_gp.gp.solver import AllenCahnForm, GP
from scasml_gp.gp.state import GPState

# held-out width-selection grid for the rbf backend, in units of
# sqrt(d sigma^2 T) (measured optimum 0.7 at d = 20 and d = 100)
_BETA_GRID = (0.5, 0.6, 0.7, 0.8, 1.0)


def bernstein_panel_nodes(k: float, t_min: float = 1e-5,
                          t_max: float = 60.0, per_panel: int = 8,
                          ratio: float = 2.0):
    """Composite log-panel Gauss-Legendre nodes/weights for the Bernstein
    integral  (1+bq)^{-k} = (1/Gamma(k)) int_0^inf t^{k-1} e^{-t} e^{-tbq} dt.

    Plain (generalized) Gauss-Laguerre under-resolves the EVOLVED
    integrand: the heat factor (1 + 2 t b sig2 tau)^{-d/2} ~ e^{-t d b
    sig2 tau} concentrates the mass at t ~ 1/(d sig2 tau) — 4e-3 at HJB
    d=250, far below the smallest 64-node Laguerre node (0.022); measured
    rel-L2 degraded to 0.36 at d=250.  Log-spaced panels from ``t_min`` to
    ``t_max`` (geometric ratio) with ``per_panel`` Gauss-Legendre nodes
    each resolve EVERY concentration scale >= t_min at once, for any
    (d, tau, r^2) — the node set stays fixed (so the mixture components
    stay genuine Gaussians and the closed-form derivative algebra is
    untouched).  Returns (t, w) with w absorbing t^{k-1} e^{-t} and the
    1/Gamma(k) normalization.
    """
    import math as _math

    import numpy as _np

    gx, gw = _np.polynomial.legendre.leggauss(per_panel)
    edges = [0.0, t_min]
    while edges[-1] < t_max:
        edges.append(min(edges[-1] * ratio, t_max))
    ts, ws = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        mid, half = 0.5 * (hi + lo), 0.5 * (hi - lo)
        t = mid + half * gx
        ts.append(t)
        ws.append(half * gw * _np.power(t, k - 1.0) * _np.exp(-t))
    t = _np.concatenate(ts)
    w = _np.concatenate(ws) / _math.gamma(k)
    return t, w


def mixture_features(x, weights, rates, sig2, T, dim,
                     want_grad: bool, want_ops: bool):
    """Closed-form heat evolution of an origin-centered Gaussian mixture
    F(y) = sum_k w_k e^{-c_k |y|^2} under P_tau (generator (sig2/2) Lap):

        V(x, t) = sum_k w_k den_k^{-d/2} exp(-c_k r^2 / den_k),
        den_k = 1 + 2 c_k sig2 tau,   tau = T - t,  r^2 = |x|^2.

    Returns (V, grad_sp, dt_V, div_V, lap_V) with dt_V = -(sig2/2) lap_V
    exact (V solves the heat equation).  Shared by the Allen-Cahn
    reaction-semigroup surrogate (u-space mixture) and the Cole-Hopf HJB
    surrogate's mixture backend (v-space mixture): both terminal
    conditions are completely monotone in |x|^2, so Bernstein's theorem
    gives exact mixtures of exactly this form."""
    xs = x[:, :dim]
    tau = jnp.maximum(T - x[:, dim], 0.0)                     # (n,)
    r2 = jnp.sum(xs * xs, axis=1)                             # (n,)
    den = 1.0 + 2.0 * rates[None, :] * sig2 * tau[:, None]    # (n, nq)
    ceff = rates[None, :] / den                               # (n, nq)
    # den^{-d/2} via exp(log) — d/2 can exceed fp32 pow stability at
    # large d
    A = weights[None, :] * jnp.exp(
        -0.5 * dim * jnp.log(den) - ceff * r2[:, None]
    )                                                         # (n, nq)
    V = jnp.sum(A, axis=1)
    grad_sp = dt_V = div_V = lap_V = None
    if want_grad or want_ops:
        B = jnp.sum(A * ceff, axis=1)                         # (n,)
        grad_sp = -2.0 * B[:, None] * xs
    if want_ops:
        C2 = jnp.sum(A * ceff * ceff, axis=1)
        lap_V = -2.0 * dim * B + 4.0 * C2 * r2
        dt_V = -(sig2 / 2.0) * lap_V                          # exact
        div_V = -2.0 * B * jnp.sum(xs, axis=1)
    return V, grad_sp, dt_V, div_V, lap_V


class GPAllenCahnSemigroup(GP):
    """Reaction-semigroup surrogate for Allen-Cahn (round-5 replacement for
    the ill-posed space-time collocation; see module docstring).

    ``GPsolver`` keeps the base signature (``GN_steps`` accepted and
    ignored — the linear flow has nothing to iterate).  ``terminal_backend``:
    'auto' uses the exact Bernstein mixture when the equation exposes
    ``terminal_bernstein()`` and the scattered-RBF fit otherwise.
    """

    form_cls = AllenCahnForm

    def __init__(self, equation, config=None, precision=None, mesh=None,
                 width: Optional[float] = None, fit_nugget: float = 1e-4,
                 reaction: Optional[float] = None,
                 terminal_backend: str = "auto", mixture_nodes: int = 64):
        super().__init__(equation, config, precision=precision, mesh=mesh)
        sig = float(equation.sigma())
        self.sig2 = sig**2
        self.fit_nugget = float(fit_nugget)
        # lam = f'(0) of the reaction term f(u) = u - u^3
        self.lam = 1.0 if reaction is None else float(reaction)
        self.mixture_nodes = int(mixture_nodes)
        bern = getattr(equation, "terminal_bernstein", None)
        if terminal_backend == "auto":
            terminal_backend = "mixture" if bern is not None else "rbf"
        if terminal_backend == "mixture" and bern is None:
            raise ValueError(
                "terminal_backend='mixture' needs equation."
                "terminal_bernstein() -> (a, b) with g = 1/(a + b |x|^2)"
            )
        if terminal_backend not in ("mixture", "rbf"):
            raise ValueError(f"unknown terminal_backend {terminal_backend!r}")
        self.terminal_backend = terminal_backend
        # rbf-backend width: None selects from _BETA_GRID by held-out
        # terminal-fit error at train time; an explicit value pins it.
        self._width_arg = width
        horizon = float(equation.T) - float(getattr(equation, "t0", 0.0))
        self._width_unit = (max(equation.dim, 1) * sig**2 * horizon) ** 0.5

    # -- training ---------------------------------------------------------
    def GPsolver(self, x_t_domain, x_t_boundary, GN_steps: int | None = None,
                 key: jax.Array | None = None):
        x_dom = jnp.asarray(x_t_domain, jnp.float32)
        if self.terminal_backend == "mixture":
            self._fit_mixture(x_dom)
        else:
            self._fit_rbf(x_dom, jnp.asarray(x_t_boundary, jnp.float32), key)
        return self.predict(x_dom)

    def _fit_mixture(self, x_dom):
        """Exact Bernstein terminal mixture — no data fit at all:
        1/(a + b q) = (1/a) int e^{-t} e^{-(b/a) t q} dt, discretized by
        the composite log-panel rule (:func:`bernstein_panel_nodes`, which
        resolves the evolved integrand's 1/(d sig2 tau) concentration at
        any d — plain Gauss-Laguerre degrades past d ~ 100)."""
        a, b = map(float, self.equation.terminal_bernstein())
        t, w = bernstein_panel_nodes(1.0)
        weights = jnp.asarray(w / a, jnp.float32)
        rates = jnp.asarray((b / a) * t, jnp.float32)
        d = self.d
        self.state = GPState(
            x_dom=x_dom,
            # centers are all at the origin; keep a (1, d+1) placeholder so
            # the GPState pytree stays well-formed for serve checkpoints
            x_bdy=jnp.zeros((1, d + 1), jnp.float32),
            right_vector=weights,
            sol=rates,
            gamma=jnp.asarray([self.lam, a, b], jnp.float32),
            loss_history=jnp.zeros((1,), jnp.float32),  # exact representation
        )

    def _fit_rbf(self, x_dom, x_bdy, key):
        """Scattered constant-mean RBF terminal interpolant (one m x m
        Cholesky), centers pushed to the terminal surface along each
        point's diffusion cone — the gp/cole_hopf.py construction."""
        if key is None:
            key = jax.random.PRNGKey(0)
        eq = self.equation
        x_all = jnp.concatenate([x_dom, x_bdy], axis=0)
        xs, tt = x_all[:, :-1], x_all[:, -1]
        spread = jnp.sqrt(self.sig2 * jnp.maximum(float(eq.T) - tt, 0.0))
        y = xs + spread[:, None] * jax.random.normal(
            key, xs.shape, dtype=xs.dtype
        )
        m = y.shape[0]
        y_t = jnp.concatenate(
            [y, jnp.full((m, 1), float(eq.T), dtype=y.dtype)], axis=1
        )
        g_T = eq.g(y_t)[:, 0].astype(jnp.float32)
        mbar = jnp.mean(g_T)
        d2 = sq_dists(y, y)
        width = (
            float(self._width_arg) if self._width_arg is not None
            else self._select_width(d2, g_T, mbar)
        )
        K = jnp.exp(-d2 / (2.0 * width**2))
        L = jnp.linalg.cholesky(
            K + self.fit_nugget * jnp.eye(m, dtype=K.dtype)
        )
        alpha = jax.scipy.linalg.cho_solve((L, True), g_T - mbar)
        fit_rms = jnp.sqrt(jnp.mean((mbar + K @ alpha - g_T) ** 2))
        self.state = GPState(
            x_dom=x_dom,
            x_bdy=y_t,
            right_vector=alpha,
            sol=g_T,
            gamma=jnp.asarray([width, mbar, self.lam], jnp.float32),
            loss_history=fit_rms[None],
        )

    def _select_width(self, d2, g_T, mbar, frac: float = 0.2,
                      seed: int = 0) -> float:
        """Pick the kernel width from a beta grid by held-out terminal-fit
        RMS: fit on (1-frac) of the centers, score the rest.  The held-out
        interpolation error tracks the true evolved-field error (both
        minimize at beta = 0.7 at d = 20 and d = 100; measured in
        reports/allen_cahn_attribution.md)."""
        m = g_T.shape[0]
        nv = max(1, int(m * frac))
        perm = jax.random.permutation(jax.random.PRNGKey(seed), m)
        vi, ti = perm[:nv], perm[nv:]
        Ktt_d2 = d2[ti][:, ti]
        Kvt_d2 = d2[vi][:, ti]
        g_t, g_v = g_T[ti] - mbar, g_T[vi] - mbar
        eye = jnp.eye(ti.shape[0], dtype=jnp.float32)

        @jax.jit
        def score(width):
            Ktt = jnp.exp(-Ktt_d2 / (2.0 * width**2))
            al = jnp.linalg.solve(Ktt + self.fit_nugget * eye, g_t)
            pred = jnp.exp(-Kvt_d2 / (2.0 * width**2)) @ al
            return jnp.sqrt(jnp.mean((pred - g_v) ** 2))

        best_w, best_s = None, None
        for beta in _BETA_GRID:
            width = beta * self._width_unit
            s = float(score(jnp.float32(width)))
            if best_s is None or s < best_s:
                best_w, best_s = width, s
        return best_w

    # -- posterior --------------------------------------------------------
    def _mixture_features(self, params: GPState, x, want_grad, want_ops):
        """See :func:`mixture_features` (shared with the Cole-Hopf HJB
        surrogate's mixture backend)."""
        return mixture_features(
            x, params.right_vector, params.sol, self.sig2,
            float(self.equation.T), self.d, want_grad, want_ops,
        )

    def _rbf_features(self, params: GPState, x, want_grad, want_ops):
        """Heat-evolved scattered interpolant via the shared bump algebra
        (gp/cole_hopf.py ``_v_block``)."""
        dim = self.d
        T = float(self.equation.T)

        def block(xc):
            return _v_block(
                xc, params.x_bdy[:, :-1], params.right_vector,
                params.gamma[0], params.gamma[1], self.sig2, T, dim,
                want_grad, want_ops,
            )

        n, chunk = x.shape[0], self.eval_chunk
        if chunk is None or n <= chunk:
            return block(x)
        pad = (-n) % chunk
        xp = jnp.pad(x, ((0, pad), (0, 0))).reshape(-1, chunk, x.shape[1])
        out = jax.lax.map(block, xp)
        return tuple(
            None if v is None else v.reshape((-1,) + v.shape[2:])[:n]
            for v in out
        )

    def posterior_u(self, params: GPState, x_t, want_grad: bool = False,
                    want_ops: bool = False) -> PosteriorOut:
        x = jnp.asarray(x_t, jnp.float32)
        need = want_grad or want_ops
        # want_grad needs the ops pass too: the time column of the
        # space-time gradient is u_t = -lam u - (sigma^2/2) Lap u (the exact
        # linear-PDE identity), and Lap comes from the ops pass.
        if self.terminal_backend == "mixture":
            V, grad_sp_V, dt_V, div_V, lap_V = self._mixture_features(
                params, x, need, need
            )
        else:
            V, grad_sp_V, dt_V, div_V, lap_V = self._rbf_features(
                params, x, need, need
            )
        lam = jnp.float32(self.lam)
        tau = jnp.maximum(float(self.equation.T) - x[:, -1], 0.0)
        amp = jnp.exp(lam * tau)
        u = amp * V
        grad = None
        dt_u = div_u = lap_u = None
        if need:
            # d/dt = -d/dtau:  u_t = -lam e^{lam tau} V + e^{lam tau} V_t,
            # V_t = -(sigma^2/2) Lap V  (exact: V solves the heat equation)
            dt_u_val = -lam * u + amp * dt_V
            lap_u_val = amp * lap_V
        if want_grad:
            gsp_u = amp[:, None] * grad_sp_V
            grad = jnp.concatenate([gsp_u, dt_u_val[:, None]], axis=1)
        if want_ops:
            dt_u = dt_u_val
            div_u = amp * div_V
            lap_u = lap_u_val
        return PosteriorOut(u=u, grad=grad, dt_u=dt_u, div_u=div_u,
                            lap_u=lap_u)

    # residual_u: inherited from GP — posterior_u(want_ops=True) +
    # AllenCahnForm.residual, which collapses to exactly -u^3 here
    # (dt_u + (sigma^2/2) lap_u = -lam u identically), i.e. the dropped
    # cubic term, closed-form.  tests/test_semigroup.py asserts both the
    # autodiff agreement and the -u^3 identity.
