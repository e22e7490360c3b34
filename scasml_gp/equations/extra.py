"""Stretch PDE families beyond the reference (BASELINE.json config 5).

The reference implements a single PDE family; these two standard
high-dimensional benchmarks exercise the same ``Equation`` protocol so the
Picard solvers work on them unchanged.  HJB admits a Cole-Hopf Monte-Carlo
"exact" solution; Allen-Cahn has no closed form (its ``exact_solution`` is a
high-accuracy multilevel-Picard reference computed on demand).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from scasml_gp.equations.base import Equation


class HJB(Equation):
    """Hamilton-Jacobi-Bellman: u_t + Lap u - |grad u|^2 = 0 on [0,T],
    u(x,T) = ln((1 + |x|^2)/2). Exact solution via Cole-Hopf:
    u(t,x) = -ln E[exp(-g(x + sqrt(2) W_{T-t}))]."""

    def __init__(self, n_input: int, n_output: int = 1):
        super().__init__(n_input, n_output)
        # -|grad u|^2 is gradient-quadratic: the raw z estimator's variance
        # enters the MEAN of f, so centered estimators are essential
        self.center_z = True
        self.time_sampling = "sqrt"
        self.terminal_z = "corrected"
        # With a converged surrogate the ScaSML correction is pure MC noise
        # and the gradient-quadratic f turns it into BIAS (reports/RESULTS.md
        # d=250: GP 0.161 -> ScaSML 0.204).  The James-Stein variance guard
        # (picard/scasml.py) shrinks/abstains in that regime.
        self.variance_guard = True
        # Sample-base auto-escalation (picard/scasml.py u_solve): at the
        # flagless M = 3 the full-history correction is noise-dominated and
        # the guard abstains (SCaSML == GP == 0.122 at d=100), but the
        # measured repair regime lives at M = 6..15 (SimpleScaling: rel-L2
        # 0.031-0.065).  Let the guard's own probe escalate M = 3 -> 6 -> 12
        # until the correction is signal-dominated (lambda >= 0.5) or the
        # cap is hit (then the abstention stands).
        self.escalate_M = True
        self.escalate_M_accept = 0.5
        self.escalate_M_max = 12
        # |u| grows like ln(|x|^2) ~ ln(d) on the diffusion-reachable set
        # (g = ln((1+|x|^2)/2), E|x+sigma W|^2 ~ d), so the output clips must
        # scale with dimension or they truncate the true solution at d >~ 50
        d = n_input - 1
        self.norm_estimation = 1.0 + math.log1p(d)
        self.uncertainty = 0.25 * self.norm_estimation
        # g(x) is the TERMINAL condition only (no lateral closed form), so
        # the GP's boundary collocation rows live on the t = T surface.
        self.boundary_mode = "terminal"

    def sigma(self, x_t=0):
        return math.sqrt(2.0)

    def mu(self, x_t=0):
        return 0.0

    def f(self, x_t, u, z):
        # -|grad u|^2 = -|z|^2 / sigma^2 with z = sigma * grad u
        return -jnp.sum(z * z, axis=1, keepdims=True) / self.sigma() ** 2

    def terminal_constraint(self, x_t):
        x = x_t[:, :-1]
        return jnp.log(0.5 * (1.0 + jnp.sum(x * x, axis=1)))[:, None]

    def terminal_bernstein_v(self):
        """(a, b) of the log-rational terminal form g = ln((1 + b|x|^2)/a):
        the Cole-Hopf transformed terminal v_T = e^{-k g} = a^k (1+b q)^{-k}
        is completely monotone in q = |x|^2, so Bernstein's theorem gives
        the exact Gaussian mixture
            (1+bq)^{-k} = (1/Gamma(k)) int t^{k-1} e^{-t} e^{-t b q} dt,
        which the Cole-Hopf surrogate (gp/cole_hopf.py) discretizes by
        generalized Gauss-Laguerre and evolves in closed form."""
        return (2.0, 1.0)

    def exact_solution(self, x_t, key=None, num_mc: int = 32768,
                       mc_chunk: int = 512):
        """Cole-Hopf MC: u = -ln E[exp(-g(x + sqrt(2) W_{T-t}))].

        The expectation is accumulated over ``mc_chunk``-sample slices with a
        running max for the log-mean-exp, so the peak buffer is
        (n, mc_chunk, d) instead of (n, num_mc, d) — at d=250 the unchunked
        version would materialize gigabytes."""
        if key is None:
            key = jax.random.PRNGKey(7)
        x = x_t[:, :-1]
        t = x_t[:, -1]
        dt = jnp.maximum(self.T - t, 0.0)
        scale = jnp.sqrt(2.0 * dt)[:, None, None]
        n_chunks = max(1, -(-num_mc // mc_chunk))

        def body(carry, ck):
            m, acc = carry
            w = jax.random.normal(
                ck, (x.shape[0], mc_chunk, self.dim), dtype=x.dtype
            )
            xs = x[:, None, :] + scale * w
            neg_g = -jnp.log(0.5 * (1.0 + jnp.sum(xs * xs, axis=2)))
            m_new = jnp.maximum(m, jnp.max(neg_g, axis=1))
            acc = acc * jnp.exp(m - m_new) + jnp.sum(
                jnp.exp(neg_g - m_new[:, None]), axis=1
            )
            return (m_new, acc), None

        init = (jnp.full((x.shape[0],), -jnp.inf, x.dtype),
                jnp.zeros((x.shape[0],), x.dtype))
        keys = jax.random.split(key, n_chunks)
        (m, acc), _ = jax.lax.scan(body, init, keys)
        lme = jnp.log(acc / (n_chunks * mc_chunk)) + m
        return (-lme)[:, None]


class SineNonlinear(Equation):
    """Semilinear sine benchmark with a manufactured closed-form solution
    (new family beyond the reference; same protocol as the reference's
    ``Grad_Dependent_Nonlinear``, equations/equations.py:232-417).

    PDE (framework convention, base.py:82):

        u_t + mu * sum_i u_xi + (sigma^2/2) Lap u + f(x_t, u, sigma grad u) = 0

    with  f(x_t, u, z) = sin(u) + (1/d) sum_i z_i + R(x_t),
          mu = -1/(2d),  sigma = 0.25,
    on [-0.5, 0.5]^d x [0, 0.5].  The forcing R is chosen so that

        u*(x, t) = sin(s),   s = t + (1/d) sum_i x_i

    solves the PDE exactly; unlike every other implemented family, f has an
    EXPLICIT x_t dependence, which exercises the rhs_f path of the GP
    collocation form (reference models/GP.py:700-702, identically zero
    there) and the x_t argument of the Picard generator.  The sin(u)
    nonlinearity is globally Lipschitz, the classical well-posedness case
    of the multilevel-Picard convergence theory.
    """

    def __init__(self, n_input: int, n_output: int = 1):
        super().__init__(n_input, n_output)
        # |u*| <= 1; clip with headroom (reference norm_estimation semantics,
        # equations/equations.py:246)
        self.norm_estimation = 2.0
        self.uncertainty = 1e-1

    def sigma(self, x_t=0):
        return 0.25

    def mu(self, x_t=0):
        return -0.5 / self.dim

    def _phase(self, x_t: jax.Array) -> jax.Array:
        """s = t + (1/d) sum_i x_i, shape (batch,)."""
        return x_t[:, -1] + jnp.mean(x_t[:, :-1], axis=1)

    def forcing(self, x_t: jax.Array) -> jax.Array:
        """R(x_t), shape (batch,): the manufactured source that makes
        u* = sin(s) exact.  Derived from the PDE with
        u*_t = cos s, sum_i u*_xi = cos s, Lap u* = -sin(s)/d,
        z* = (sigma/d) cos(s) per coordinate:

            R = -(1 + mu + sigma/d) cos s + (sigma^2/(2d)) sin s - sin(sin s)
        """
        s = self._phase(x_t)
        sig, mu, d = self.sigma(), self.mu(), self.dim
        return (
            -(1.0 + mu + sig / d) * jnp.cos(s)
            + (sig**2 / (2.0 * d)) * jnp.sin(s)
            - jnp.sin(jnp.sin(s))
        )

    def f(self, x_t, u, z):
        return (
            jnp.sin(u)
            + jnp.mean(z, axis=1, keepdims=True)
            + self.forcing(x_t)[:, None]
        )

    def terminal_constraint(self, x_t):
        # exact solution holds at any (x, t): lateral boundary_mode is valid,
        # matching the reference family's semantics (equations.py:249-261)
        return self.exact_solution(x_t)

    def exact_solution(self, x_t):
        return jnp.sin(self._phase(x_t))[:, None]

    def exact_solution_derivative(self, x_t):
        s = self._phase(x_t)
        return jnp.broadcast_to(
            (jnp.cos(s) / self.dim)[:, None], (x_t.shape[0], self.dim)
        )


class AllenCahn(Equation):
    """Allen-Cahn: u_t + Lap u + u - u^3 = 0, u(x,T) = 1/(2 + 0.4 |x|^2)."""

    def __init__(self, n_input: int, n_output: int = 1):
        super().__init__(n_input, n_output)
        self.T = 0.3
        self.uncertainty = 5e-1
        self.norm_estimation = 2.0
        self.boundary_mode = "terminal"  # u = g holds exactly only at t = T

    def sigma(self, x_t=0):
        return math.sqrt(2.0)

    def mu(self, x_t=0):
        return 0.0

    def f(self, x_t, u, z):
        return u - u**3

    def terminal_constraint(self, x_t):
        x = x_t[:, :-1]
        return (1.0 / (2.0 + 0.4 * jnp.sum(x * x, axis=1)))[:, None]

    def terminal_bernstein(self):
        """(a, b) of the completely-monotone radial terminal form
        g = 1/(a + b |x|^2): by Bernstein's theorem g is an exact mixture
        of origin-centered Gaussians, which the semigroup surrogate
        (gp/semigroup.py) evolves in closed form at any dimension."""
        return (2.0, 0.4)

    def exact_solution(self, x_t):
        raise NotImplementedError(
            "Allen-Cahn has no closed form; use a high-level Picard run as the "
            "reference (harness.metrics.mc_reference_solution)."
        )
