"""Closed-form space-time RBF derivative kernel algebra.

The reference builds every Gram/cross-kernel block by nesting ``jax.grad``
per point pair and estimating Laplacians with a frozen-subset Hutchinson
estimator (reference ``models/GP.py:28-179``).  Here every operator block has
an exact closed form, expressed as an elementwise polynomial (in four pair
statistics) times the base kernel.

The kernel family is a RIDGE-AUGMENTED separable space/time RBF (a strict
generalization of the reference's isotropic kernel, models/GP.py:25,41-43):

    kappa(x, y) = exp(-(gs*q + gr*s^2 + gt*dt^2) / 2)

with, for delta = x - y:
    q  = |delta_spatial|^2        (squared spatial distance)
    s  = sum_i delta_i            (spatial-sum difference — the "ridge" axis)
    dt = delta_time

i.e. a Gaussian with spatial precision  Sigma^{-1} = gs*I + gr*11^T  and time
precision gt.  (gs, gt, gr) = (g, g, 0) is EXACTLY the reference kernel.  The
ridge term matters at large d: by concentration of measure the isotropic
kernel cannot resolve variation along the mean direction 1/sqrt(d), and the
reference's GP demonstrably underfits there (see reports/RESULTS.md).

Every block D_x^a D_y^b kappa for a, b in {ID, LAP (spatial Laplacian),
DT (time derivative), DIV (spatial divergence)} is poly(q, s, dt) * kappa.
The statistics come from ONE x @ y^T matmul plus rank-1 terms, so a
whole Gram tile is a matmul followed by fused elementwise math — no autodiff,
no Hutchinson bias, O(1) kernel evals per pair.

Derivation sketch (all identities verified against jax.grad in
tests/test_kernels.py). With w_i = gs*delta_i + gr*s (the i-th spatial
log-derivative), G = gs + d*gr, V = gs^2 q + 2 gs gr s^2 + d gr^2 s^2,
LAPF = V - d(gs + gr), beta = 2 gs gr + d gr^2:

    d kappa/dx_i     = -w_i kappa            Div_x kappa = -G s kappa
    Lap_x kappa      = LAPF kappa
    Div_x Div_y      = G (d - G s^2) kappa
    Div_x Lap_y      = G s (2G - LAPF) kappa
    Lap_x Lap_y      = [2d(gs^2+beta) - 4 gs^3 q - 4 s^2 (gs^2 gr + beta G)
                        + LAPF^2] kappa
    DT_x DT_y        = gt (1 - gt dt^2) kappa
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# y-side feature operators defining phi, in the reference's column order
# (reference models/GP.py:251-258): [ID@dom, ID@bdy, LAP@dom, DT@dom, DIV@dom].
ID, LAP, DT, DIV = "id", "lap", "dt", "div"
PHI_OPS = (ID, ID, LAP, DT, DIV)          # operator per phi block
PHI_SETS = ("dom", "bdy", "dom", "dom", "dom")  # source point set per phi block


def split_gamma(gamma) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Normalize gamma to (gs, gt, gr): accepts a scalar (isotropic,
    reference semantics), a length-2 [gs, gt], or a length-3 [gs, gt, gr]."""
    g = jnp.atleast_1d(jnp.asarray(gamma, jnp.float32))
    if g.shape[0] == 1:
        return g[0], g[0], jnp.zeros((), jnp.float32)
    if g.shape[0] == 2:
        return g[0], g[1], jnp.zeros((), jnp.float32)
    return g[0], g[1], g[2]


class PairStats(NamedTuple):
    """Pairwise statistics between rows of x (n, d+1) and y (m, d+1)."""

    kappa: jax.Array  # (n, m) base kernel values
    q: jax.Array      # (n, m) squared spatial distance
    s: jax.Array      # (n, m) sum of spatial differences
    dt: jax.Array     # (n, m) time difference x_t - y_t


def pair_stats(
    x: jax.Array, y: jax.Array, gamma, operand_dtype=jnp.float32
) -> PairStats:
    """Compute pair statistics via one matmul with fp32 accumulation.

    ``operand_dtype=bfloat16`` (PrecisionPolicy.gram) feeds the O(n*m*d)
    distance matmul bf16 operands — half the operand traffic — while
    accumulating in fp32.  The norms use the SAME
    rounded values so r2 stays consistent (and >= 0 up to fp32 round-off);
    all elementwise kernel math is fp32.
    """
    gs, gt, gr = split_gamma(gamma)
    xo = x.astype(operand_dtype)
    yo = y.astype(operand_dtype)
    x = xo.astype(jnp.float32)
    y = yo.astype(jnp.float32)
    # Full space-time squared distance via |x|^2 + |y|^2 - 2 x.y.  The sum
    # cancels for nearby points, so the product must be true fp32: at the
    # default precision a GPU may round fp32 operands to TF32's 10-bit
    # mantissa, which moved the d=20 Gram by 5e-4 (equilibrated; fp32 lands
    # near 4e-7) and broke the flagship's accuracy.
    xy = jax.lax.dot_general(
        xo, yo, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    r2 = (
        jnp.sum(x * x, axis=1)[:, None]
        + jnp.sum(y * y, axis=1)[None, :]
        - 2.0 * xy
    )
    r2 = jnp.maximum(r2, 0.0)
    dt = x[:, -1][:, None] - y[:, -1][None, :]
    s = jnp.sum(x[:, :-1], axis=1)[:, None] - jnp.sum(y[:, :-1], axis=1)[None, :]
    q = jnp.maximum(r2 - dt * dt, 0.0)
    kappa = jnp.exp(-0.5 * (gs * q + gr * s * s + gt * dt * dt))
    return PairStats(kappa=kappa, q=q, s=s, dt=dt)


def sq_dists(x: jax.Array, y: jax.Array) -> jax.Array:
    """|x_i - y_j|^2 for the rows of x (n, k) and y (m, k), clamped at 0.

    Computed as |x|^2 + |y|^2 - 2 x.y with a true-fp32 product, for the
    reason given in :func:`pair_stats`."""
    xy = jax.lax.dot_general(
        x, y, (((1,), (1,)), ((), ())), precision=jax.lax.Precision.HIGHEST,
    )
    d2 = jnp.sum(x * x, axis=1)[:, None] + jnp.sum(y * y, axis=1)[None, :]
    return jnp.maximum(d2 - 2.0 * xy, 0.0)


def _aux(gamma, d: int):
    """Shared scalar combinations (G, beta) of the gamma components."""
    gs, gt, gr = split_gamma(gamma)
    G = gs + d * gr
    beta = 2.0 * gs * gr + d * gr * gr
    return gs, gt, gr, G, beta


def _lapf(st: PairStats, gs, gr, G, beta, d):
    """One-sided spatial Laplacian factor: Lap_x kappa = LAPF * kappa."""
    V = gs * gs * st.q + (2.0 * gs * gr + d * gr * gr) * st.s * st.s
    return V - d * (gs + gr)


def op_block(a: str, b: str, st: PairStats, gamma, d: int) -> jax.Array:
    """The (n, m) matrix of (D_x^a D_y^b kappa)(x_i, y_j).

    Closed forms replace the reference's per-pair autodiff blocks
    (reference models/GP.py:55-179 and the vmapped maps at :196-248).
    """
    gs, gt, gr, G, beta = _aux(gamma, d)
    k, q, s, dt = st.kappa, st.q, st.s, st.dt
    lapf = _lapf(st, gs, gr, G, beta, d)

    key = (a, b)
    if key == (ID, ID):
        return k
    if key in ((ID, LAP), (LAP, ID)):
        return lapf * k
    if key == (ID, DT):
        return gt * dt * k
    if key == (DT, ID):
        return -gt * dt * k
    if key == (ID, DIV):
        return G * s * k
    if key == (DIV, ID):
        return -G * s * k
    if key == (DT, DT):
        return gt * (1.0 - gt * dt * dt) * k
    if key in ((DT, DIV), (DIV, DT)):
        return -G * gt * s * dt * k
    if key == (DIV, DIV):
        return G * (d - G * s * s) * k
    if key == (LAP, DT):
        return gt * dt * lapf * k
    if key == (DT, LAP):
        return -gt * dt * lapf * k
    if key == (DIV, LAP):
        return G * s * (2.0 * G - lapf) * k
    if key == (LAP, DIV):
        return -G * s * (2.0 * G - lapf) * k
    if key == (LAP, LAP):
        return (
            2.0 * d * (gs * gs + beta)
            - 4.0 * gs**3 * q
            - 4.0 * s * s * (gs * gs * gr + beta * G)
            + lapf * lapf
        ) * k
    raise ValueError(f"unknown operator pair {key}")


class GradCoeffs(NamedTuple):
    """Coefficients of grad_x (D_y^b kappa) in the basis
    {delta_spatial, s * 1_sp, ones_spatial, dt * e_t, e_t}:

        grad_x (D_y^b kappa)(x, y) = a_sp * (x - y)|_sp + b_s * s * 1_sp
                                     + c * 1_sp + a_t * dt * e_t + e * e_t

    Each coefficient is an (n, m) array.  This basis turns the posterior
    gradient into matmuls (a_sp against Y_spatial) plus row reductions —
    the b_s * s and c terms collapse into per-row scalars.
    """

    a_sp: jax.Array
    b_s: jax.Array
    c: jax.Array
    a_t: jax.Array
    e: jax.Array


def grad_coeffs(b: str, st: PairStats, gamma, d: int) -> GradCoeffs:
    """Coefficients of the x-gradient of the y-side family ``b``."""
    gs, gt, gr, G, beta = _aux(gamma, d)
    k, q, s, dt = st.kappa, st.q, st.s, st.dt
    lapf = _lapf(st, gs, gr, G, beta, d)
    zero = jnp.zeros_like(k)
    if b == ID:
        return GradCoeffs(a_sp=-gs * k, b_s=-gr * k, c=zero, a_t=-gt * k,
                          e=zero)
    if b == LAP:
        return GradCoeffs(
            a_sp=(2.0 * gs * gs - gs * lapf) * k,
            b_s=(2.0 * beta - gr * lapf) * k,
            c=zero,
            a_t=-gt * lapf * k,
            e=zero,
        )
    if b == DT:
        return GradCoeffs(
            a_sp=-gs * gt * dt * k,
            b_s=-gr * gt * dt * k,
            c=zero,
            a_t=-gt * gt * dt * k,
            e=gt * k,
        )
    if b == DIV:
        return GradCoeffs(
            a_sp=-G * gs * s * k,
            b_s=-G * gr * s * k,
            c=G * k,
            a_t=-G * gt * s * k,
            e=zero,
        )
    raise ValueError(f"unknown family {b}")


def kernel_gamma(eq_sigma: float, dim: int) -> float:
    """Isotropic gamma = 1/sigma_k^2 with sigma_k = eq.sigma()*sqrt(d)
    (reference models/GP.py:25)."""
    return 1.0 / (eq_sigma * eq_sigma * dim)


def kernel_gammas(
    eq_sigma: float, dim: int, time_scale: float = 1.0, ridge_scale: float = 0.0
):
    """(gs, gt, gr) for the ridge-augmented separable kernel.

    sigma_t = time_scale * sigma_k; gr = ridge_scale * gs / d, i.e. the
    effective precision along the mean direction is gs * (1 + ridge_scale).
    Defaults reproduce the reference's isotropic kernel exactly.
    """
    gs = kernel_gamma(eq_sigma, dim)
    gt = gs / (time_scale * time_scale)
    gr = ridge_scale * gs / dim
    return (gs, gt, gr)
