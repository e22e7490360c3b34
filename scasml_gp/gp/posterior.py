"""Fused GP posterior evaluation: mean, gradient and PDE-operator features.

This is the #1 hot path of the whole framework: ScaSML evaluates the GP
posterior (and its gradient / PDE residual) at every node of the Picard
sample tree (reference ``solvers/ScaSML.py:29-63,274-280``; SURVEY.md §3.4).
The reference computes these with three separate nested-vmap autodiff passes
(``predict``, ``compute_gradient``, ``compute_PDE_loss``, models/GP.py:
653-687,746-769), re-materializing the (N_infer x phi_dim) kernel matrix each
time.

Design: all five phi families and all their x-side derivatives are
elementwise polynomials (in the pair statistics q, s, dt) times the base RBF
(see :mod:`scasml_gp.gp.kernels`).  Folding the representer weights into
the polynomial coefficients turns each output into

    out(x_i) = rowsum( kappa(x_i, Y) * P(q, s, dt; r) )   (+ matmul terms for
                                                            the gradient)

so one pass computes u, grad u, dt_u, div_u and lap_u with ONE kappa
evaluation per (x, y) pair, one (n,m)@(m,d+1) matmul for the gradient,
and XLA-fused elementwise math for everything else.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from scasml_gp.gp.kernels import pair_stats, split_gamma


class PosteriorOut(NamedTuple):
    u: jax.Array                # (n,)
    grad: Optional[jax.Array]   # (n, d+1) full space-time gradient, or None
    dt_u: Optional[jax.Array]   # (n,) time derivative, or None
    div_u: Optional[jax.Array]  # (n,) spatial divergence, or None
    lap_u: Optional[jax.Array]  # (n,) spatial Laplacian, or None


def _split_r(r: jax.Array, n_dom: int, n_bdy: int):
    """Split representer weights by phi block (order: models/GP.py:251-258)."""
    r1 = r[:n_dom]
    r2 = r[n_dom : n_dom + n_bdy]
    r3 = r[n_dom + n_bdy : 2 * n_dom + n_bdy]
    r4 = r[2 * n_dom + n_bdy : 3 * n_dom + n_bdy]
    r5 = r[3 * n_dom + n_bdy :]
    return r1, r2, r3, r4, r5


@partial(
    jax.jit,
    static_argnames=(
        "dim", "want_grad", "want_ops", "operand_dtype", "shard_dom"
    ),
)
def _posterior_block(
    x: jax.Array,
    x_dom: jax.Array,
    x_bdy: jax.Array,
    r: jax.Array,
    gamma: jax.Array,
    dim: int,
    want_grad: bool,
    want_ops: bool,
    operand_dtype: str = "float32",
    shard_dom=None,
) -> PosteriorOut:
    """Single-pass posterior for one block of evaluation points x (n, d+1).

    ``operand_dtype`` is PrecisionPolicy.gram: 'bfloat16' feeds the
    O(n*N*d) cross-distance matmuls bf16 operands with fp32 accumulation —
    the posterior is the memory-bound #1 hot path, so halving the operand
    traffic of the pair-statistics matmul is where the policy pays most.
    All elementwise kernel math and every reduction stay fp32.

    ``shard_dom`` (a hashable ``NamedSharding`` over the mesh's 'model'
    axis, or None) distributes the contraction over the TRAINING set
    (VERDICT round-2 #4, SURVEY §2 G6/X2): constraining x_dom row-sharded
    makes GSPMD partition every (n, N) pair intermediate — and the r-block
    vectors broadcast against them — to (n, N/P) per device, with the row
    reductions and gradient matmuls lowered to per-shard partials plus one
    psum over 'model'.  Per-device posterior buffers are then ~1/P of the
    replicated path; the (phi,)-sized weights stay replicated (KBs).
    """
    gs, gt, gr = split_gamma(gamma)
    d = dim
    G = gs + d * gr
    beta = 2.0 * gs * gr + d * gr * gr
    n_dom = x_dom.shape[0]
    n_bdy = x_bdy.shape[0]
    r1, r2, r3, r4, r5 = _split_r(r.astype(jnp.float32), n_dom, n_bdy)
    x = x.astype(jnp.float32)
    if shard_dom is not None:
        x_dom = jax.lax.with_sharding_constraint(x_dom, shard_dom)
        # shard the dom-indexed representer blocks consistently so XLA
        # partitions the broadcast products instead of re-gathering x_dom
        vec_sh = type(shard_dom)(shard_dom.mesh, jax.sharding.PartitionSpec(
            shard_dom.spec[0]))
        r1, r3, r4, r5 = (
            jax.lax.with_sharding_constraint(v, vec_sh)
            for v in (r1, r3, r4, r5)
        )

    od = jnp.dtype(operand_dtype)
    st = pair_stats(x, x_dom, gamma, od)   # (n, N) stats vs interior set
    stb = pair_stats(x, x_bdy, gamma, od)  # (n, Nb) stats vs boundary set
    k, q, s, dt = st.kappa, st.q, st.s, st.dt
    kb, sb, dtb = stb.kappa, stb.s, stb.dt
    lapf = gs * gs * q + beta * s * s - d * (gs + gr)  # Lap_x kappa / kappa

    # -- posterior mean: u = sum_j kappa * (r1 + lapf r3 + gt dt r4 + G s r5)
    P_u = (
        r1[None, :] + lapf * r3[None, :]
        + gt * dt * r4[None, :] + G * s * r5[None, :]
    )
    u = jnp.sum(k * P_u, axis=1) + kb @ r2

    grad = None
    if want_grad:
        # grad_x of each family in the basis
        # {delta_sp, s 1_sp, 1_sp, dt e_t, e_t} (kernels.grad_coeffs) with
        # weights folded in.  Every family's coefficient along each gamma
        # component is -(component) * its mean integrand, plus the LAP
        # family's second-derivative extras (2 gs^2 / 2 beta).
        A_sp = -gs * k * P_u + 2.0 * gs * gs * k * r3[None, :]
        B_s = -gr * k * P_u + 2.0 * beta * k * r3[None, :]
        A_t = -gt * k * P_u
        C = G * k * r5[None, :]
        E = gt * k * r4[None, :]
        Ab_sp = -gs * kb * r2[None, :]
        Bb_s = -gr * kb * r2[None, :]
        Ab_t = -gt * kb * r2[None, :]

        rs_sp = jnp.sum(A_sp, axis=1) + jnp.sum(Ab_sp, axis=1)   # (n,)
        # The gradient's products are pinned to true fp32: with TF32
        # operands they moved the d=100 gradient by 1.1e-4 of its scale
        # (fp32: 1.4e-6).
        AY_sp = jax.lax.dot_general(
            A_sp, x_dom[:, :-1], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ) + jax.lax.dot_general(
            Ab_sp, x_bdy[:, :-1], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        # b_s * s and c terms both collapse to per-row scalars on 1_sp
        c_row = (
            jnp.sum(C, axis=1)
            + jnp.sum(B_s * s, axis=1)
            + jnp.sum(Bb_s * sb, axis=1)
        )
        grad_sp = x[:, :-1] * rs_sp[:, None] - AY_sp + c_row[:, None]
        rs_t = jnp.sum(A_t, axis=1) + jnp.sum(Ab_t, axis=1)
        hi = jax.lax.Precision.HIGHEST
        aty = (jnp.dot(A_t, x_dom[:, -1], precision=hi)
               + jnp.dot(Ab_t, x_bdy[:, -1], precision=hi))
        grad_t = x[:, -1] * rs_t - aty + jnp.sum(E, axis=1)
        grad = jnp.concatenate([grad_sp, grad_t[:, None]], axis=1)

    dt_u = div_u = lap_u = None
    if want_ops:
        # Apply DT/DIV/LAP on the x side of every family (closed forms from
        # kernels.op_block, weights folded into the polynomials).
        P_dt = (
            -gt * dt * r1[None, :]
            - gt * dt * lapf * r3[None, :]
            + gt * (1.0 - gt * dt * dt) * r4[None, :]
            - G * gt * s * dt * r5[None, :]
        )
        dt_u = jnp.sum(k * P_dt, axis=1) + (-gt) * jnp.sum(
            kb * dtb * r2[None, :], axis=1
        )

        P_div = (
            -G * s * r1[None, :]
            + G * s * (2.0 * G - lapf) * r3[None, :]
            - G * gt * s * dt * r4[None, :]
            + G * (d - G * s * s) * r5[None, :]
        )
        div_u = jnp.sum(k * P_div, axis=1) + (-G) * jnp.sum(
            kb * sb * r2[None, :], axis=1
        )

        LL = (
            2.0 * d * (gs * gs + beta)
            - 4.0 * gs**3 * q
            - 4.0 * s * s * (gs * gs * gr + beta * G)
            + lapf * lapf
        )
        P_lap = (
            lapf * r1[None, :]
            + LL * r3[None, :]
            + gt * dt * lapf * r4[None, :]
            - G * s * (2.0 * G - lapf) * r5[None, :]
        )
        qb = stb.q
        lapfb = gs * gs * qb + beta * sb * sb - d * (gs + gr)
        lap_u = jnp.sum(k * P_lap, axis=1) + jnp.sum(
            kb * lapfb * r2[None, :], axis=1
        )

    return PosteriorOut(u=u, grad=grad, dt_u=dt_u, div_u=div_u, lap_u=lap_u)


def select_posterior_fn(backend: str, dim: int):
    """Pick the posterior implementation: 'xla' or 'auto' (the fused XLA
    path, the only one)."""
    if backend in ("xla", "auto"):
        return posterior_eval
    raise ValueError(f"unknown posterior backend {backend!r}")


@partial(
    jax.jit,
    static_argnames=(
        "dim", "want_grad", "want_ops", "chunk", "operand_dtype", "shard_dom"
    ),
)
def posterior_eval(
    x: jax.Array,
    x_dom: jax.Array,
    x_bdy: jax.Array,
    r: jax.Array,
    gamma,
    dim: int,
    want_grad: bool = False,
    want_ops: bool = False,
    chunk: Optional[int] = None,
    operand_dtype: str = "float32",
    shard_dom=None,
) -> PosteriorOut:
    """Fused posterior over x (n, d+1).

    ``chunk`` bounds the (chunk x N_train) intermediate size; when set, the
    batch is padded to a multiple and processed with ``lax.map`` (static
    shapes, single compiled body).  Jitted at THIS level so the chunked
    ``lax.map`` is cached by shape — executed eagerly, the fresh closure
    forced a recompile of the while-loop every call.
    """
    gamma = jnp.asarray(gamma, jnp.float32)
    n = x.shape[0]
    if chunk is None or n <= chunk:
        return _posterior_block(
            x, x_dom, x_bdy, r, gamma, dim, want_grad, want_ops,
            operand_dtype, shard_dom,
        )
    pad = (-n) % chunk
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    xp = xp.reshape(-1, chunk, x.shape[1])
    out = jax.lax.map(
        lambda xc: _posterior_block(
            xc, x_dom, x_bdy, r, gamma, dim, want_grad, want_ops,
            operand_dtype, shard_dom,
        ),
        xp,
    )
    def unchunk(v):
        if v is None:
            return None
        return v.reshape((-1,) + v.shape[2:])[:n]
    return PosteriorOut(*(unchunk(v) for v in out))
