"""Reference-parity kernel mode: the biased frozen-subset Hutchinson
Laplacian and the fp16 quantization points of the reference, in closed form.

The reference estimates every spatial Laplacian with Hutchinson's method over
a FROZEN subset of 5 coordinates drawn once from ``PRNGKey(0)``
(reference ``models/GP.py:28-39``):

    Lap f(x) ~= d * mean_{i in S} d^2 f / dx_i^2,   S = choice(key0, d, (5,))

and, additionally, every ``laplacian_*`` block CYCLICALLY ROLLS the point it
differentiates: ``laplacian_y_t_kappa`` splits ``y_t`` as ``t_y = y_t[0]``,
``y = y_t[1:]`` and evaluates ``kappa(x_t, concat(y, t_y))``
(models/GP.py:91-94,100-108) — but time is the LAST input column everywhere
else in the reference, so the Laplacian blocks are evaluated at a permuted
point ``roll(y_t, -1)`` against an UNPERMUTED ``x_t``, and (because the last
rolled slot is the true time) the "spatial" subset can include the time
coordinate.  Both quirks are biases, not estimator noise — with the frozen
key they are deterministic.

This module reproduces those exact semantics WITHOUT per-pair autodiff: every
biased block is still a polynomial in a handful of pair statistics times the
(isotropic) base kernel, so a Gram tile remains one matmul + fused
elementwise math.  Derivations are validated against a literal
nested-``jax.grad`` re-implementation of the reference operators in
``tests/test_parity.py``.

Notation (per pair, in the block's evaluation frame A = maybe-rolled x,
U = maybe-rolled y, delta = A - U, m = subset size, scale d/m folded in):

    kappa = exp(-gamma/2 |delta|^2)         (full d+1-coordinate distance)
    eps   = delta[d]                        (time-slot difference)
    t     = sum_{j<d} delta_j               (spatial-sum difference)
    Q     = (d/m) sum_{i in S} delta_i^2    (subset squared distance)
    P     = (d/m) sum_{i in S} delta_i      (subset sum difference)

Blocks (x-op, y-op) with LAPS = subset Laplacian (rolls its side):

    (ID,ID)      kappa
    (ID,DT)      gamma eps kappa                     (DT,ID)    -...
    (ID,DIV)     gamma t kappa                       (DIV,ID)   -...
    (ID,LAPS)    gamma (gamma Q - d) kappa           [y rolled]
    (LAPS,ID)    gamma (gamma Q - d) kappa           [x rolled]
    (DT,DT)      gamma (1 - gamma eps^2) kappa
    (DT,DIV)     -gamma^2 eps t kappa                (DIV,DT)   same
    (DIV,DIV)    gamma (d - gamma t^2) kappa
    (DT,LAPS)    -gamma^2 eps (gamma Q - d) kappa    [y rolled]
    (LAPS,DT)    +gamma^2 eps (gamma Q - d) kappa    [x rolled]
    (DIV,LAPS)   gamma^2 (2P + t d - gamma t Q) kappa  [y rolled]
    (LAPS,DIV)   gamma^2 (gamma t Q - 2P - t d) kappa  [x rolled]
    (LAPS,LAPS)  [g^4 Q^2 - (2d + 4d/m) g^3 Q + (d^2 + 2d^2/m) g^2] kappa
                 [BOTH rolled -> kappa and Q use delta = roll(x - y)]

The fp16 toggle reproduces the reference's quantization points: each Gram /
cross-kernel block cast to float16 before use (models/GP.py:43 and every
block's trailing ``.astype(jnp.float16)``), the factorization done as an
fp64 SVD pseudo-Cholesky with the nugget added to the SINGULAR VALUES
(models/GP.py:258-266 — i.e. |eigenvalue| + nugget, an extra abs-folding
regularizer when the biased Gram is indefinite).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from scasml_gp.gp.posterior import PosteriorOut, _split_r

ID, DT, DIV, LAPS = "id", "dt", "div", "laps"


def subset_indices(d: int, size: int = 5) -> Tuple[int, ...]:
    """The reference's frozen Hutchinson subset:
    ``random.choice(PRNGKey(0), d, shape=(size,), replace=False)``
    (models/GP.py:35). Returned as a host tuple (it is a compile-time
    constant — the whole point of the parity mode is that the subset never
    resamples)."""
    idx = jax.random.choice(
        jax.random.PRNGKey(0), d, shape=(size,), replace=False
    )
    return tuple(int(i) for i in np.asarray(idx))


def _roll(x: jax.Array) -> jax.Array:
    """The reference's accidental permutation: [x_1..x_d, x_0]
    (models/GP.py:91-94 splits index 0 off as 'time' although time is the
    last column)."""
    return jnp.roll(x, -1, axis=-1)


class ParityStats(NamedTuple):
    kappa: jax.Array  # (n, m)
    eps: jax.Array    # (n, m) time-slot difference
    t: jax.Array      # (n, m) spatial-sum difference
    Q: jax.Array      # (n, m) scaled subset squared distance
    P: jax.Array      # (n, m) scaled subset sum difference


def parity_pair_stats(
    A: jax.Array, U: jax.Array, gamma, subset: Tuple[int, ...], d: int
) -> ParityStats:
    """Pair statistics between rows of A and U (both (n, d+1), already in the
    block's evaluation frame)."""
    A = A.astype(jnp.float32)
    U = U.astype(jnp.float32)
    gamma = jnp.float32(gamma)
    scale = d / float(len(subset))
    idx = jnp.asarray(subset, jnp.int32)

    AU = jax.lax.dot_general(
        A, U, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    r2 = (
        jnp.sum(A * A, axis=1)[:, None]
        + jnp.sum(U * U, axis=1)[None, :]
        - 2.0 * AU
    )
    kappa = jnp.exp(-0.5 * gamma * jnp.maximum(r2, 0.0))
    eps = A[:, -1][:, None] - U[:, -1][None, :]
    t = jnp.sum(A[:, :-1], axis=1)[:, None] - jnp.sum(U[:, :-1], axis=1)[None, :]

    As = A[:, idx]
    Us = U[:, idx]
    q_sub = (
        jnp.sum(As * As, axis=1)[:, None]
        + jnp.sum(Us * Us, axis=1)[None, :]
        - 2.0
        * jax.lax.dot_general(
            As, Us, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    )
    Q = scale * jnp.maximum(q_sub, 0.0)
    P = scale * (jnp.sum(As, axis=1)[:, None] - jnp.sum(Us, axis=1)[None, :])
    return ParityStats(kappa=kappa, eps=eps, t=t, Q=Q, P=P)


def _frames(a: str, b: str, x: jax.Array, y: jax.Array):
    """Apply the reference's roll quirk: a LAPS operator rolls ITS side."""
    A = _roll(x) if a == LAPS else x
    U = _roll(y) if b == LAPS else y
    return A, U


def parity_block(
    a: str, b: str, x: jax.Array, y: jax.Array, gamma,
    subset: Tuple[int, ...], d: int,
) -> jax.Array:
    """The (n, m) biased block (D_x^a D_y^b kappa)(x_i, y_j) with reference
    semantics (subset Laplacian + roll)."""
    g = jnp.float32(gamma)
    m = float(len(subset))
    A, U = _frames(a, b, x, y)
    st = parity_pair_stats(A, U, g, subset, d)
    k, eps, t, Q, P = st

    key = (a, b)
    if key == (ID, ID):
        return k
    if key == (ID, DT):
        return g * eps * k
    if key == (DT, ID):
        return -g * eps * k
    if key == (ID, DIV):
        return g * t * k
    if key == (DIV, ID):
        return -g * t * k
    if key in ((ID, LAPS), (LAPS, ID)):
        return g * (g * Q - d) * k
    if key == (DT, DT):
        return g * (1.0 - g * eps * eps) * k
    if key in ((DT, DIV), (DIV, DT)):
        return -g * g * eps * t * k
    if key == (DIV, DIV):
        return g * (d - g * t * t) * k
    if key == (DT, LAPS):
        return -g * g * eps * (g * Q - d) * k
    if key == (LAPS, DT):
        return g * g * eps * (g * Q - d) * k
    if key == (DIV, LAPS):
        return g * g * (2.0 * P + t * d - g * t * Q) * k
    if key == (LAPS, DIV):
        return g * g * (g * t * Q - 2.0 * P - t * d) * k
    if key == (LAPS, LAPS):
        return (
            g**4 * Q * Q
            - (2.0 * d + 4.0 * d / m) * g**3 * Q
            + (d * d + 2.0 * d * d / m) * g * g
        ) * k
    raise ValueError(f"unknown operator pair {key}")


# phi order (reference models/GP.py:251-258): [ID@dom, ID@bdy, LAPS@dom,
# DT@dom, DIV@dom].
_PHI_OPS = (ID, ID, LAPS, DT, DIV)
_PHI_SETS = ("dom", "bdy", "dom", "dom", "dom")


def _maybe_fp16(block: jax.Array, fp16: bool) -> jax.Array:
    """The reference casts every block to float16 before assembly
    (models/GP.py:43 and each block's .astype(jnp.float16))."""
    return block.astype(jnp.float16).astype(jnp.float32) if fp16 else block


@partial(jax.jit, static_argnames=("subset", "dim", "fp16"))
def parity_gram_matrix(
    x_dom: jax.Array, x_bdy: jax.Array, gamma, subset: Tuple[int, ...],
    dim: int, fp16: bool = False,
) -> jax.Array:
    """The biased phi-phi Gram with reference semantics
    (models/GP.py:182-258). Symmetric despite the quirks: each transposed
    pair of blocks evaluates the same even polynomial of delta."""
    pts = {"dom": x_dom, "bdy": x_bdy}
    rows = []
    for a, sa in zip(_PHI_OPS, _PHI_SETS):
        row = [
            _maybe_fp16(
                parity_block(a, b, pts[sa], pts[sb], gamma, subset, dim), fp16
            )
            for b, sb in zip(_PHI_OPS, _PHI_SETS)
        ]
        rows.append(jnp.concatenate(row, axis=1))
    return jnp.concatenate(rows, axis=0)


def parity_factorization(
    K, nugget: float, fp16: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """HOST fp64 SVD pseudo-Cholesky, exactly the reference's
    (models/GP.py:258-266): K = U S V^T, L = U sqrt(S + nugget),
    K_pert = L L^T = U (S + nugget) U^T.  Returns (K_pert, C = K_pert^{-1})
    as fp32 numpy.  Run on host because the parity mode is an experiment
    instrument, not a hot path, and an in-graph SVD/eigh of a phi_dim^2
    operand is slow to compile.

    Note the abs-folding: for the (indefinite) biased Gram the SVD's singular
    values are |eigenvalues|, so negative modes are REFLECTED to positive
    rather than shifted — an extra regularizer the reference gets for free.
    """
    K64 = np.asarray(jax.device_get(K), np.float64)
    K64 = 0.5 * (K64 + K64.T)
    # SVD of a symmetric matrix == eigh up to signs; eigh is faster and the
    # singular values are the |eigenvalues|.
    lam, V = np.linalg.eigh(K64)
    S = np.abs(lam) + nugget
    L = V * np.sqrt(S)[None, :]
    if fp16:
        L = L.astype(np.float16).astype(np.float64)
        K_pert = L @ L.T
        C = np.linalg.inv(K_pert)
    else:
        K_pert = V * S[None, :] @ V.T
        C = (V / S[None, :]) @ V.T
    return K_pert.astype(np.float32), C.astype(np.float32)


@partial(
    jax.jit,
    static_argnames=("subset", "dim", "want_grad", "want_ops", "fp16"),
)
def _parity_posterior_block(
    x, x_dom, x_bdy, r, gamma, subset, dim, want_grad, want_ops, fp16
) -> PosteriorOut:
    """Posterior mean / gradient / PDE-operator features with the reference's
    biased cross-kernels (models/GP.py:270-411,630-651)."""
    g = jnp.float32(gamma)
    d = dim
    m = float(len(subset))
    n_dom = x_dom.shape[0]
    n_bdy = x_bdy.shape[0]
    r1, r2, r3, r4, r5 = _split_r(r.astype(jnp.float32), n_dom, n_bdy)
    x = x.astype(jnp.float32)

    def feat(a: str):
        """Row block of the x-op-a cross kernel against all five families."""
        cols = [
            parity_block(a, ID, x, x_dom, g, subset, d),
            parity_block(a, ID, x, x_bdy, g, subset, d),
            parity_block(a, LAPS, x, x_dom, g, subset, d),
            parity_block(a, DT, x, x_dom, g, subset, d),
            parity_block(a, DIV, x, x_dom, g, subset, d),
        ]
        return [_maybe_fp16(c, fp16) for c in cols]

    def contract(cols):
        c1, c2, c3, c4, c5 = cols
        return (
            c1 @ r1 + c2 @ r2 + c3 @ r3 + c4 @ r4 + c5 @ r5
        )

    u = contract(feat(ID))

    grad = None
    if want_grad:
        # grad_x of each y-family (reference dx_t_kernel_x_t_phi,
        # models/GP.py:296-323). Expressed in the same rank-1 basis as the
        # exact path: matmul against Y plus per-row scalars.
        st_d = parity_pair_stats(x, x_dom, g, subset, d)
        st_b = parity_pair_stats(x, x_bdy, g, subset, d)
        st_l = parity_pair_stats(x, _roll(x_dom), g, subset, d)

        # Weighted integrands W (n, N) per family; grad = sum_j W_ij *
        # grad-vector_ij. Families split into -gamma*delta*kappa "radial"
        # parts (matmul form) plus slot corrections.
        kd, kb, kl = st_d.kappa, st_b.kappa, st_l.kappa

        # radial coefficients: every family contributes
        # (family value) * (-gamma delta) plus family-specific extras.
        fam_id_d = kd * r1[None, :]
        fam_id_b = kb * r2[None, :]
        fam_dt = g * st_d.eps * kd * r4[None, :]
        fam_div = g * st_d.t * kd * r5[None, :]
        fam_lap = g * (g * st_l.Q - d) * kl * r3[None, :]

        idx = jnp.asarray(subset, jnp.int32)
        scale = d / m

        # -gamma * sum_j W_ij * delta_ij = -gamma * (x_i * rowsum(W) - W @ Y)
        def radial(W, Y):
            WY = jax.lax.dot_general(
                W, Y, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            return -g * (x * jnp.sum(W, axis=1)[:, None] - WY)

        grad = (
            radial(fam_id_d, x_dom)
            + radial(fam_id_b, x_bdy)
            + radial(fam_dt, x_dom)
            + radial(fam_div, x_dom)
            + radial(fam_lap, _roll(x_dom))
        )
        # DT family extra: + gamma * kappa on the time slot
        # (d/dx_k gamma eps kappa has + gamma kappa at k = d).
        grad = grad.at[:, -1].add(jnp.sum(g * kd * r4[None, :], axis=1))
        # DIV family extra: + gamma * kappa on every spatial slot.
        div_extra = jnp.sum(g * kd * r5[None, :], axis=1)
        grad = grad.at[:, :-1].add(div_extra[:, None])
        # LAPS family extra: + gamma^2 (2d/m) delta_k kappa on subset slots
        # (slots of x, since delta = x - roll(y) differentiates cleanly in x).
        W_l = g * g * (2.0 * scale) * kl * r3[None, :]
        y_sub = _roll(x_dom)[:, idx]
        extra_sub = (
            x[:, idx] * jnp.sum(W_l, axis=1)[:, None]
            - jax.lax.dot_general(
                W_l, y_sub, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        )
        grad = grad.at[:, idx].add(extra_sub)

    dt_u = div_u = lap_u = None
    if want_ops:
        dt_u = contract(feat(DT))
        div_u = contract(feat(DIV))
        lap_u = contract(feat(LAPS))

    return PosteriorOut(u=u, grad=grad, dt_u=dt_u, div_u=div_u, lap_u=lap_u)


def make_parity_posterior(subset: Tuple[int, ...], fp16: bool = False):
    """A drop-in posterior fn with the select_posterior_fn signature, so
    GP.predict / compute_gradient / compute_PDE_loss and the ScaSML rollout
    all evaluate the reference-biased cross-kernels in parity mode."""

    def posterior(x, x_dom, x_bdy, r, gamma, dim, want_grad=False,
                  want_ops=False, chunk: Optional[int] = None,
                  operand_dtype: str = "float32", shard_dom=None):
        # operand_dtype / shard_dom accepted for signature parity; parity
        # mode reproduces the reference's fp16 quantization points (never
        # bf16 operands) and the reference is single-device.
        del operand_dtype, shard_dom
        gam = jnp.atleast_1d(jnp.asarray(gamma, jnp.float32))[0]
        n = x.shape[0]
        if chunk is None or n <= chunk:
            return _parity_posterior_block(
                x, x_dom, x_bdy, r, gam, subset, dim, want_grad, want_ops,
                fp16,
            )
        pad = (-n) % chunk
        xp = jnp.pad(x, ((0, pad), (0, 0))).reshape(-1, chunk, x.shape[1])
        out = jax.lax.map(
            lambda xc: _parity_posterior_block(
                xc, x_dom, x_bdy, r, gam, subset, dim, want_grad, want_ops,
                fp16,
            ),
            xp,
        )

        def unchunk(v):
            if v is None:
                return None
            return v.reshape((-1,) + v.shape[2:])[:n]

        return PosteriorOut(*(unchunk(v) for v in out))

    return posterior
