"""GP posterior variance: calibrated uncertainty for the PDE surrogate.

New capability beyond the reference: the reference carries a FIXED
``equation.uncertainty = 0.1`` clip for the ScaSML correction
(``solvers/ScaSML.py:282-284``) and never exposes the GP's own predictive
uncertainty.  Here the standard conditional-Gaussian identity

    var(x) = kappa(x, x) - k_phi(x)^T (K + eta I)^{-1} k_phi(x)

is evaluated with the same closed-form operator blocks as the Gram assembly
(:mod:`scasml_gp.gp.kernels`): k_phi(x) is the (phi_dim,) cross vector of
the identity operator at x against the five training feature functionals
[ID@dom, ID@bdy, LAP@dom, DT@dom, DIV@dom], so one (n, phi) tile comes from
two matmuls (pair stats vs dom / bdy) plus fused elementwise math.

kappa(x, x) = 1 for the (ridge-augmented) RBF family, and the PDE-constrained
conditioning makes var the posterior variance of the COLLOCATION model: it
quantifies how far x is from the information carried by the training
functionals, which is exactly the quantity ScaSML's correction clip wants
(``GPConfig`` keeps the reference's fixed clip as the default; see
``picard/scasml.py``).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from scasml_gp.gp.gram import gram_matrix, regularized_factorization
from scasml_gp.gp.kernels import (
    ID,
    PHI_OPS,
    PHI_SETS,
    op_block,
    pair_stats,
)


@partial(jax.jit, static_argnames=("dim", "operand_dtype"))
def cross_phi(
    x: jax.Array,
    x_dom: jax.Array,
    x_bdy: jax.Array,
    gamma,
    dim: int,
    operand_dtype: str = "float32",
) -> jax.Array:
    """(n, 4N+Nb) cross-kernel matrix  [kappa_op(x, phi_j)]  (x side = ID).

    Column order matches the Gram/right_vector layout
    (reference models/GP.py:251-258).
    """
    gamma = jnp.asarray(gamma, jnp.float32)
    od = jnp.dtype(operand_dtype)
    st = {
        "dom": pair_stats(x, x_dom, gamma, od),
        "bdy": pair_stats(x, x_bdy, gamma, od),
    }
    return jnp.concatenate(
        [op_block(ID, b, st[sb], gamma, dim) for b, sb in
         zip(PHI_OPS, PHI_SETS)],
        axis=1,
    )


@partial(jax.jit, static_argnames=("dim", "operand_dtype"))
def factor_for_variance(
    x_dom: jax.Array,
    x_bdy: jax.Array,
    gamma,
    nugget,
    dim: int,
    operand_dtype: str = "float32",
) -> jax.Array:
    """C = (K + nugget I)^{-1} rebuilt from a trained state's points.

    One-time O(phi^3) cost (the train-time factor is not kept in
    :class:`~scasml_gp.gp.state.GPState` — it is phi^2 floats, ~70 MB at
    the reference sizes, and only variance queries need it).
    """
    gamma = jnp.asarray(gamma, jnp.float32)
    K = gram_matrix(x_dom, x_bdy, gamma, dim, operand_dtype)
    _, C = regularized_factorization(K, jnp.float32(nugget))
    return C


@partial(jax.jit, static_argnames=("dim", "chunk", "operand_dtype"))
def posterior_variance(
    x: jax.Array,
    x_dom: jax.Array,
    x_bdy: jax.Array,
    C: jax.Array,
    gamma,
    dim: int,
    chunk: Optional[int] = None,
    operand_dtype: str = "float32",
) -> jax.Array:
    """Pointwise posterior variance (n,), clipped at >= 0.

    ``chunk`` bounds the (chunk, phi) cross tile exactly like
    :func:`~scasml_gp.gp.posterior.posterior_eval`'s chunking.
    """
    gamma = jnp.asarray(gamma, jnp.float32)

    def block(xc):
        kx = cross_phi(xc, x_dom, x_bdy, gamma, dim, operand_dtype)
        v = jax.lax.dot_general(
            kx, C, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return jnp.maximum(1.0 - jnp.sum(v * kx, axis=1), 0.0)

    n = x.shape[0]
    if chunk is None or n <= chunk:
        return block(x)
    pad = (-n) % chunk
    xp = jnp.pad(x, ((0, pad), (0, 0))).reshape(-1, chunk, x.shape[1])
    out = jax.lax.map(block, xp)
    return out.reshape(-1)[:n]
