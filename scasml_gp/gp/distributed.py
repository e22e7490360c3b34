"""Distributed GP training: row-sharded Gram + matrix-free Gauss-Newton.

The dense trainer (gp/solver.py) materializes C = (K + nugget I)^{-1} — an
O(phi^3) replicated object that caps N_domain at a few thousand per chip.
This module is the large-N path mandated by SURVEY.md §2 G3/X2 ("shard Gram
rows over mesh for large N", "2-D mesh sharding of K + distributed solve"),
replacing the reference's fp64 SVD + dense ``jnp.linalg.solve`` calls
(reference models/GP.py:182-268, 599) with a scheme in which the
ONLY O(phi^2) object is the Gram matrix K, row-sharded over the 'model' mesh
axis, and every solve is a preconditioned CG whose matvec rides the sharded K.

Algorithm (sequential kernel linearization — the Gauss-Newton dual):

The GP objective is  J(sol) = b(sol)^T Ktil^{-1} b(sol)  with
b = [z1, g_bdy, z3, F(z1,z3,z5), z5] and Ktil = K + nugget I (reference
models/GP.py:430-444).  Each GN step minimizes the LINEARIZED objective,
which is a constrained quadratic over b:

    min_b  b^T Ktil^{-1} b   s.t.  M b = m,

where the (N + Nb) x phi constraint matrix M pins the boundary rows
(b_R2 = g) and the linearized F rows (b_R4 - f1 b_R1 - f3 b_R3 - f5 b_R5 =
c_lin, with (f1,f3,f5) = diag dF at the current iterate).  By Lagrange
duality the solution is

    b* = Ktil M^T mu,     (M Ktil M^T) mu = m,

so one GN step = ONE CG solve of an (N+Nb)^2 SPD system whose matvec is
mu -> M( Ktil (M^T mu) ): a cheap sparse lift, the sharded K matvec, and a
cheap sparse project.  The representer weights w = Ktil^{-1} b* = M^T mu and
the step's loss  b*^T Ktil^{-1} b* = m^T mu  come for free.  No explicit
inverse, no dense 3N x 3N Hessian, no O(phi^3) anywhere.

Per-device memory is phi^2/P + O(phi); per-matvec communication is one
all-gather of a length-phi vector (KBs) — the design scales K to the
aggregate HBM of the slice.

The Jacobi preconditioners use the closed-form zero-distance block diagonals
of the kernel algebra (gp/kernels.py op_block at q=s=dt=0), so no diagonal
extraction from the sharded K is needed.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.sparse.linalg import cg
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scasml_gp.gp.gram import gram_matrix
from scasml_gp.gp.kernels import PairStats, op_block

GRAM_SPEC = P("model", None)  # K rows sharded over the 'model' mesh axis


class DistTrainOut(NamedTuple):
    sol: jax.Array            # (3N,) trained (z1, z3, z5)
    right_vector: jax.Array   # (phi,) representer weights Ktil^{-1} b(sol)
    loss_history: jax.Array   # (gn_steps,) m^T mu per GN step
    final_residual: jax.Array # ||Ktil w - b(sol)|| / ||b(sol)|| of the last CG


def _zero_stats():
    """PairStats of a point paired with itself (q = s = dt = 0, kappa = 1)."""
    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)
    return PairStats(kappa=one, q=zero, s=zero, dt=zero)


def phi_diag_constants(gamma, dim: int):
    """Closed-form diagonals of the self-pair kernel blocks, as scalars:
    d_aa = (D_x^a D_y^a kappa)(x, x) for each phi family, plus the (ID, LAP)
    cross value needed by the constraint-row preconditioner.  All other
    same-point cross blocks vanish (odd in delta)."""
    st0 = _zero_stats()
    k_id = op_block("id", "id", st0, gamma, dim)
    k_lap = op_block("lap", "lap", st0, gamma, dim)
    k_dt = op_block("dt", "dt", st0, gamma, dim)
    k_div = op_block("div", "div", st0, gamma, dim)
    k_id_lap = op_block("id", "lap", st0, gamma, dim)
    return k_id, k_lap, k_dt, k_div, k_id_lap


def make_distributed_train(
    form,
    mesh: Mesh,
    dim: int,
    *,
    gn_steps: int = 8,
    cg_tol: float = 1e-7,
    cg_maxiter: int = 500,
) -> Callable:
    """Build a jitted distributed trainer.

    Returns ``train(x_dom, x_bdy, bdy_g, rhs, gamma, nugget) ->
    (DistTrainOut, K)`` with K row-sharded over the mesh's 'model' axis (the
    out-sharding is part of the jit contract, so callers/tests can assert
    placement directly on ``K.sharding``).
    """
    gram_sh = NamedSharding(mesh, GRAM_SPEC)
    rep = NamedSharding(mesh, P())

    def train(x_dom, x_bdy, bdy_g, rhs, gamma, nugget):
        N = x_dom.shape[0]
        Nb = x_bdy.shape[0]
        i1, i2, i3, i4 = N, N + Nb, 2 * N + Nb, 3 * N + Nb
        bdy_g = bdy_g.astype(jnp.float32)
        rhs = rhs.astype(jnp.float32)

        K = gram_matrix(x_dom, x_bdy, gamma, dim)
        K = jax.lax.with_sharding_constraint(K, gram_sh)

        def Kv(v):
            """Ktil @ v with the row-sharded K; result gathered replicated
            (a length-phi all-gather — the only collective in the matvec)."""
            out = K @ v + nugget * v
            return jax.lax.with_sharding_constraint(out, rep)

        def split(sol):
            return sol[:N], sol[N : 2 * N], sol[2 * N :]

        def b_of(sol):
            z1, z3, z5 = split(sol)
            return jnp.concatenate(
                [z1, bdy_g, z3, form.F(z1, z3, z5, rhs), z5]
            )

        # Jacobi preconditioner pieces from the closed-form block diagonals.
        k_id, k_lap, k_dt, k_div, k_id_lap = phi_diag_constants(gamma, dim)
        ktil_diag = jnp.concatenate(
            [
                jnp.full((N,), k_id),
                jnp.full((Nb,), k_id),
                jnp.full((N,), k_lap),
                jnp.full((N,), k_dt),
                jnp.full((N,), k_div),
            ]
        ) + nugget

        def gn_step(carry, _):
            sol, mu0 = carry
            z1, z3, z5 = split(sol)
            f1, f3, f5 = form.dF(z1, z3, z5)
            c_lin = form.F(z1, z3, z5, rhs) - f1 * z1 - f3 * z3 - f5 * z5
            m = jnp.concatenate([bdy_g, c_lin])

            def Mt(mu):  # constraint lift: (Nb + N,) -> (phi,)
                mu2, mu4 = mu[:Nb], mu[Nb:]
                return jnp.concatenate(
                    [-f1 * mu4, mu2, -f3 * mu4, mu4, -f5 * mu4]
                )

            def Mv(v):  # constraint project: (phi,) -> (Nb + N,)
                v4 = v[i3:i4]
                lin = v4 - f1 * v[:i1] - f3 * v[i2:i3] - f5 * v[i4:]
                return jnp.concatenate([v[i1:i2], lin])

            def A(mu):  # dual operator M Ktil M^T — SPD
                return Mv(Kv(Mt(mu)))

            # diag(M Ktil M^T): boundary rows are plain kernel diagonals;
            # linearized-F rows are r^T Ktil r for r = e_R4 - f1 e_R1
            # - f3 e_R3 - f5 e_R5 (all same-point cross blocks vanish except
            # (ID, LAP)).
            diag_f = (
                k_dt
                + f1 * f1 * k_id
                + f3 * f3 * k_lap
                + f5 * f5 * k_div
                + 2.0 * f1 * f3 * k_id_lap
                + nugget * (1.0 + f1 * f1 + f3 * f3 + f5 * f5)
            )
            diag_a = jnp.concatenate(
                [jnp.full((Nb,), k_id + nugget), diag_f]
            )
            mu, _ = cg(
                A, m, x0=mu0, tol=cg_tol, maxiter=cg_maxiter,
                M=lambda r: r / diag_a,
            )
            b_star = Kv(Mt(mu))
            sol_new = jnp.concatenate(
                [b_star[:i1], b_star[i2:i3], b_star[i4:]]
            )
            return (sol_new, mu), m @ mu

        sol0 = jnp.zeros((3 * N,), jnp.float32)
        mu0 = jnp.zeros((Nb + N,), jnp.float32)
        (sol, mu), losses = jax.lax.scan(
            gn_step, (sol0, mu0), None, length=gn_steps
        )

        # Exact representer weights of the final iterate: one more CG on
        # Ktil alone (the free w = M^T mu equals Ktil^{-1} b* only up to the
        # last linearization error).
        b_fin = b_of(sol)
        f1, f3, f5 = form.dF(*split(sol))
        w0 = jnp.concatenate([-f1 * mu[Nb:], mu[:Nb], -f3 * mu[Nb:],
                              mu[Nb:], -f5 * mu[Nb:]])
        w, _ = cg(
            Kv, b_fin, x0=w0, tol=cg_tol, maxiter=cg_maxiter,
            M=lambda r: r / ktil_diag,
        )
        resid = jnp.linalg.norm(Kv(w) - b_fin) / jnp.maximum(
            jnp.linalg.norm(b_fin), 1e-30
        )
        out = DistTrainOut(
            sol=sol, right_vector=w, loss_history=losses, final_residual=resid
        )
        return out, K

    return jax.jit(
        train,
        in_shardings=(rep, rep, rep, rep, rep, rep),
        out_shardings=(
            DistTrainOut(sol=rep, right_vector=rep, loss_history=rep,
                         final_residual=rep),
            gram_sh,
        ),
    )


def distributed_gpsolver(gp, x_dom, x_bdy, mesh: Mesh, *, gn_steps: int = 8,
                         cg_tol: float = 1e-7, cg_maxiter: int = 500):
    """Train a GP instance on the distributed path and install its state.

    Drop-in alternative to ``GP.GPsolver`` for large N: same state contract
    (GPState with sol/right_vector), so predict / compute_gradient /
    compute_PDE_loss and the ScaSML coupling all work unchanged.  Returns
    (DistTrainOut, K) — K row-sharded; callers may del it to free HBM.
    """
    from scasml_gp.gp.state import GPState

    x_dom = jnp.asarray(x_dom, jnp.float32)
    x_bdy = jnp.asarray(x_bdy, jnp.float32)
    bdy_g = gp.equation.g(x_bdy)[:, 0].astype(jnp.float32)
    rhs = gp.form.rhs_f(x_dom).astype(jnp.float32)
    train = make_distributed_train(
        gp.form, mesh, gp.d, gn_steps=gn_steps, cg_tol=cg_tol,
        cg_maxiter=cg_maxiter,
    )
    out, K = train(
        x_dom, x_bdy, bdy_g, rhs,
        jnp.asarray(gp.gamma, jnp.float32), jnp.float32(gp.nugget),
    )
    steps = out.loss_history.shape[0]
    hist = jnp.concatenate(
        [out.loss_history, out.loss_history[-1:]]
    ) if steps else out.loss_history
    gp.state = GPState(
        x_dom=x_dom,
        x_bdy=x_bdy,
        right_vector=out.right_vector,
        sol=out.sol,
        gamma=jnp.asarray(gp.gamma, jnp.float32),
        loss_history=hist,
    )
    return out, K
