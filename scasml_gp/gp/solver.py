"""Gaussian-process PDE surrogate: training (damped Newton) and evaluation.

API parity with the reference ``GP`` / ``GP_Grad_Dependent_Nonlinear``
(reference ``models/GP.py:8,487,653,673,689,693-769``): ``GPsolver``,
``predict``, ``compute_gradient``, ``compute_PDE_loss`` with the same loss
    loss(sol) = b(sol)^T (K + nugget I)^{-1} b(sol),
    b = [z1, g_bdy, z3, F(z1,z3,z5), z5]
and the same damped-Newton iteration (fixed step 1, damping 1e-4, early stop
|grad| < 1e-5; models/GP.py:487-604).

Differences from the reference:
- the Hessian is ANALYTIC (Gauss-Newton term + exact rank-structured
  second-order correction), not ``jax.hessian`` of a 3N-dim function — the
  reference itself carries the GN Hessian in comments (models/GP.py:446-458);
- (K + nugget I)^{-1} is precomputed once (Cholesky-based), so each Newton
  step is pure matmul/elementwise work inside ONE ``lax.fori_loop`` compiled
  graph — no per-step host sync;
- everything runs in fp32 (vs the reference's fp16-with-fp64-SVD mix).

Per-equation pieces (rhs, the time-derivative representation F, its Jacobian
and second derivative, and the strong-form PDE residual) live in small
``GPForm`` mixins, mirroring reference ``GP_Grad_Dependent_Nonlinear``
(models/GP.py:693-769).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from scasml_gp.config import GPConfig, PrecisionPolicy
from scasml_gp.equations.base import Equation
from scasml_gp.gp.gram import gram_matrix, regularized_factorization
from scasml_gp.gp.kernels import kernel_gammas
from scasml_gp.gp.posterior import posterior_eval, select_posterior_fn
from scasml_gp.gp.state import GPState


class GPForm:
    """Per-equation GP pieces. F maps (z1, z3, z5) -> values of du/dt on the
    interior set, derived from the PDE: du/dt = -mu * div u - (sigma^2/2) Lap u
    - f(x, u, sigma grad u), with z1 ~ u, z3 ~ Lap u, z5 ~ div u."""

    def __init__(self, equation: Equation):
        self.equation = equation

    def rhs_f(self, x_dom: jax.Array) -> jax.Array:
        """Forcing term on the interior set (reference models/GP.py:700-702)."""
        return jnp.zeros((x_dom.shape[0],), dtype=jnp.float32)

    def F(self, z1, z3, z5, rhs):
        raise NotImplementedError

    def dF(self, z1, z3, z5) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Diagonals of dF/dz1, dF/dz3, dF/dz5 (F_i depends only on entry i)."""
        raise NotImplementedError

    def d2F_contraction(self, w, z1, z3, z5):
        """3x3 blocks (as diagonal vectors) of sum_i w_i * Hess(F_i).
        Returns dict {(a,b): vec} with a,b in {0,1,2} for (z1,z3,z5)."""
        return {}

    def residual(self, x, u, dt_u, div_u, lap_u) -> jax.Array:
        """Strong-form PDE residual from posterior features."""
        raise NotImplementedError


class GradDependentForm(GPForm):
    """Mixin for GradDependentNonlinear (reference models/GP.py:693-769):
    F = -sigma^2 z1 z5 + (1/d + sigma^2/2) z5 - (sigma^2/2) z3 + rhs."""

    def F(self, z1, z3, z5, rhs):
        sig2 = self.equation.sigma() ** 2
        d = self.equation.dim
        return -sig2 * z1 * z5 + (1.0 / d + sig2 / 2.0) * z5 - (sig2 / 2.0) * z3 + rhs

    def dF(self, z1, z3, z5):
        sig2 = self.equation.sigma() ** 2
        d = self.equation.dim
        ones = jnp.ones_like(z1)
        f1 = -sig2 * z5
        f3 = -(sig2 / 2.0) * ones
        f5 = -sig2 * z1 + (1.0 / d + sig2 / 2.0) * ones
        return f1, f3, f5

    def d2F_contraction(self, w, z1, z3, z5):
        sig2 = self.equation.sigma() ** 2
        v = -sig2 * w
        return {(0, 2): v, (2, 0): v}

    def residual(self, x, u, dt_u, div_u, lap_u):
        # dt u + (sigma^2 u - 1/d - sigma^2/2) div u + (sigma^2/2) Lap u
        # (reference models/GP.py:746-769)
        sig2 = self.equation.sigma() ** 2
        d = self.equation.dim
        return dt_u + (sig2 * u - 1.0 / d - sig2 / 2.0) * div_u + (sig2 / 2.0) * lap_u


class AllenCahnForm(GPForm):
    """Mixin for AllenCahn (mu = 0): F = -(sigma^2/2) z3 - (z1 - z1^3) + rhs."""

    def F(self, z1, z3, z5, rhs):
        sig2 = self.equation.sigma() ** 2
        return -(sig2 / 2.0) * z3 - (z1 - z1**3) + rhs

    def dF(self, z1, z3, z5):
        sig2 = self.equation.sigma() ** 2
        ones = jnp.ones_like(z1)
        return -(1.0 - 3.0 * z1 * z1), -(sig2 / 2.0) * ones, jnp.zeros_like(z1)

    def d2F_contraction(self, w, z1, z3, z5):
        return {(0, 0): 6.0 * z1 * w}

    def residual(self, x, u, dt_u, div_u, lap_u):
        sig2 = self.equation.sigma() ** 2
        return dt_u + (sig2 / 2.0) * lap_u + (u - u**3)


class SineForm(GPForm):
    """Mixin for SineNonlinear (manufactured forcing — the one family with a
    nonzero ``rhs_f``, exercising the reference's rhs path,
    models/GP.py:700-702):  F = -(mu + sigma/d) z5 - (sigma^2/2) z3
    - sin(z1) + rhs,  rhs = -R(x)."""

    def rhs_f(self, x_dom):
        return (-self.equation.forcing(x_dom)).astype(jnp.float32)

    def F(self, z1, z3, z5, rhs):
        eq = self.equation
        sig = eq.sigma()
        c5 = eq.mu() + sig / eq.dim
        return -c5 * z5 - (sig**2 / 2.0) * z3 - jnp.sin(z1) + rhs

    def dF(self, z1, z3, z5):
        eq = self.equation
        sig = eq.sigma()
        ones = jnp.ones_like(z1)
        return (
            -jnp.cos(z1),
            -(sig**2 / 2.0) * ones,
            -(eq.mu() + sig / eq.dim) * ones,
        )

    def d2F_contraction(self, w, z1, z3, z5):
        return {(0, 0): jnp.sin(z1) * w}

    def residual(self, x, u, dt_u, div_u, lap_u):
        eq = self.equation
        sig = eq.sigma()
        return (
            dt_u
            + (eq.mu() + sig / eq.dim) * div_u
            + (sig**2 / 2.0) * lap_u
            + jnp.sin(u)
            + eq.forcing(x)
        )


class _TrainOut(NamedTuple):
    sol: jax.Array
    right_vector: jax.Array
    loss_history: jax.Array
    grad_norm: jax.Array


class GP:
    """Gaussian kernel PDE solver. Subclass with a GPForm mixin per equation
    (see :class:`GPGradDependentNonlinear`)."""

    form_cls = None  # set by subclasses

    def __init__(
        self,
        equation: Equation,
        config: Optional[GPConfig] = None,
        precision: Optional[PrecisionPolicy] = None,
        mesh=None,
    ):
        self.equation = equation
        self.config = config or GPConfig()
        # bf16-operand / fp32-accumulate policy for the Gram pair matmuls
        # (PrecisionPolicy.gram; VERDICT.md Next-round #3)
        self.precision = precision or PrecisionPolicy()
        # Optional jax.sharding.Mesh: training points are placed sharded over
        # the 'model' axis so GSPMD distributes the Gram tiles (SURVEY §2 X2).
        self.mesh = mesh
        if self.config.laplacian not in ("exact", "subset"):
            raise ValueError(
                f"unknown laplacian mode {self.config.laplacian!r}; "
                "use 'exact' (closed form) or 'subset' (reference-parity "
                "frozen-subset Hutchinson, gp/parity.py)."
            )
        equation.geometry()
        self.T = equation.T
        self.t0 = equation.t0
        self.n_input = equation.n_input
        self.n_output = equation.n_output
        self.d = equation.dim
        gs, gt, gr = kernel_gammas(
            equation.sigma(), self.d, self.config.time_scale,
            self.config.ridge_scale,
        )  # defaults reproduce the reference kernel
        c = self.config.gamma_scale
        self.gamma = (gs * c, gt * c, gr * c)
        self.nugget = self.config.nugget
        self.form: GPForm = self.form_cls(equation) if self.form_cls else None
        self.state: Optional[GPState] = None
        # bounds (chunk x phi_dim) posterior buffers (HBM knob, VERDICT #10)
        self.eval_chunk = self.config.eval_chunk or 4096
        self._subset = None
        if self.config.laplacian == "subset":
            if (
                self.config.time_scale != 1.0
                or self.config.ridge_scale != 0.0
                or self.config.gamma_scale != 1.0
            ):
                raise ValueError(
                    "parity mode (laplacian='subset') requires the reference's "
                    "isotropic kernel: time_scale=1, ridge_scale=0, "
                    "gamma_scale=1."
                )
            from scasml_gp.gp.parity import (
                make_parity_posterior,
                subset_indices,
            )

            self._subset = subset_indices(
                self.d, self.config.laplacian_subset_size
            )
            self._posterior = make_parity_posterior(
                self._subset, self.config.parity_fp16
            )
        else:
            self._posterior = select_posterior_fn(
                self.config.posterior_backend, self.d
            )

    # ------------------------------------------------------------------ train
    def GPsolver(
        self, x_t_domain, x_t_boundary, GN_steps: Optional[int] = None
    ) -> jax.Array:
        """Train the surrogate; returns the posterior mean on the interior set
        (same contract as reference models/GP.py:487-604)."""
        cfg = self.config
        steps = cfg.gn_steps if GN_steps is None else int(GN_steps)
        x_dom = jnp.asarray(x_t_domain, jnp.float32)
        x_bdy = jnp.asarray(x_t_boundary, jnp.float32)
        if self._resolve_train_backend(x_dom, x_bdy) == "distributed":
            return self._gpsolver_distributed(x_dom, x_bdy, GN_steps)
        if self.mesh is not None:
            x_dom = self._shard_train_points(x_dom)
        bdy_g = self._terminal_targets(x_bdy)
        rhs = self.form.rhs_f(x_dom).astype(jnp.float32)

        if cfg.laplacian == "subset" or cfg.parity_fp16:
            out = self._train_parity(x_dom, x_bdy, bdy_g, rhs, steps)
        else:
            out = self._train_jit(
                x_dom, x_bdy, bdy_g, rhs,
                jnp.asarray(self.gamma, jnp.float32),
                jnp.float32(self.nugget),
                steps=steps,
                damping=cfg.damping,
                grad_tol=cfg.grad_tol,
                init_scale=cfg.init_scale,
                gram_dtype=self.precision.gram,
            )
        self.state = GPState(
            x_dom=x_dom,
            x_bdy=x_bdy,
            right_vector=out.right_vector,
            sol=out.sol,
            gamma=jnp.asarray(self.gamma, jnp.float32),
            loss_history=out.loss_history,
        )
        self.loss_history = out.loss_history
        return self.predict(x_dom)

    def _resolve_train_backend(self, x_dom, x_bdy) -> str:
        """'dense' or 'distributed' per GPConfig.train_backend ('auto'
        switches to the row-sharded dual-CG trainer past dense_phi_max —
        VERDICT round-3 Next #1: the large-N path is now the flagless
        default whenever the problem needs it)."""
        cfg = self.config
        backend = cfg.train_backend
        if backend == "auto":
            phi = 4 * x_dom.shape[0] + x_bdy.shape[0]
            backend = "distributed" if phi > cfg.dense_phi_max else "dense"
        if backend not in ("dense", "distributed"):
            raise ValueError(f"unknown train_backend {cfg.train_backend!r}")
        if backend == "distributed" and (
            cfg.laplacian != "exact" or cfg.parity_fp16
        ):
            raise ValueError(
                "the distributed trainer supports only the exact-Laplacian "
                "fp32 kernel (no parity modes)"
            )
        return backend

    def _gpsolver_distributed(
        self, x_dom, x_bdy, GN_steps: Optional[int] = None
    ) -> jax.Array:
        """Large-N training: row-sharded Gram + matrix-free dual-CG GN
        (gp/distributed.py).  Uses the instance mesh when one was supplied;
        otherwise a 1 x n_devices ('data','model') mesh over the local
        devices (a single chip degenerates to an unsharded CG trainer,
        which still avoids the dense path's phi^2 inverse and (3N)^2
        Hessian).  An explicit ``GN_steps`` (the ComputingBudget sweep axis,
        harness/computing_budget.py) overrides ``cfg.dist_gn_steps`` so the
        budget knob keeps meaning something on the large-N path (ADVICE
        round-4 #1)."""
        from scasml_gp.gp.distributed import distributed_gpsolver

        mesh = self.mesh
        if mesh is None:
            from scasml_gp.parallel.mesh import make_mesh

            mesh = make_mesh(data=1, model=len(jax.devices()))
        cfg = self.config
        steps = cfg.dist_gn_steps if GN_steps is None else int(GN_steps)
        out, K = distributed_gpsolver(
            self, x_dom, x_bdy, mesh,
            gn_steps=steps, cg_tol=cfg.dist_cg_tol,
            cg_maxiter=cfg.dist_cg_maxiter,
        )
        del K  # free the phi^2 Gram before posterior evaluation
        return self.predict(x_dom)

    def _shard_train_points(self, x_dom):
        """Place the interior points sharded over the mesh's 'model' axis so
        GSPMD computes Gram tiles where their rows live (falls back to
        replicated when the point count doesn't divide the axis)."""
        from scasml_gp.parallel.mesh import train_point_sharding

        n_model = self.mesh.shape["model"]
        if x_dom.shape[0] % n_model:
            return x_dom
        return jax.device_put(x_dom, train_point_sharding(self.mesh))

    @partial(jax.jit, static_argnames=("self", "steps", "gram_dtype"))
    def _train_jit(
        self, x_dom, x_bdy, bdy_g, rhs, gamma, nugget,
        steps, damping, grad_tol, init_scale, gram_dtype="float32",
    ) -> _TrainOut:
        """One compiled graph for the whole Newton train.  ``gamma`` and
        ``nugget`` are TRACED (not baked in), so hyperparameter search —
        grid (gp/tuning.py) or marginal-likelihood descent (gp/marginal.py)
        — reuses this program across candidates and can ``vmap`` it."""
        K = gram_matrix(x_dom, x_bdy, gamma, self.d, gram_dtype)
        _, C = regularized_factorization(K, nugget)
        return self._newton_body(
            C, bdy_g, rhs, steps, damping, grad_tol, init_scale
        )

    def _train_parity(self, x_dom, x_bdy, bdy_g, rhs, steps) -> _TrainOut:
        """Reference-parity train path (VERDICT.md Next-round #1): biased
        subset-Laplacian Gram (gp/parity.py) and/or fp16 quantization, with
        the reference's HOST fp64 SVD pseudo-Cholesky factorization
        (models/GP.py:258-266) instead of the in-graph Cholesky cascade."""
        from scasml_gp.gp.parity import (
            parity_factorization,
            parity_gram_matrix,
        )

        cfg = self.config
        fp16 = cfg.parity_fp16
        if cfg.laplacian == "subset":
            K = parity_gram_matrix(
                x_dom, x_bdy, jnp.float32(self.gamma[0]), self._subset,
                self.d, fp16,
            )
        else:  # exact closed-form blocks, fp16-quantized (attribution toggle)
            K = gram_matrix(
                x_dom, x_bdy, jnp.asarray(self.gamma, jnp.float32), self.d
            )
            if fp16:
                K = K.astype(jnp.float16).astype(jnp.float32)
        _, C = parity_factorization(K, self.nugget, fp16)
        return self._train_from_C(
            jnp.asarray(C), bdy_g, rhs,
            steps=steps, damping=cfg.damping, grad_tol=cfg.grad_tol,
            init_scale=cfg.init_scale,
        )

    @partial(jax.jit, static_argnames=("self", "steps"))
    def _train_from_C(
        self, C, bdy_g, rhs, steps, damping, grad_tol, init_scale
    ) -> _TrainOut:
        """Newton train given a precomputed C = (K + nugget I)^{-1}."""
        return self._newton_body(
            C, bdy_g, rhs, steps, damping, grad_tol, init_scale
        )

    def _newton_body(
        self, C, bdy_g, rhs, steps, damping, grad_tol, init_scale
    ) -> _TrainOut:
        """The damped-Newton loop (traced inside a jit caller)."""
        N = rhs.shape[0]
        Nb = bdy_g.shape[0]

        # Row sets of b = [z1 (R1), bdy (R2), z3 (R3), F (R4), z5 (R5)].
        i1, i2, i3, i4 = N, N + Nb, 2 * N + Nb, 3 * N + Nb
        C_rows = {1: C[:i1], 2: C[i1:i2], 3: C[i2:i3], 4: C[i3:i4], 5: C[i4:]}
        # Sub-blocks used by the analytic Hessian: groups (z1,z3,z5) live on
        # identity rows (R1,R3,R5) and couple through the F rows (R4).
        grp_rows = {0: (0, i1), 1: (i2, i3), 2: (i4, 4 * N + Nb)}

        def split(sol):
            return sol[:N], sol[N : 2 * N], sol[2 * N :]

        def b_of(sol):
            z1, z3, z5 = split(sol)
            return jnp.concatenate(
                [z1, bdy_g, z3, self.form.F(z1, z3, z5, rhs), z5]
            )

        # C reaches ~1e7 in condition number and the loss b^T C b is a small
        # difference of large terms, so every product with C is pinned to
        # true fp32: with TF32 operands (a GPU's default) most grid kernels
        # of the d=20 flagship trained to rel-L2 above 1.
        def C_dot(v):
            return jnp.dot(C, v, precision=jax.lax.Precision.HIGHEST)

        def loss_of(sol):
            b = b_of(sol)
            return jnp.dot(b, C_dot(b), precision=jax.lax.Precision.HIGHEST)

        def grad_of(sol, Cb):
            z1, z3, z5 = split(sol)
            f1, f3, f5 = self.form.dF(z1, z3, z5)
            r4 = Cb[i3:i4]
            g1 = Cb[:i1] + f1 * r4
            g2 = Cb[i2:i3] + f3 * r4
            g3 = Cb[i4:] + f5 * r4
            return 2.0 * jnp.concatenate([g1, g2, g3])

        C44 = C[i3:i4, i3:i4]

        def hess_of(sol, Cb):
            z1, z3, z5 = split(sol)
            f1, f3, f5 = self.form.dF(z1, z3, z5)
            fs = (f1, f3, f5)
            blocks = [[None] * 3 for _ in range(3)]
            d2 = self.form.d2F_contraction(Cb[i3:i4], z1, z3, z5)
            for a in range(3):
                ra0, ra1 = grp_rows[a]
                for bgrp in range(3):
                    rb0, rb1 = grp_rows[bgrp]
                    blk = (
                        C[ra0:ra1, rb0:rb1]
                        + fs[a][:, None] * C[i3:i4, rb0:rb1]
                        + C[ra0:ra1, i3:i4] * fs[bgrp][None, :]
                        + fs[a][:, None] * C44 * fs[bgrp][None, :]
                    )
                    if (a, bgrp) in d2:
                        blk = blk + jnp.diag(d2[(a, bgrp)])
                    blocks[a][bgrp] = blk
            H = jnp.block(blocks)
            return 2.0 * H

        sol0 = jax.random.normal(jax.random.PRNGKey(0), (3 * N,)) * init_scale
        sol0 = sol0.astype(jnp.float32)
        loss0 = loss_of(sol0)
        loss_hist0 = jnp.zeros((steps + 1,), jnp.float32).at[0].set(loss0)

        # Backtracking candidates for the line search the reference carries
        # only in comments (models/GP.py:540-570).  A full alpha=1 Newton step
        # on this quartic diverges for some kernels (e.g. ridge-augmented at
        # large N); evaluating all candidates at once is cheap (each loss is
        # one O(phi^2) matvec) and keeps the loop monotone.
        alphas = 0.5 ** jnp.arange(8, dtype=jnp.float32)

        def body(step, carry):
            sol, hist, done, gnorm_last, damping_cur, J_now = carry
            b = b_of(sol)
            Cb = C_dot(b)
            grad = grad_of(sol, Cb)
            gnorm = jnp.linalg.norm(grad)
            stop = done | (gnorm < grad_tol)

            H = hess_of(sol, Cb)
            H = H + damping_cur * jnp.eye(H.shape[0], dtype=H.dtype)
            direction = jnp.linalg.solve(H, -grad)

            cand = sol[None, :] + alphas[:, None] * direction[None, :]
            losses = jax.vmap(loss_of)(cand)
            best = jnp.argmin(losses)
            improved = losses[best] < J_now
            accept = improved & ~stop
            new_sol = jnp.where(accept, cand[best], sol)
            new_J = jnp.where(accept, losses[best], J_now)
            # reference's commented damping policy (models/GP.py:579-584)
            new_damp = jnp.where(
                improved,
                jnp.maximum(damping_cur * 0.1, damping),
                jnp.minimum(damping_cur * 10.0, 1.0),
            )
            hist = hist.at[step + 1].set(new_J)
            return (new_sol, hist, stop, jnp.where(done, gnorm_last, gnorm),
                    new_damp, new_J)

        sol, hist, _, gnorm, _, _ = jax.lax.fori_loop(
            0, steps, body,
            (sol0, loss_hist0, jnp.array(False), jnp.array(0.0),
             jnp.asarray(damping, jnp.float32), loss0),
        )

        z = b_of(sol)
        right_vector = C_dot(z)
        return _TrainOut(
            sol=sol, right_vector=right_vector, loss_history=hist, grad_norm=gnorm
        )

    # ------------------------------------------------------------------- eval
    def _require_state(self):
        if self.state is None:
            raise RuntimeError("GP not trained; call GPsolver first.")

    def _terminal_targets(self, x_bdy) -> jax.Array:
        """Boundary regression targets, shape (Nb,).  The surrogate fits
        these directly; transformed GPs (gp/cole_hopf.py) override to fit a
        transform of g instead."""
        return self.equation.g(x_bdy)[:, 0].astype(jnp.float32)

    def posterior_u(
        self, params: GPState, x_t, want_grad: bool = False,
        want_ops: bool = False,
    ):
        """Pure u-space posterior of a trained state: (u, grad, dt/div/lap).

        This is the interface ScaSML traces inside its compiled rollout
        (picard/scasml.py) — ``params`` is an explicit GPState pytree so a
        retrained surrogate does not retrigger compilation.  The base GP's
        posterior mean IS u; transformed surrogates (e.g. the Cole-Hopf HJB
        GP) override this to map their internal process to u-space."""
        return self._posterior(
            jnp.asarray(x_t, jnp.float32),
            params.x_dom,
            params.x_bdy,
            params.right_vector,
            params.gamma,
            self.d,
            want_grad=want_grad,
            want_ops=want_ops,
            chunk=self.eval_chunk,
            operand_dtype=self.precision.gram,
            shard_dom=self._dom_sharding(),
        )

    def _dom_sharding(self):
        """'model'-axis sharding for the posterior's training-set contraction
        (VERDICT round-2 #4): with a >1 'model' mesh axis, the per-device
        posterior buffers shrink to ~1/P of the replicated path; None (the
        single-device default) keeps the contraction local."""
        if self.mesh is None or self.mesh.shape.get("model", 1) <= 1:
            return None
        from jax.sharding import NamedSharding, PartitionSpec

        return NamedSharding(self.mesh, PartitionSpec("model", None))

    def residual_u(self, params: GPState, x_t) -> jax.Array:
        """Strong-form PDE residual of the posterior mean in u-space,
        shape (n, 1) — the epsilon that ScaSML injects at leaf nodes."""
        x = jnp.asarray(x_t, jnp.float32)
        out = self.posterior_u(params, x, want_ops=True)
        eps = self.form.residual(x, out.u, out.dt_u, out.div_u, out.lap_u)
        return eps[:, None]

    def predict(self, x_t_infer) -> jax.Array:
        """Posterior mean, shape (n, 1) (reference models/GP.py:653-671)."""
        self._require_state()
        return self.posterior_u(self.state, x_t_infer).u[:, None]

    def compute_gradient(self, x_t_infer, sol_infer=None) -> jax.Array:
        """Full space-time posterior gradient, shape (n, d+1)
        (reference models/GP.py:673-687; ``sol_infer`` kept for API parity)."""
        self._require_state()
        return self.posterior_u(self.state, x_t_infer, want_grad=True).grad

    def compute_PDE_loss(self, x_t_infer) -> jax.Array:
        """Strong-form PDE residual of the posterior mean, shape (n, 1)
        (reference models/GP.py:746-769)."""
        self._require_state()
        return self.residual_u(self.state, x_t_infer)

    def predict_std(self, x_t_infer) -> jax.Array:
        """Posterior standard deviation, shape (n, 1).

        New capability beyond the reference (it carries only a FIXED
        uncertainty constant, ``solvers/ScaSML.py:282-284``): the
        conditional-Gaussian variance of the PDE-collocation model
        (gp/variance.py).  The (K + nugget I)^{-1} factor is rebuilt once per
        trained state and cached on the instance."""
        self._require_state()
        from scasml_gp.gp.variance import (
            factor_for_variance,
            posterior_variance,
        )

        if getattr(self, "_var_cache_for", None) is not self.state:
            self._var_C = factor_for_variance(
                self.state.x_dom, self.state.x_bdy, self.state.gamma,
                self.nugget, self.d, self.precision.gram,
            )
            self._var_cache_for = self.state
        var = posterior_variance(
            jnp.asarray(x_t_infer, jnp.float32),
            self.state.x_dom, self.state.x_bdy, self._var_C,
            self.state.gamma, self.d, chunk=self.eval_chunk,
            operand_dtype=self.precision.gram,
        )
        return jnp.sqrt(var)[:, None]

    def predict_with_std(self, x_t_infer):
        """(posterior mean, posterior std), each shape (n, 1)."""
        return self.predict(x_t_infer), self.predict_std(x_t_infer)


class GPGradDependentNonlinear(GP):
    """GP surrogate for GradDependentNonlinear
    (parity with reference ``GP_Grad_Dependent_Nonlinear``, models/GP.py:693)."""

    form_cls = GradDependentForm


class GPAllenCahn(GP):
    """GP surrogate for AllenCahn (new capability beyond the reference)."""

    form_cls = AllenCahnForm


class GPSineNonlinear(GP):
    """GP surrogate for SineNonlinear (new capability beyond the reference)."""

    form_cls = SineForm
