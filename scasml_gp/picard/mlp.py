"""Plain multilevel Picard solvers (no GP calibration).

API parity with reference ``solvers/MLP.py`` and ``solvers/MLP_full_history.py``:
``u_solve(n, rho, x_t)`` / ``u_solve(n, rho, x_t, M)`` and ``uz_solve``, with an
``evaluation_counter`` attribute.  The rollout itself is the statically
scheduled, single-compilation recursion of :mod:`scasml_gp.picard.core`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from scasml_gp.equations.base import Equation
from scasml_gp.picard.core import (
    PicardModel,
    build_full_history_uz,
    build_quadrature_uz,
)
from scasml_gp.picard.schedule import (
    approx_parameters,
    count_evaluations_full_history,
    count_evaluations_quadrature,
)


class _PicardBase:
    """Shared plumbing: jit cache keyed by (schedule, chunk shape), batch
    chunking, stateful RNG stream, evaluation counter."""

    def __init__(self, equation: Equation, batch_chunk: Optional[int] = None,
                 center_z: Optional[bool] = None,
                 time_sampling: Optional[str] = None,
                 precision=None, mesh=None, debug_checks: bool = False,
                 terminal_crn: bool = False,
                 reference_semantics: bool = False):
        self.equation = equation
        # PrecisionPolicy.rollout -> Brownian path storage dtype (bf16 opt-in)
        from scasml_gp.config import PrecisionPolicy

        self.precision = precision or PrecisionPolicy()
        # Optional jax.sharding.Mesh: the test batch is placed sharded over
        # the 'data' axis; each chip rolls out its shard's sample tree with
        # zero cross-chip traffic (SURVEY §2 X2).
        self.mesh = mesh
        # centered (control-variate) z estimators; default comes from the
        # equation (gradient-quadratic generators like HJB need them)
        self.center_z = (
            getattr(equation, 'center_z', False) if center_z is None
            else center_z
        )
        self.time_sampling = (
            getattr(equation, 'time_sampling', 'uniform')
            if time_sampling is None else time_sampling
        )
        self.terminal_z = getattr(equation, 'terminal_z', 'reference')
        equation.geometry()
        self.T = equation.T
        self.t0 = equation.t0
        self.n_input = equation.n_input
        self.n_output = equation.n_output
        self.dim = equation.n_input - 1
        self.evaluation_counter = 0
        self.key = jax.random.PRNGKey(0)
        self.batch_chunk = batch_chunk
        # Debug mode: checkify float checks inside the compiled rollout so a
        # non-finite value raises a LOCALIZED error (op + traceback) instead
        # of surfacing only as a harness NaN mask (SURVEY §5 sanitizers).
        self.debug_checks = debug_checks
        # reference-RNG parity probe: frozen PRNGKey(0) terminal draws at
        # every tree node (see core.PicardModel.terminal_crn)
        self.terminal_crn = terminal_crn
        # faithful reference-estimator probe (carried delta_t, fp16 interior
        # draws, per-level fp16 output quantization; see core.PicardModel)
        self.reference_semantics = reference_semantics
        self._cache: Dict[Tuple, Callable] = {}

    # -- overridden by ScaSML variants --
    def _params(self):
        return None

    def _model(self) -> PicardModel:
        eq = self.equation
        return PicardModel(
            f=lambda params, x_t, u, z: eq.f(x_t, u, z),
            g=lambda params, x_t: eq.g(x_t),
            leaf=None,
            mu=float(eq.mu()),
            sigma=float(eq.sigma()),
            T=self.T,
            dim=self.dim,
            clip=float(eq.norm_estimation),
            center_z=self.center_z,
            time_sampling=self.time_sampling,
            terminal_z=self.terminal_z,
            path_dtype=self.precision.rollout,
            terminal_crn=self.terminal_crn,
            reference_semantics=self.reference_semantics,
        )

    def _build(self, schedule_key: Tuple) -> Callable:
        raise NotImplementedError

    def _get_fn(self, schedule_key: Tuple) -> Callable:
        fn = self._cache.get(schedule_key)
        if fn is None:
            fn = jax.jit(self._build(schedule_key))
            if self.debug_checks:
                from jax.experimental import checkify

                checked = checkify.checkify(fn, errors=checkify.float_checks)

                def fn(x_t, key, params, _checked=checked):
                    err, out = _checked(x_t, key, params)
                    err.throw()  # localized op + source line on non-finite
                    return out

            self._cache[schedule_key] = fn
        return fn

    def _next_key(self) -> jax.Array:
        self.key, sub = jax.random.split(self.key)
        return sub

    def _shard_batch(self, x_t):
        """Place the batch sharded over the mesh's 'data' axis (replicated
        fallback when the batch doesn't divide the axis)."""
        from scasml_gp.parallel.mesh import batch_sharding

        n_data = self.mesh.shape["data"]
        if x_t.shape[0] % n_data:
            return x_t
        return jax.device_put(x_t, batch_sharding(self.mesh))

    def _run(self, schedule_key: Tuple, x_t) -> jax.Array:
        """Run the compiled rollout, chunking the batch to bound HBM."""
        x_t = jnp.asarray(x_t, jnp.float32)
        if self.mesh is not None:
            x_t = self._shard_batch(x_t)
        fn = self._get_fn(schedule_key)
        params = self._params()
        B = x_t.shape[0]
        chunk = self.batch_chunk
        if chunk is None or B <= chunk:
            return fn(x_t, self._next_key(), params)
        outs = []
        for start in range(0, B, chunk):
            piece = x_t[start : start + chunk]
            pad = chunk - piece.shape[0]
            if pad:
                piece = jnp.pad(piece, ((0, pad), (0, 0)))
            out = fn(piece, self._next_key(), params)
            outs.append(out[: chunk - pad] if pad else out)
        return jnp.concatenate(outs, axis=0)


class MLP(_PicardBase):
    """Quadrature multilevel Picard (reference ``solvers/MLP.py``)."""

    def _build(self, schedule_key):
        n, rho = schedule_key
        tables = approx_parameters(rho, self.T)
        return build_quadrature_uz(self._model(), n, rho, tables)

    def uz_solve(self, n: int, rho: int, x_t) -> jax.Array:
        """(batch, 1 + dim) concatenated [u, z] (reference solvers/MLP.py:141)."""
        out = self._run((int(n), int(rho)), x_t)
        self.evaluation_counter += count_evaluations_quadrature(
            int(n), int(rho), self.T
        )
        return out

    def u_solve(self, n: int, rho: int, x_t) -> jax.Array:
        """(batch, 1) u values (reference solvers/MLP.py:276-288)."""
        return self.uz_solve(n, rho, x_t)[:, :1]


class MLPFullHistory(_PicardBase):
    """Full-history multilevel Picard (reference ``solvers/MLP_full_history.py``)."""

    def _build(self, schedule_key):
        n, M = schedule_key
        return build_full_history_uz(self._model(), n, M)

    def uz_solve(self, n: int, rho: int, x_t, M: int = 3) -> jax.Array:
        """``rho`` unused, kept for API parity (solvers/MLP_full_history.py:64)."""
        out = self._run((int(n), int(M)), x_t)
        self.evaluation_counter += count_evaluations_full_history(int(n), int(M))
        return out

    def u_solve(self, n: int, rho: int, x_t, M: int = 3) -> jax.Array:
        return self.uz_solve(n, rho, x_t, M)[:, :1]


# Reference-spelling alias (solvers/MLP_full_history.py class name).
MLP_full_history = MLPFullHistory
