"""Typed configuration for the framework.

The reference hardcodes every knob in eight near-identical driver scripts
(reference ``results/*/experiment_run.py``; see SURVEY.md "Config / flag
system").  Here a single dataclass tree covers the PDE, solver, precision and
mesh choices, and one runner CLI consumes it (``scasml_gp.harness.runner``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Precision policy: bfloat16 operands, float32 accumulation.

    The reference casts nearly everything to float16 and runs an SVD in float64
    (reference ``models/GP.py:258-266``).  Here the reduced-precision option
    is bfloat16 matmul operands with float32 accumulation; quadrature tables
    are always built host-side in float64 (picard/schedule.py) and the
    Newton trainer's factorization and inverse always run in float64
    (gp/gram.py regularized_factorization) regardless of this policy.

    - ``gram``: operand dtype of the pair-statistics matmul in Gram assembly
      and posterior cross-kernel evaluation (gp/kernels.py pair_stats).
      'bfloat16' runs the O(N^2 d) distance matmul with bf16 operands and
      fp32 accumulation; the elementwise kernel math stays fp32.
    - ``rollout``: storage dtype of the Brownian sample paths (xi, X, W) in
      the Picard rollouts (picard/core.py).  The u/z accumulators, quadrature
      weights and all reductions stay fp32.
    """

    gram: str = "float32"     # 'float32' | 'bfloat16'
    # 'float16' is a reference-parity probe (the reference draws its Brownian
    # normals in half precision, solvers/MLP.py:179); 'bfloat16' halves the
    # path traffic.
    rollout: str = "float32"  # 'float32' | 'bfloat16' | 'float16'

    def __post_init__(self):
        allowed = {"gram": ("float32", "bfloat16"),
                   "rollout": ("float32", "bfloat16", "float16")}
        for field, ok in allowed.items():
            val = getattr(self, field)
            if val not in ok:
                raise ValueError(
                    f"PrecisionPolicy.{field} must be one of {ok}, "
                    f"got {val!r}"
                )

    @property
    def gram_dtype(self):
        return jnp.dtype(self.gram)

    @property
    def rollout_dtype(self):
        return jnp.dtype(self.rollout)


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Gaussian-process surrogate knobs (reference ``models/GP.py``)."""

    nugget: float = 1e-2            # reference models/GP.py:26
    # Time length-scale multiplier for the separable space/time kernel:
    # sigma_t = time_scale * sigma_k. 1.0 reproduces the reference's isotropic
    # kernel (models/GP.py:25) exactly; smaller values resolve the short
    # [0, T] time axis at large d (see gp/kernels.py).
    time_scale: float = 1.0
    # Ridge precision multiplier: gr = ridge_scale * gs / d. 0.0 reproduces
    # the reference's isotropic kernel; positive values resolve variation
    # along the mean direction 1/sqrt(d), which the isotropic kernel loses
    # to concentration of measure at large d (see gp/kernels.py docstring).
    ridge_scale: float = 0.0
    # Overall precision multiplier applied to (gs, gt, gr) — i.e. an inverse
    # squared length-scale knob on top of the reference's sigma*sqrt(d) rule.
    # 1.0 reproduces the reference; fitted by gp/marginal.py.
    gamma_scale: float = 1.0
    gn_steps: int = 20              # reference models/GP.py:487 (GN_steps default)
    damping: float = 1e-4           # reference models/GP.py:491
    grad_tol: float = 1e-5          # reference models/GP.py:521 early stop
    init_scale: float = 1e-3        # reference models/GP.py:501 sol init scale
    # 'exact' uses closed-form RBF Laplacians; 'subset' reproduces the
    # reference's frozen-5-coordinate Hutchinson estimator (models/GP.py:28-39)
    # INCLUDING its coordinate-roll quirk (models/GP.py:91-94), in closed form
    # (gp/parity.py), for parity experiments. Requires the isotropic kernel
    # (time_scale=1, ridge_scale=0, gamma_scale=1).
    laplacian: str = "exact"
    laplacian_subset_size: int = 5
    # Reproduce the reference's fp16 quantization points (Gram blocks cast to
    # float16, fp64-SVD pseudo-Cholesky factor stored fp16; models/GP.py:
    # 43,258-266). Orthogonal to `laplacian`, so the d>=40 parity gap can be
    # attributed bias-by-bias (VERDICT.md Next-round #1).
    parity_fp16: bool = False
    # Chunk size bounding the (chunk x phi_dim) posterior buffers on the hot
    # path (HBM knob). None means the default of 4096 rows per block
    # (gp/solver.py), which keeps the biggest intermediate under ~80 MB at
    # the reference training sizes.
    eval_chunk: Optional[int] = None
    # Posterior evaluation backend: 'xla' (fused by the compiler) or 'auto'
    # (= 'xla'), the only implementation.
    posterior_backend: str = "auto"
    # Training backend: 'dense' (one-time explicit inverse + analytic-Hessian
    # Newton, gp/solver.py), 'distributed' (row-sharded Gram + matrix-free
    # dual-CG Gauss-Newton, gp/distributed.py — the large-N path), or 'auto':
    # distributed when phi_dim = 4 N_dom + N_bdy exceeds ``dense_phi_max``.
    # The dense path materializes TWO phi^2 fp32 buffers (K and its inverse)
    # plus a (3N)^2 Newton Hessian; past ~8k phi that tops HBM and the
    # O(phi^3) inverse dominates, while the CG path's only phi^2 object is
    # the (shardable) K itself.
    train_backend: str = "auto"
    dense_phi_max: int = 8400
    # Distributed trainer knobs: outer Gauss-Newton steps (each = one CG
    # solve of the (N+Nb)^2 dual system) and the CG stop criteria.
    dist_gn_steps: int = 8
    dist_cg_tol: float = 1e-7
    dist_cg_maxiter: int = 500


@dataclasses.dataclass(frozen=True)
class PicardConfig:
    """Multilevel Picard solver knobs (reference ``solvers/``)."""

    n: int = 2                      # recursion depth
    rho: int = 2                    # refinement level (quadrature variant)
    M: int = 3                      # sample base (full-history variant)
    variant: str = "quadrature"     # 'quadrature' | 'full_history'
    batch_chunk: Optional[int] = None  # chunk the test batch to bound memory
    # Debug mode: instrument the compiled rollout with jax.experimental.
    # checkify float checks so a non-finite value raises a localized error
    # (op + source line) instead of silently propagating into the harness
    # NaN mask (SURVEY.md §5 "Race detection / sanitizers"). Costs extra
    # in-graph checks; off by default.
    debug_checks: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. Axes: 'data' shards the (batch x MC) sample axis,
    'model' shards Gram rows for large training sets. The reference has no
    parallelism at all (SURVEY.md §2 X1/X2)."""

    data: int = 1
    model: int = 1

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data, self.model)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One experiment run = PDE + dimensions + solvers + harness."""

    equation: str = "GradDependentNonlinear"
    dim: int = 20                   # spatial dimension d (n_input = d + 1)
    num_domain: int = 1000          # GP training set (reference tests/SimpleUniform.py:46)
    num_boundary: int = 200
    test_domain: int = 1000
    test_boundary: int = 200
    seed: int = 1234                # reference drivers seed everything with 1234
    harness: str = "SimpleUniform"
    save_path: str = "results"
    gp: GPConfig = dataclasses.field(default_factory=GPConfig)
    picard: PicardConfig = dataclasses.field(default_factory=PicardConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    precision: PrecisionPolicy = dataclasses.field(default_factory=PrecisionPolicy)
    wandb: bool = False

    @property
    def n_input(self) -> int:
        return self.dim + 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RunConfig":
        raw = json.loads(text)
        for key, cls in (
            ("gp", GPConfig),
            ("picard", PicardConfig),
            ("mesh", MeshConfig),
            ("precision", PrecisionPolicy),
        ):
            if key in raw and isinstance(raw[key], dict):
                raw[key] = cls(**raw[key])
        return RunConfig(**raw)
