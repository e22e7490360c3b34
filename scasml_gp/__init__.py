"""scasml_gp — a JAX framework for Simulation-Calibrated Scientific Machine
Learning (SCaSML) with a Gaussian-Process PDE surrogate.

Re-designed from scratch in JAX/XLA with the capabilities of the reference
`SCaSML_GP` codebase (see SURVEY.md):

- ``equations``  — pure-JAX PDE problem definitions + native geometry samplers
                   (capability parity with reference ``equations/equations.py``).
- ``gp``         — Gaussian-process PDE surrogate: closed-form space-time RBF
                   derivative kernels, tiled Gram assembly, float64 Cholesky,
                   damped Newton with analytic gradient/Hessian, fused posterior
                   mean/gradient/PDE-residual evaluation
                   (parity with reference ``models/GP.py``).
- ``picard``     — Multilevel Picard Monte-Carlo solvers (quadrature and
                   full-history variants) flattened into statically-shaped,
                   trace-time-unrolled JAX programs, plus the ScaSML
                   GP-calibrated residual solvers
                   (parity with reference ``solvers/*.py``).
- ``parallel``   — device meshes, sharding of the (batch x MC) sample axes and
                   of the Gram matrix, multi-host initialization (new capability;
                   the reference is single-device).
- ``harness``    — the six experiment harnesses (SimpleUniform, RepeatedExperiment,
                   ConvergenceRate, InferenceScaling, SimpleScaling,
                   ComputingBudget) with identical metric definitions, plus a
                   single config-driven runner replacing the reference's eight
                   driver scripts.
"""

import os as _os

# Persistent XLA compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR
# itself, so when it is set the package leaves the cache alone.  Otherwise
# device runs cache at one fixed path inside the checkout, so every later
# process started from it finds what earlier ones compiled.  CPU runs
# (JAX_PLATFORMS=cpu, the test suite) keep no cache: XLA:CPU entries record
# the compiling host's features and are unsafe to load on another machine.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR") and (
    _os.environ.get("JAX_PLATFORMS", "") != "cpu"
):
    import jax as _jax

    _repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    _jax.config.update(
        "jax_compilation_cache_dir", _os.path.join(_repo, ".jax_cache")
    )

from scasml_gp.config import (
    PrecisionPolicy,
    RunConfig,
)
from scasml_gp.equations import Equation, GradDependentNonlinear
from scasml_gp.gp import GP, GPGradDependentNonlinear
from scasml_gp.picard import (
    MLP,
    MLPFullHistory,
    ScaSML,
    ScaSMLFullHistory,
)

__version__ = "0.1.0"

__all__ = [
    "PrecisionPolicy",
    "RunConfig",
    "Equation",
    "GradDependentNonlinear",
    "GP",
    "GPGradDependentNonlinear",
    "MLP",
    "MLPFullHistory",
    "ScaSML",
    "ScaSMLFullHistory",
]
