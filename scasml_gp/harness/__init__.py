from scasml_gp.harness.base import HarnessBase
from scasml_gp.harness.metrics import (
    error_metrics,
    paired_t_tests,
    summarize,
    valid_mask,
)
from scasml_gp.harness.simple_uniform import SimpleUniform
from scasml_gp.harness.repeated import RepeatedExperiment
from scasml_gp.harness.convergence_rate import ConvergenceRate
from scasml_gp.harness.inference_scaling import InferenceScaling
from scasml_gp.harness.simple_scaling import SimpleScaling
from scasml_gp.harness.computing_budget import ComputingBudget
from scasml_gp.harness.runner import HARNESSES, build_solvers, run

__all__ = [
    "HarnessBase",
    "error_metrics",
    "paired_t_tests",
    "summarize",
    "valid_mask",
    "SimpleUniform",
    "RepeatedExperiment",
    "ConvergenceRate",
    "InferenceScaling",
    "SimpleScaling",
    "ComputingBudget",
    "HARNESSES",
    "build_solvers",
    "run",
]
