"""Common harness plumbing.

Every harness mirrors the reference contract (`__init__(equation, solver1,
solver2, solver3)` + `.test(save_path, ...)`, reference tests/*.py) where
solver1 is the GP surrogate, solver2 the plain MLP, solver3 ScaSML.  Outputs
per run: a ``<Harness>.log`` text log, a ``metrics.json``, and PDF figures —
the reference's artifact set minus wandb (optional here).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from scasml_gp.utils.logio import MaybeWandb, dump_json
from scasml_gp.utils.profiling import harness_profile


class HarnessBase:
    def __init__(self, equation, solver1, solver2, solver3, wandb: bool = False):
        self.equation = equation
        self.dim = equation.n_input - 1
        self.solver1 = solver1   # GP
        self.solver2 = solver2   # MLP
        self.solver3 = solver3   # ScaSML
        self.t0 = equation.t0
        self.T = equation.T
        self.wandb_enabled = wandb

    # ---- helpers ----
    def _workdir(self, save_path: str) -> str:
        path = os.path.join(save_path, type(self).__name__)
        os.makedirs(path, exist_ok=True)
        return path

    def _wandb(self) -> MaybeWandb:
        """Metric stream for this run (reference harnesses call ``wandb.log``
        20+ times each, e.g. tests/SimpleUniform.py:497-510). No-op unless
        the harness was built with ``wandb=True`` AND a wandb module imports."""
        return MaybeWandb(
            self.wandb_enabled,
            project="scasml-gp",
            name=f"{type(self.equation).__name__}_{self.dim}d_"
                 f"{type(self).__name__}",
        )

    def _profile(self, profile_dir: Optional[str], tag: str):
        """cProfile + XLA trace around the harness's solve phase (reference
        wraps every harness in cProfile: tests/SimpleUniform.py:57-58,143-149)."""
        return harness_profile(profile_dir, tag)

    def _test_points(self, num_domain: int, num_boundary: int, seed: int):
        """Concatenated (domain + boundary) test set and its exact solution
        (reference tests/SimpleUniform.py:84-87). PDEs without a closed form
        (Allen-Cahn) fall back to a deep multilevel-Picard reference solve
        whose own error is far below the solvers under test, so every
        harness runs on every registered equation."""
        dom, bdy = self.equation.generate_test_data(
            num_domain, num_boundary, key=jax.random.PRNGKey(seed)
        )
        x_test = jnp.concatenate([dom, bdy], axis=0)
        try:
            exact = np.asarray(self.equation.exact_solution(x_test), np.float64)
        except NotImplementedError:
            from scasml_gp.harness.metrics import mc_reference_solution

            # Two INDEPENDENT oracle runs: their averaged value is the
            # reference, and their relative disagreement bounds the oracle's
            # own error — recorded into metrics.json so an oracle-dominated
            # comparison is detectable instead of silent (ADVICE round-3 #3).
            a = mc_reference_solution(self.equation, x_test, seed=123)
            b = mc_reference_solution(self.equation, x_test, seed=456)
            exact = 0.5 * (a + b)
            denom = max(float(np.linalg.norm(exact)), 1e-30)
            half_rel = float(np.linalg.norm(a - b)) / denom
            # rel error of the 2-run mean ~ half the half-run disagreement
            self.oracle_consistency = {
                "half_run_rel_disagreement": half_rel,
                "oracle_rel_error_estimate": 0.5 * half_rel,
            }
            if half_rel > 0.05:
                print(
                    f"WARNING: MC-oracle half-run disagreement {half_rel:.3f}"
                    " — reported solver metrics may be oracle-dominated",
                    flush=True,
                )
        return x_test, exact

    def _train_points(self, num_domain: int, num_boundary: int, seed: int):
        return self.equation.generate_data(
            num_domain, num_boundary, key=jax.random.PRNGKey(seed)
        )

    @staticmethod
    def _timed(fn, *args, **kwargs):
        start = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        return out, time.perf_counter() - start

    def _dump(self, path: str, name: str, data: dict):
        oc = getattr(self, "oracle_consistency", None)
        if oc is not None and isinstance(data, dict):
            data = dict(data, oracle_consistency=oc)
        dump_json(os.path.join(path, name), data)
