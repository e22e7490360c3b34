"""Attribute the d>=40 reference-parity accuracy gap (VERDICT.md Next-round #1).

Round-1 finding: at reference-parity hyperparameters our exact-kernel GP is
~10-15% WORSE in rel-L2 than the reference at d>=40 (e.g. 0.2964 vs 0.2667 at
d=80), outside the 10-rep CIs. Candidate causes, each now a config toggle:

  (a) the reference's biased frozen-subset Hutchinson Laplacian + coordinate
      roll (models/GP.py:28-39,91-94)  ->  GPConfig.laplacian='subset'
  (b) the reference's fp16 quantization of Gram blocks / factor
      (models/GP.py:43,258-266)        ->  GPConfig.parity_fp16=True
  (c) sampler/RNG differences (deepxde vs jax.random)  ->  bounded by the
      across-seed spread measured here.

Protocol (mirrors reference tests/RepeatedExperiment.py): train the GP once
per (d, mode) on 1000+200 points (GN_steps=20, seed 1234), then evaluate
rel-L2 on 10 fresh 1000+200 test sets (seeds 42..51); also run quadrature
ScaSML (n=rho=2) per rep for the pure modes. Writes
reports/parity_experiment.json.

Run from the repository root:
  python scripts/parity_experiment.py
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scasml_gp.config import GPConfig
from scasml_gp.equations.grad_dependent import GradDependentNonlinear
from scasml_gp.gp.solver import GPGradDependentNonlinear
from scasml_gp.picard.scasml import ScaSML

DIMS = [40, 60, 80]
MODES = {
    "exact": GPConfig(),
    "subset": GPConfig(laplacian="subset"),
    "exact_fp16": GPConfig(parity_fp16=True),
    "subset_fp16": GPConfig(laplacian="subset", parity_fp16=True),
}
# reference 10-rep GP / SCaSML means (BASELINE.md, quadrature)
REF_GP = {40: 0.18445, 60: 0.23369, 80: 0.26671}
REF_SC = {40: 0.094986, 60: 0.13166, 80: 0.16045}
N_REPS = 10
SCASML_MODES = ("exact", "subset")  # rollout attribution for the pure modes


def rel_l2(pred, exact):
    pred = np.asarray(pred).reshape(-1)
    exact = np.asarray(exact).reshape(-1)
    mask = np.isfinite(pred)
    return float(
        np.linalg.norm(pred[mask] - exact[mask]) / np.linalg.norm(exact[mask])
    )


def main():
    out = {"dims": {}, "ref_gp": REF_GP, "ref_scasml": REF_SC}
    for d in DIMS:
        eq = GradDependentNonlinear(n_input=d + 1)
        x_dom, x_bdy = eq.generate_data(1000, 200, key=jax.random.PRNGKey(1234))
        test_sets = []
        for i in range(N_REPS):
            xt_d, xt_b = eq.generate_test_data(
                1000, 200, key=jax.random.PRNGKey(42 + i)
            )
            xt = jnp.concatenate([xt_d, xt_b], axis=0)
            test_sets.append((xt, eq.exact_solution(xt)[:, 0]))

        dim_out = {}
        for mode, cfg in MODES.items():
            t0 = time.time()
            gp = GPGradDependentNonlinear(eq, cfg)
            gp.GPsolver(x_dom, x_bdy)
            train_s = time.time() - t0
            gp_errs = [rel_l2(gp.predict(xt)[:, 0], ex) for xt, ex in test_sets]
            row = {
                "gp_rel_l2_mean": float(np.mean(gp_errs)),
                "gp_rel_l2_std": float(np.std(gp_errs)),
                "gp_rel_l2": gp_errs,
                "train_seconds": train_s,
            }
            if mode in SCASML_MODES:
                sc = ScaSML(eq, gp)
                sc_errs = []
                for rep, (xt, ex) in enumerate(test_sets):
                    u = sc.u_solve(2, 2, xt)
                    sc_errs.append(rel_l2(u[:, 0], ex))
                row["scasml_rel_l2_mean"] = float(np.mean(sc_errs))
                row["scasml_rel_l2_std"] = float(np.std(sc_errs))
                row["scasml_rel_l2"] = sc_errs
            dim_out[mode] = row
            print(
                f"d={d} {mode:12s} GP {row['gp_rel_l2_mean']:.4f}"
                f"±{row['gp_rel_l2_std']:.4f}"
                + (
                    f"  SCaSML {row['scasml_rel_l2_mean']:.4f}"
                    if "scasml_rel_l2_mean" in row
                    else ""
                )
                + f"  (ref GP {REF_GP[d]:.4f})  [{train_s:.0f}s train]",
                flush=True,
            )
        out["dims"][str(d)] = dim_out
        os.makedirs("reports", exist_ok=True)
        with open("reports/parity_experiment.json", "w") as f:
            json.dump(out, f, indent=2)
    print("wrote reports/parity_experiment.json")


if __name__ == "__main__":
    main()
