"""Attribute the one unexplained parity cell: MLP quadrature d=20
(ours 0.1660 +- .007 vs reference 0.1576; VERDICT round-2 #7).

Hypothesis chain, each variant isolating one reference RNG semantic
(reference solvers/MLP.py:167-179):

1. ``independent``  — our default: properly split terminal keys per node.
2. ``crn``          — the reference derives its terminal normals from
   PRNGKey(0) at EVERY tree node, so all nodes with the same (rows, mc)
   shape reuse identical draws.  This is accidental common-random-numbers
   coupling: sim_l and sim_{l-1} share terminal noise, the telescoped
   difference f(sim_l) - f(sim_{l-1}) loses variance (free MLMC coupling),
   AND the terminal noise realization is FROZEN across the 10 repetitions
   (the rep-mean keeps one draw's luck instead of averaging it out).
3. ``crn_fp16``     — additionally store paths in half precision like the
   reference's fp16 normal draws (path_dtype quantization).

Each variant runs the RepeatedExperiment protocol (fresh test sets, seeds
42+i, n = rho = 2, NaN-masked rel-L2) with MLP only — no GP involved.
More repetitions than the reference's 10 (default 30) to shrink the CI
below the 0.008 gap under test.

    python scripts/quadrature_parity.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from scasml_gp.equations import GradDependentNonlinear
from scasml_gp.harness.metrics import error_metrics, valid_mask
from scasml_gp.picard.mlp import MLP


def run_variant(tag, d, reps, num_domain, num_boundary, **mlp_kwargs):
    eq = GradDependentNonlinear(n_input=d + 1)
    solver = MLP(eq, **mlp_kwargs)
    vals = []
    for rep in range(reps):
        dom, bdy = eq.generate_test_data(
            num_domain, num_boundary, key=jax.random.PRNGKey(42 + rep)
        )
        x_test = jnp.concatenate([dom, bdy], axis=0)
        exact = np.asarray(eq.exact_solution(x_test), np.float64)
        sol = np.asarray(solver.u_solve(2, 2, x_test))
        mask = valid_mask(exact, sol)
        m = error_metrics(sol.reshape(-1)[mask], exact.reshape(-1)[mask])
        vals.append(m["rel_L2"])
    vals = np.asarray(vals, np.float64)
    out = {
        "variant": tag,
        "reps": reps,
        "mean": float(vals.mean()),
        "std": float(vals.std(ddof=1)),
        "sem": float(vals.std(ddof=1) / np.sqrt(reps)),
    }
    print(json.dumps(out), file=sys.stderr, flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=20)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--num-domain", type=int, default=1000)
    ap.add_argument("--num-boundary", type=int, default=200)
    ap.add_argument("--out", default="reports/quadrature_parity.json")
    ap.add_argument("--frozen-seeds", type=int, default=0,
                    help="additionally sweep K frozen terminal-noise "
                         "realizations (terminal_crn=seed) at 10 reps each "
                         "to measure the ACROSS-REALIZATION spread of the "
                         "reference's frozen estimator")
    args = ap.parse_args()

    from scasml_gp.config import PrecisionPolicy

    rows = [
        run_variant("independent", args.dim, args.reps, args.num_domain,
                    args.num_boundary),
        run_variant("crn", args.dim, args.reps, args.num_domain,
                    args.num_boundary, terminal_crn=True),
        run_variant("crn_fp16", args.dim, args.reps, args.num_domain,
                    args.num_boundary, terminal_crn=True,
                    precision=PrecisionPolicy(rollout="float16")),
        # round-4 combined faithful run (VERDICT round-3 Next #8): frozen
        # terminal CRN + fp16 draws + the reference's carried-delta_t z
        # denominators + per-level fp16 output quantization, in ONE rollout
        run_variant("combined_faithful", args.dim, args.reps,
                    args.num_domain, args.num_boundary, terminal_crn=True,
                    precision=PrecisionPolicy(rollout="float16"),
                    reference_semantics=True),
        # the structural estimator changes alone (carried-delta_t
        # denominators + per-level fp16 output quantization) with fp32
        # draws and independent keys: isolates structure from RNG freezing
        run_variant("ref_struct_only", args.dim, args.reps,
                    args.num_domain, args.num_boundary,
                    reference_semantics=True),
    ]
    out = {
        "dim": args.dim,
        "reference_mean_10rep": 0.15759,
        "round2_ours_10rep": {"mean": 0.1660, "std": 0.007},
        "variants": rows,
    }
    if args.frozen_seeds:
        # the reference's protocol: ONE frozen noise realization, 10 reps of
        # fresh test sets.  Sweeping the frozen seed measures how much the
        # resulting 10-rep mean itself scatters across realizations.
        sweep = [
            run_variant(f"frozen_seed_{s}", args.dim, 10, args.num_domain,
                        args.num_boundary, terminal_crn=s)
            for s in range(args.frozen_seeds)
        ]
        means = np.asarray([r["mean"] for r in sweep], np.float64)
        out["frozen_realization_sweep"] = {
            "per_seed": sweep,
            "mean_of_means": float(means.mean()),
            "std_of_means": float(means.std(ddof=1)),
            "min": float(means.min()),
            "max": float(means.max()),
        }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
