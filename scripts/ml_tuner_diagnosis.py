"""Diagnose the d>=40 marginal-likelihood mis-selection (VERDICT round-4 #9).

reports/campaign_ml: the ML-fit GP ships rel-L2 0.162/0.258/0.328 at
d=40/60/80 vs 0.037/0.051/0.086 grid-tuned — despite the validation-guard
that selects among {base, grid seed, fitted candidates} by held-out
collocation score.  Since the grid winner IS in that table, the only way
the fit can ship something worse is if the fitted config *validates better
but tests worse* — Goodhart of the continuous optimizer on the single
fixed validation split — or if the profile-MAP objective steers candidates
somewhere the validation score cannot distinguish.

This script measures exactly that: at each d it runs the grid tuner and the
seeded ML fit, then evaluates EVERY candidate in the fit's table on (a) its
validation score (the selection metric), (b) a SECOND independent
collocation split (generalization of the selection metric), and (c) the
true test rel-L2 against the exact solution (the judge's metric).  The
output table shows which link breaks.

Usage (from the repository root):
    python scripts/ml_tuner_diagnosis.py \
        [--dims 40] [--out reports/ml_tuner_diagnosis.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, nargs="*", default=[40])
    ap.add_argument("--out", default="reports/ml_tuner_diagnosis.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from scasml_gp.config import GPConfig
    from scasml_gp.equations import GradDependentNonlinear
    from scasml_gp.gp import GPGradDependentNonlinear
    from scasml_gp.gp.marginal import fit_gp_marginal_likelihood
    from scasml_gp.gp.tuning import tune_gp, validation_score

    err = lambda *a: print(*a, file=sys.stderr, flush=True)
    out = {"dims": {}}

    for d in args.dims:
        eq = GradDependentNonlinear(n_input=d + 1)
        x_dom, x_bdy = eq.generate_data(1000, 200,
                                        key=jax.random.PRNGKey(1234))
        xt_dom, xt_bdy = eq.generate_test_data(
            1000, 200, key=jax.random.PRNGKey(42)
        )
        x_test = jnp.concatenate([xt_dom, xt_bdy], axis=0)
        exact = np.asarray(eq.exact_solution(x_test)).ravel()
        # second, independent validation split (generalization check of the
        # selection metric itself)
        xv_dom, xv_bdy = eq.generate_data(400, 80,
                                          key=jax.random.PRNGKey(777))

        grid = tune_gp(GPGradDependentNonlinear, eq, x_dom, x_bdy,
                       base=GPConfig(),
                       ridge_scales=(0.0, 10.0, 30.0, 100.0),
                       gamma_scales=(1.0, 0.3, 0.1, 0.05))
        err(f"d={d} grid winner: {grid.config.ridge_scale=} "
            f"{grid.config.gamma_scale=} val={grid.score:.3e}")

        fit = fit_gp_marginal_likelihood(
            GPGradDependentNonlinear, eq, x_dom, x_bdy, base=GPConfig(),
            seed_configs=(grid.config,),
        )
        rows = []
        for cfg, nlml, val in fit.table:
            gp = GPGradDependentNonlinear(eq, cfg)
            gp.GPsolver(x_dom, x_bdy)
            u = np.asarray(gp.predict(x_test)).ravel()
            test_rel = float(np.linalg.norm(u - exact)
                             / np.linalg.norm(exact))
            val2 = validation_score(gp, xv_dom, xv_bdy)
            row = {
                "gamma_scale": cfg.gamma_scale,
                "time_scale": cfg.time_scale,
                "ridge_scale": cfg.ridge_scale,
                "nugget": cfg.nugget,
                "nlml": None if nlml != nlml else float(nlml),
                "val_selection": float(val),
                "val_independent": float(val2),
                "test_rel_L2": test_rel,
            }
            rows.append(row)
            err(json.dumps(row))
        shipped = dataclasses.asdict(fit.config)
        out["dims"][str(d)] = {
            "grid_winner": {"ridge_scale": grid.config.ridge_scale,
                            "gamma_scale": grid.config.gamma_scale,
                            "val": grid.score},
            "shipped": {k: shipped[k] for k in
                        ("ridge_scale", "gamma_scale", "time_scale",
                         "nugget")},
            "table": rows,
        }
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
