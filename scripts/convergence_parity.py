"""Reconstruct the reference's ConvergenceRate slopes and check ours against
them (VERDICT round-2 #6; BASELINE parity config 3).

The reference's own ConvergenceRate run is commented out in every driver
(``/root/reference/results*/Grad_Dependent_Nonlinear/*/experiment_run.py:73-75``),
so no reference-side slope exists in the checked-in logs.  The parity-mode GP
(``GPConfig(laplacian='subset')`` — closed-form reproduction of the
reference's biased frozen-subset Hutchinson Laplacian INCLUDING its
coordinate-roll quirk, ``gp/parity.py``; validated point-for-point in
``reports/parity_attribution.md``) lets us produce the reference-EQUIVALENT
slope on our own harness, then compare the default-mode (exact-Laplacian,
auto-tuned) slopes against it for "sign/magnitude match".

Protocol mirrors the reference harness (``tests/ConvergenceRate.py:48-158``):
N_dom = 100..1000, N_bdy = 20..200, rho = floor(log N / log log N),
log10-log10 least-squares slope of GP and ScaSML rel-L2 vs N.

Usage (from the repository root):
    python scripts/convergence_parity.py \
        [--dim 20] [--out reports/convergence_parity.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def run_mode(dim: int, mode: str, seed: int, sizes_domain=None,
             sizes_boundary=None):
    """One ConvergenceRate sweep. mode: 'parity' | 'default'."""
    import jax

    from scasml_gp.config import RunConfig
    from scasml_gp.equations import EQUATIONS
    from scasml_gp.harness.runner import GP_CLASSES, build_solvers

    config = RunConfig(dim=dim, harness="ConvergenceRate", seed=seed)
    if mode == "parity":
        # reference semantics: biased subset Laplacian + isotropic kernel,
        # no tuning (the reference has no tuner: models/GP.py:497-505 fixes
        # gamma at 0.25*d implicitly through its kernel constant)
        config = dataclasses.replace(
            config,
            gp=dataclasses.replace(
                config.gp, laplacian="subset", time_scale=1.0,
                ridge_scale=0.0, gamma_scale=1.0,
            ),
        )
    else:
        # flagless default path = auto-tuned ridge kernel (runner CLI
        # resolve_tune; scripts/run_all.py)
        from scasml_gp.gp.tuning import tune_gp

        eq = EQUATIONS[config.equation](n_input=config.n_input)
        x_dom, x_bdy = eq.generate_data(
            config.num_domain, config.num_boundary,
            key=jax.random.PRNGKey(config.seed),
        )
        tuned = tune_gp(
            GP_CLASSES[config.equation], eq, x_dom, x_bdy, base=config.gp,
            ridge_scales=(0.0, 10.0, 30.0, 100.0),
            gamma_scales=(1.0, 0.3, 0.1, 0.05),
        )
        print(f"  tuned: {tuned.config}", file=sys.stderr, flush=True)
        config = dataclasses.replace(config, gp=tuned.config)

    eq, gp, mlp, scasml = build_solvers(config)
    from scasml_gp.harness.convergence_rate import ConvergenceRate

    harness = ConvergenceRate(eq, gp, mlp, scasml)
    kwargs = {}
    if sizes_domain is not None:
        kwargs.update(sizes_domain=sizes_domain,
                      sizes_boundary=sizes_boundary)
    result = harness.test(
        f"results/convergence_parity/{mode}", seed=seed, make_plots=True,
        **kwargs,
    )
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dim", type=int, default=20)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--out", default="reports/convergence_parity.json")
    parser.add_argument("--small-n-only", action="store_true",
                        help="run ONLY the small-N default-mode sweep and "
                             "merge it into an existing --out file")
    parser.add_argument("--recheck-only", action="store_true",
                        help="recompute the pass criterion from the sweeps "
                             "already stored in --out (no runs) — used to "
                             "re-gate stored data after a criterion change")
    args = parser.parse_args(argv)

    out = {"dim": args.dim, "seed": args.seed}
    if args.recheck_only or args.small_n_only:
        import os

        if os.path.exists(args.out):
            with open(args.out) as fh:
                out = json.load(fh)
    else:
        for mode in ("parity", "default"):
            print(f"== mode {mode} ==", file=sys.stderr, flush=True)
            res = run_mode(args.dim, mode, args.seed)
            out[mode] = {
                "slopes": res["slopes"],
                "train_sizes": res["train_sizes"],
                "rel_L2": res["rel_L2"],
            }

    if not args.recheck_only:
        # Small-N default-mode sweep (VERDICT round-3 Next #9): below
        # N ~ 120 the auto-tuned default is NOT yet saturated, so its error
        # must decay at a reference-like rate — this turns the round-3
        # saturation PROSE argument ("default GP at N=120 already beats
        # parity mode at N=1200") into a measurement.
        print("== mode default, small N ==", file=sys.stderr, flush=True)
        res = run_mode(
            args.dim, "default", args.seed,
            sizes_domain=list(range(10, 110, 10)),
            sizes_boundary=list(range(2, 22, 2)),
        )
        out["default_small_n"] = {
            "slopes": res["slopes"],
            "train_sizes": res["train_sizes"],
            "rel_L2": res["rel_L2"],
        }

    # Pass criterion (BASELINE config 3, "slope sign/magnitude match"):
    # same sign, and |default| within a factor of 3 of |parity| OR steeper
    # (a steeper negative slope = faster convergence, strictly better).
    # The magnitude check uses the default mode's UNSATURATED region: the
    # small-N sweep where its error still decays (at N >= 120 the tuned
    # default has already converged past parity mode's N=1200 error, so the
    # large-N slope measures saturation, not rate).
    # The gate uses ONLY the small-N (unsaturated) slope: folding the large-N
    # slope in via min() would be selection on the favorable side — a default
    # mode that diverges at large N but decays at tiny N must not pass
    # (ADVICE round-4 #3).  The large-N slope is reported alongside,
    # unfolded, so saturation stays visible.
    checks = {}
    for solver in ("GP", "SCaSML"):
        sp = out["parity"]["slopes"][solver]
        sd = out["default"]["slopes"][solver]
        sd_small = out["default_small_n"]["slopes"][solver]
        same_sign = sp < 0 and sd_small < 0
        mag_ok = abs(sd_small) >= abs(sp) / 3.0
        checks[solver] = {
            "parity_slope": sp,
            "default_large_n_slope_reported_only": sd,
            "default_small_n_slope": sd_small,
            "same_sign": bool(same_sign),
            "magnitude_ok": bool(mag_ok),
            "pass": bool(same_sign and mag_ok),
        }
    out["checks"] = checks
    out["pass"] = all(c["pass"] for c in checks.values())

    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out["checks"], indent=2))
    print(f"PASS={out['pass']}  written: {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
