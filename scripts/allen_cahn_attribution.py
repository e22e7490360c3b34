"""Attribute the Allen-Cahn collocation-GP divergence (VERDICT round-4 #1).

Round-4 campaign measured the space-time collocation GP (gp/solver.py
AllenCahnForm) at rel-L2 0.861 (d=20) / 1.229 (d=100) — worse than
predicting zero — while plain MLP sits at 0.02-0.06.  Hypotheses from the
verdict: (a) the cubic Newton landscape, (b) tuner mis-selection, (c)
prior-mean mismatch, (d) the same terminal-value ill-posedness proven for
HJB (gp/cole_hopf.py): diffusion reach sigma*sqrt(T) = sqrt(2*0.3) = 0.775
exceeds the box half-width 0.5, so interior values depend on terminal data
OUTSIDE the collocation box and the interior PDE rows cannot pin them down.

This script measures it the same way the HJB attribution did — a sampling-
box widening sweep.  If (a)/(b)/(c) were the cause, training on a widened
box (covering the diffusion-reachable terminal set) would not help either;
if (d) is the cause, widening should improve the GP monotonically up to
the reach and the error should stay far above the MLP level regardless
(the wider box dilutes a fixed point budget over an exponentially larger
volume — the HJB measurement: 27-150% over widen in [0, 3]).

Alongside, it measures the round-5 replacement surrogate
(gp/semigroup.py): the scattered-RBF semigroup fit (generic) and the exact
Bernstein-mixture semigroup (terminal structure), plus the grid-tuned
collocation row to exclude (b).

Usage (CPU is fine for d=20; d=100 collocation needs patience):
    JAX_PLATFORMS=cpu PYTHONPATH=/root/repo python \
        scripts/allen_cahn_attribution.py [--dim 20] [--widen-max 3.0]
Writes reports/allen_cahn_attribution.json (md summary by hand).
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=20)
    ap.add_argument("--n-dom", type=int, default=1000)
    ap.add_argument("--n-bdy", type=int, default=200)
    ap.add_argument("--widens", type=float, nargs="*",
                    default=[1.0, 1.55, 2.0, 2.55, 3.0])
    ap.add_argument("--out", default="reports/allen_cahn_attribution.json")
    ap.add_argument("--skip-tuned", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from scasml_gp.config import GPConfig
    from scasml_gp.equations import AllenCahn
    from scasml_gp.gp.semigroup import GPAllenCahnSemigroup
    from scasml_gp.gp.solver import GPAllenCahn
    from scasml_gp.harness.metrics import mc_reference_solution

    d = args.dim
    eq = AllenCahn(n_input=d + 1)
    sig = float(eq.sigma())
    reach = sig * math.sqrt(eq.T)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    log(f"d={d}  diffusion reach sigma*sqrt(T) = {reach:.3f} "
        f"vs box half-width {eq.radius}")

    # Test set ALWAYS on the original box.
    xt_dom, xt_bdy = eq.generate_test_data(500, 100,
                                           key=jax.random.PRNGKey(42))
    x_test = jnp.concatenate([xt_dom, xt_bdy], axis=0)
    a = mc_reference_solution(eq, x_test, seed=123).ravel()
    b = mc_reference_solution(eq, x_test, seed=456).ravel()
    ref = 0.5 * (a + b)
    oracle_rel = float(np.linalg.norm(a - b) / np.linalg.norm(ref))
    log(f"oracle half-run disagreement: {oracle_rel:.4f}")

    def rel(u):
        u = np.asarray(u).ravel()
        return float(np.linalg.norm(u - ref) / np.linalg.norm(ref))

    out = {
        "dim": d,
        "diffusion_reach": reach,
        "box_half_width": eq.radius,
        "oracle_half_run_disagreement": oracle_rel,
        "collocation_widening": [],
    }

    # -- collocation widening sweep --------------------------------------
    base_radius = eq.radius
    for widen in args.widens:
        eq.radius = base_radius * widen
        x_dom, x_bdy = eq.generate_data(args.n_dom, args.n_bdy,
                                        key=jax.random.PRNGKey(1234))
        eq.radius = base_radius
        gp = GPAllenCahn(eq, GPConfig(gn_steps=20))
        gp.GPsolver(x_dom, x_bdy)
        r = rel(gp.predict(x_test))
        out["collocation_widening"].append(
            {"widen": widen, "train_half_width": base_radius * widen,
             "rel_L2": r}
        )
        log(f"collocation widen={widen}: rel_L2 = {r:.4f}")

    # -- tuned collocation (excludes tuner mis-selection) ----------------
    if not args.skip_tuned:
        from scasml_gp.gp.tuning import tune_gp

        x_dom, x_bdy = eq.generate_data(args.n_dom, args.n_bdy,
                                        key=jax.random.PRNGKey(1234))
        t = tune_gp(GPAllenCahn, eq, x_dom, x_bdy, base=GPConfig(),
                    ridge_scales=(0.0, 10.0, 30.0, 100.0),
                    gamma_scales=(1.0, 0.3, 0.1, 0.05))
        gp = GPAllenCahn(eq, t.config)
        gp.GPsolver(x_dom, x_bdy)
        r = rel(gp.predict(x_test))
        out["collocation_tuned"] = {
            "config": {"ridge_scale": t.config.ridge_scale,
                       "gamma_scale": t.config.gamma_scale},
            "rel_L2": r,
        }
        log(f"collocation grid-tuned: rel_L2 = {r:.4f} ({t.config})")

    # -- round-5 semigroup surrogates ------------------------------------
    x_dom, x_bdy = eq.generate_data(args.n_dom, args.n_bdy,
                                    key=jax.random.PRNGKey(1234))
    for backend in ("rbf", "mixture"):
        gp = GPAllenCahnSemigroup(eq, terminal_backend=backend)
        gp.GPsolver(x_dom, x_bdy)
        r = rel(gp.predict(x_test))
        row = {"backend": backend, "rel_L2": r}
        if backend == "rbf":
            row["selected_width"] = float(gp.state.gamma[0])
            row["width_unit"] = gp._width_unit
        out[f"semigroup_{backend}"] = row
        log(f"semigroup {backend}: rel_L2 = {r:.4f}")

    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
