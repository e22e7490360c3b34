"""Very-high-dimension runs (BASELINE.json config 5 stretch: d ~ 250).

Three demonstrations, none of which the reference can reach (its dims stop
at 80 and its ScaSML solve already takes 353 s at d=20):

  grad_dep   — GradDependentNonlinear at d=250 with the EXACT oracle:
               GP + MLP + ScaSML full-history rel-L2, optionally with the
               marginal-likelihood-fitted kernel (--fit-ml).
  allen_cahn — Allen-Cahn at d=250: GP + ScaSML vs a deep Picard MC
               reference (no closed form exists).
  hjb        — HJB at d=250: full-history MLP (variance-controlled
               estimators) vs the Cole-Hopf Monte-Carlo solution.

Usage:
    python scripts/high_dim.py \
        --equation grad_dep --dim 250 [--fit-ml] [--out reports/highdim]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, file=sys.stderr, flush=True)


def _rel(a, b):
    import numpy as np

    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def run_grad_dep(d: int, fit_ml: bool, n_test: int, n_train=1000, n_train_bdy=200, gn_steps=None):
    import jax
    import jax.numpy as jnp

    from scasml_gp.config import GPConfig
    from scasml_gp.equations import GradDependentNonlinear
    from scasml_gp.gp import GPGradDependentNonlinear
    from scasml_gp.picard import MLPFullHistory, ScaSMLFullHistory

    eq = GradDependentNonlinear(n_input=d + 1)
    x_dom, x_bdy = eq.generate_data(n_train, n_train_bdy, key=jax.random.PRNGKey(1234))
    cfg = GPConfig()
    if fit_ml:
        from scasml_gp.gp.marginal import fit_gp_marginal_likelihood

        t0 = time.perf_counter()
        fit = fit_gp_marginal_likelihood(
            GPGradDependentNonlinear, eq, x_dom, x_bdy, base=cfg,
            gn_steps=gn_steps,
        )
        cfg = fit.config
        log(f"fit-ml ({time.perf_counter() - t0:.1f}s): {cfg}")

    gp = GPGradDependentNonlinear(eq, cfg)
    t0 = time.perf_counter()
    gp.GPsolver(x_dom, x_bdy, GN_steps=gn_steps)
    jax.block_until_ready(gp.state.right_vector)
    t_train = time.perf_counter() - t0
    log(f"GP trained in {t_train:.1f}s")

    xt_dom, xt_bdy = eq.generate_test_data(n_test, n_test // 5,
                                           key=jax.random.PRNGKey(42))
    x_test = jnp.concatenate([xt_dom, xt_bdy], axis=0)
    exact = eq.exact_solution(x_test)

    u_gp = gp.predict(x_test)
    mlp = MLPFullHistory(eq)
    t0 = time.perf_counter()
    u_mlp = jax.block_until_ready(mlp.u_solve(2, None, x_test, M=3))
    t_mlp = time.perf_counter() - t0
    sca = ScaSMLFullHistory(eq, gp)
    t0 = time.perf_counter()
    u_sca = jax.block_until_ready(sca.u_solve(2, None, x_test, M=3))
    t_sca = time.perf_counter() - t0

    return {
        "equation": "GradDependentNonlinear",
        "d": d,
        "fit_ml": fit_ml,
        "gp_config": {"gamma_scale": cfg.gamma_scale,
                      "time_scale": cfg.time_scale,
                      "ridge_scale": cfg.ridge_scale, "nugget": cfg.nugget},
        "rel_L2": {"GP": _rel(u_gp, exact), "MLP": _rel(u_mlp, exact),
                   "SCaSML": _rel(u_sca, exact)},
        "wall_s": {"gp_train": round(t_train, 2),
                   "mlp_solve_incl_compile": round(t_mlp, 2),
                   "scasml_solve_incl_compile": round(t_sca, 2)},
        "n_test": int(x_test.shape[0]),
    }


def run_allen_cahn(d: int, fit_ml: bool, n_test: int, n_train=1000, n_train_bdy=200, gn_steps=None):
    import jax

    from scasml_gp.config import GPConfig
    from scasml_gp.equations import AllenCahn
    from scasml_gp.gp.solver import GPAllenCahn
    from scasml_gp.harness.metrics import mc_reference_solution
    from scasml_gp.picard import ScaSMLFullHistory

    eq = AllenCahn(n_input=d + 1)
    x_dom, x_bdy = eq.generate_data(n_train, n_train_bdy, key=jax.random.PRNGKey(1234))
    cfg = GPConfig()
    if fit_ml:
        from scasml_gp.gp.marginal import fit_gp_marginal_likelihood

        fit = fit_gp_marginal_likelihood(GPAllenCahn, eq, x_dom, x_bdy,
                                         base=cfg, gn_steps=gn_steps)
        cfg = fit.config
        log(f"fit-ml: {cfg}")
    gp = GPAllenCahn(eq, cfg)
    t0 = time.perf_counter()
    gp.GPsolver(x_dom, x_bdy, GN_steps=gn_steps)
    jax.block_until_ready(gp.state.right_vector)
    t_train = time.perf_counter() - t0
    log(f"GP trained in {t_train:.1f}s")

    x_test = eq.geometry().sample_domain(jax.random.PRNGKey(7), n_test)
    log("building MC reference (deep Picard)...")
    ref = mc_reference_solution(eq, x_test, n=3, M=8)

    u_gp = gp.predict(x_test)
    sca = ScaSMLFullHistory(eq, gp)
    u_sca = sca.u_solve(2, None, x_test, M=4)

    return {
        "equation": "AllenCahn",
        "d": d,
        "fit_ml": fit_ml,
        "rel_vs_mc_reference": {"GP": _rel(u_gp, ref),
                                "SCaSML": _rel(u_sca, ref)},
        "wall_s": {"gp_train": round(t_train, 2)},
        "n_test": n_test,
        "note": "no closed form; reference = full-history Picard n=3 M=8",
    }


def run_hjb(d: int, n_test: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from scasml_gp.equations import HJB
    from scasml_gp.picard import MLPFullHistory

    eq = HJB(n_input=d + 1)
    x = jax.random.uniform(jax.random.PRNGKey(2), (n_test, d), minval=-0.5,
                           maxval=0.5)
    t = jnp.full((n_test, 1), 0.1)
    x_t = jnp.concatenate([x, t], axis=1)
    exact = np.asarray(eq.exact_solution(x_t, num_mc=16384)).ravel()

    out = {"equation": "HJB", "d": d, "rel_L2_vs_cole_hopf": {}, "wall_s": {}}
    for n, M in [(1, 8), (2, 12), (3, 16)]:
        solver = MLPFullHistory(eq, batch_chunk=64)
        t0 = time.perf_counter()
        u = np.asarray(
            jax.block_until_ready(solver.u_solve(n, None, x_t, M=M))
        ).ravel()
        out["wall_s"][f"n{n}_M{M}"] = round(time.perf_counter() - t0, 2)
        out["rel_L2_vs_cole_hopf"][f"n{n}_M{M}"] = _rel(u, exact)
        log(f"HJB n={n} M={M}: rel {out['rel_L2_vs_cole_hopf'][f'n{n}_M{M}']:.4f}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--equation", default="grad_dep",
                        choices=["grad_dep", "allen_cahn", "hjb"])
    parser.add_argument("--dim", type=int, default=250)
    parser.add_argument("--n-test", type=int, default=500)
    parser.add_argument("--fit-ml", action="store_true")
    parser.add_argument("--train-size", type=int, default=1000)
    parser.add_argument("--gn-steps", type=int, default=None)
    parser.add_argument("--out", default="reports/highdim")
    args = parser.parse_args(argv)

    if args.equation == "grad_dep":
        result = run_grad_dep(args.dim, args.fit_ml, args.n_test,
                              args.train_size, max(args.train_size // 5, 8),
                              args.gn_steps)
    elif args.equation == "allen_cahn":
        result = run_allen_cahn(args.dim, args.fit_ml, args.n_test,
                                args.train_size, max(args.train_size // 5, 8),
                                args.gn_steps)
    else:
        result = run_hjb(args.dim, args.n_test)

    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.equation}_d{args.dim}" + ("_ml" if args.fit_ml else "")
    path = f"{args.out}/{tag}.json"
    with open(path, "w") as fh:
        json.dump(result, fh, indent=2)
    print(json.dumps(result))
    log(f"written: {path}")


if __name__ == "__main__":
    main()
