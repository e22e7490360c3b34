"""Headline timing: the reference's flagship solve on one GPU.

Workload (the reference's SimpleUniform d=20, BASELINE.md): train the GP on
1000+200 points, then time the ScaSML quadrature solve (n = rho = 2) over
1200 test points.  The reference takes 353.1 s for that solve
(results/.../20d/SimpleUniform/SimpleUniform.log); ``vs_baseline`` is the
ratio to it.

The solve is timed on the host clock, each run ending in block_until_ready,
as the median of k runs after a compiling warm-up.  Fails without a GPU.

Prints ONE JSON line:
    {"metric": ..., "value": ..., "unit": "s", "vs_baseline": ..., ...}
Side diagnostics (accuracy, train time) go to stderr.
"""

import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from scasml_gp.config import GPConfig
    from scasml_gp.equations import GradDependentNonlinear
    from scasml_gp.gp import GPGradDependentNonlinear
    from scasml_gp.picard import ScaSML
    from scasml_gp.utils.device import card_lines, device_record, require_gpu

    err = lambda *a: print(*a, file=sys.stderr, flush=True)
    devices = require_gpu()
    card = card_lines()[0]
    err("devices:", device_record(devices), "card:", card)

    d = 20
    eq = GradDependentNonlinear(n_input=d + 1)
    gp = GPGradDependentNonlinear(eq, GPConfig(gn_steps=20))
    x_dom, x_bdy = eq.generate_data(1000, 200, key=jax.random.PRNGKey(1234))
    t0 = time.perf_counter()
    gp.GPsolver(x_dom, x_bdy)
    jax.block_until_ready(gp.state.right_vector)
    err(f"GP train (incl. compile): {time.perf_counter() - t0:.2f}s")

    xt_dom, xt_bdy = eq.generate_test_data(1000, 200, key=jax.random.PRNGKey(42))
    x_test = jnp.concatenate([xt_dom, xt_bdy], axis=0)
    exact = np.asarray(eq.exact_solution(x_test)).ravel()

    solver = ScaSML(eq, gp)
    t0 = time.perf_counter()
    u = jax.block_until_ready(solver.u_solve(2, 2, x_test))
    err(f"ScaSML warm-up (incl. compile): {time.perf_counter() - t0:.2f}s")
    rel = np.linalg.norm(np.asarray(u).ravel() - exact) / np.linalg.norm(exact)
    err(f"ScaSML quad d=20 rel_L2: {rel:.4f} (reference: 0.0701, GP alone 0.1466)")

    k = 5
    samples = []
    for _ in range(k):
        t0 = time.perf_counter()
        jax.block_until_ready(solver.u_solve(2, 2, x_test))
        samples.append(time.perf_counter() - t0)
    t = float(np.median(samples))
    iqr = float(np.percentile(samples, 75) - np.percentile(samples, 25))
    err(f"solve samples (s): {samples} median={t:.6f} iqr={iqr:.6f}")

    baseline_s = 353.1  # reference wall-clock for the same solve (BASELINE.md)
    print(json.dumps({
        "metric": "scasml_quad_d20_solve_1200pts_wallclock",
        "value": t,
        "unit": "s",
        "vs_baseline": baseline_s / t,
        "median": t,
        "iqr": iqr,
        "k": k,
        "device": device_record(devices),
        "card": card,
    }))


if __name__ == "__main__":
    main()
