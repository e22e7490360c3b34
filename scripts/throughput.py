"""Sampling-throughput harness: 1 chip / virtual multi-chip scaling.

Measures the Picard rollout's generator-evaluation throughput (the
BASELINE.json "samples/sec/chip" metric) for the plain and GP-calibrated
solvers, and exercises the sharded pipeline on whatever devices exist:

  - on the card: per-card steady-state throughput;
  - on a virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N
    FORCE_CPU=1): compiles + runs the 'data'-sharded rollout, validating the
    multi-chip path end-to-end (wall-clock scaling on virtual devices is not
    meaningful; real multi-chip hardware is required for efficiency numbers).

Usage:
    python scripts/throughput.py [--d 100]
"""

import argparse
import json
import os
import sys
import time

import jax

if os.environ.get("FORCE_CPU"):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--d", type=int, default=100)
    parser.add_argument("--batch", type=int, default=1200)
    parser.add_argument("--n", type=int, default=3)
    parser.add_argument("--M", type=int, default=4)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()

    from scasml_gp.equations import GradDependentNonlinear
    from scasml_gp.parallel import make_mesh, make_sharded_picard_solve
    from scasml_gp.picard import MLPFullHistory
    from scasml_gp.picard.schedule import count_evaluations_full_history

    eq = GradDependentNonlinear(n_input=args.d + 1)
    solver = MLPFullHistory(eq)
    x_t = eq.geometry().sample_domain(jax.random.PRNGKey(0), args.batch)
    key = jax.random.PRNGKey(1)

    nevals = count_evaluations_full_history(args.n, args.M)
    devices = jax.devices()
    print(f"devices: {devices}", file=sys.stderr)

    # single-device steady state
    fn = solver._get_fn((args.n, args.M))
    out = jax.block_until_ready(fn(x_t, key, None))
    t0 = time.perf_counter()
    for i in range(args.reps):
        out = fn(x_t, jax.random.fold_in(key, i), None)
    jax.block_until_ready(out)
    t_single = (time.perf_counter() - t0) / args.reps
    rate = nevals * args.batch / t_single
    result = {
        "d": args.d, "batch": args.batch, "n": args.n, "M": args.M,
        "evals_per_call": int(nevals),
        "single_device_s": t_single,
        "gsamples_per_sec_per_device": rate / 1e9,
    }

    # sharded over all devices ('data' axis)
    if len(devices) > 1:
        mesh = make_mesh(data=len(devices), model=1)
        sharded = make_sharded_picard_solve(
            solver._build((args.n, args.M)), mesh
        )
        out = jax.block_until_ready(sharded(x_t, key, None))
        t0 = time.perf_counter()
        for i in range(args.reps):
            out = sharded(x_t, jax.random.fold_in(key, i), None)
        jax.block_until_ready(out)
        t_multi = (time.perf_counter() - t0) / args.reps
        result["n_devices"] = len(devices)
        result["sharded_s"] = t_multi
        result["scaling_efficiency"] = t_single / (t_multi * len(devices))

    print(json.dumps(result))


if __name__ == "__main__":
    main()
