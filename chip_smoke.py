"""Bring-up check of the GP-train + ScaSML-solve path on the GPU.

Run from the root of a checkout:

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Phases on one card, in order:

- device: the first JAX device must be a GPU.  Prints JAX's version, the
  compile-cache directory, each card's name and power limit, and whether the
  native schedule builder or its Python fallback is in use.
- flagship: the runner CLI's flagless GradDependentNonlinear d=20
  quadrature SimpleUniform run (tune, train, solve at the reference sizes),
  gated against the committed 10-repetition rows; then a full-history (M=3)
  ScaSML solve on the same trained surrogate.
- precision: Gram assembly, the regularized factorization and the fused
  posterior at real widths against float64 references, at the default
  matmul precision and under ``jax.default_matmul_precision("highest")``.
- serve: checkpoint round trip of the flagship surrogate, then HTTP /predict
  and /solve requests checked against direct evaluation.
- largeN: the runner at d=100 with 8192+512 training points, which routes
  to the distributed dual-CG trainer, gated against the committed row.

``--four-cards`` runs only the paths that span cards, each beside its
one-card run: the large-N trainer on a (data=1, model=4) mesh, and the
'data'-sharded train-and-solve step on four cards.  It checks that the
large-N Gram and the solve's output really are split over the four.

Every phase prints its numbers on lines of their own; a failed check raises
and the script exits non-zero.  The last line of standard output is one JSON
object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np

from scasml_gp.config import GPConfig, PicardConfig, RunConfig
from scasml_gp.equations import GradDependentNonlinear
from scasml_gp.gp import GPGradDependentNonlinear
from scasml_gp.gp.gram import gram_matrix, regularized_factorization
from scasml_gp.gp.kernels import (
    DIV, DT, ID, LAP, PHI_OPS, PHI_SETS, PairStats, grad_coeffs, op_block,
    split_gamma,
)
from scasml_gp.gp.posterior import posterior_eval
from scasml_gp.harness import runner
from scasml_gp.harness.base import HarnessBase
from scasml_gp.utils.device import card_lines, device_record, require_gpu

ROOT = os.path.dirname(os.path.abspath(__file__))
REPORTS = os.path.join(ROOT, "reports")

# Accuracy gates: 1.5 x the committed 10-repetition RepeatedExperiment mean.
GATE_FACTOR = 1.5
FLAGSHIP_ROW = ("campaign/GradDependentNonlinear/20d/{variant}/"
                "RepeatedExperiment/metrics.json")
LARGE_N_ROW = ("campaign_largeN/GradDependentNonlinear/100d/full_history/"
               "RepeatedExperiment/metrics.json")

# Sizes: the reference's flagship (1000+200 training and test points at
# d=20), the large-N row (8192+512 training points at d=100), and a posterior
# at d=100 over 8192 points, the node-block width of a rollout.
FLAGSHIP = dict(dim=20, train=(1000, 200), test=(1000, 200), seed=1234)
LARGE_N = dict(dim=100, train=(8192, 512))
POSTERIOR = dict(dim=100, train=(1000, 200), points=8192)
PREDICT_REQUESTS = (100, 1000, 5000)   # 5000 is chunked through bucket 4096
SOLVE_REQUEST = (1000, 1024)           # points, the bucket they pad to

# Kernels chosen by the flagless tuner on the card (CHANGES.md): largeN
# passes its kernel explicitly, and --four-cards runs no tuner at all.
FLAGSHIP_KERNEL = dict(ridge_scale=300.0, gamma_scale=0.05)
LARGE_N_KERNEL = dict(ridge_scale=300.0, gamma_scale=0.3)

# Precision tolerances, each a max error relative to the reference's scale.
# True-fp32 arithmetic lands one to two orders of magnitude below each;
# TF32 operands (a 10-bit mantissa) land above.
GRAM_TOL = 1e-5        # Gram, equilibrated to a unit diagonal
FACTOR_TOL = 5e-3      # C K_pert - I, equilibrated; an fp32 inverse: 1e-2
POSTERIOR_TOL = 1e-4   # u, grad, dt_u, div_u, lap_u vs max |reference|
SERVE_TOL = 1e-5       # served vs direct evaluation, same programs and keys
# Four cards vs one, each a relative 2-norm difference.  Readings (my chip
# run, PR 1; 4x H100 80GB HBM3, 700 W): right_vector identical, predictions
# 2.2e-6, the 'data'-sharded train+solve 8.9e-7.  Four virtual CPU devices,
# whose reductions run in another order, read 2.8e-4 on the weights of the
# toy problem in tests/test_chip_smoke.py: the dual-CG iterates amplify
# rounding in the weights (fixed only up to K's near-null space) far more
# than in what they predict.  Each tolerance is about five times the larger
# reading.
FOUR_CARD_WEIGHTS_TOL = 1e-3
FOUR_CARD_PREDICT_TOL = 1e-5
FOUR_CARD_SOLVE_TOL = 5e-6


class SmokeFailure(AssertionError):
    """A check of the smoke run failed."""


def check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def committed_mean(row: str, solver: str) -> float:
    """The committed 10-repetition rel-L2 mean of ``solver`` in ``row``."""
    with open(os.path.join(REPORTS, row)) as fh:
        return float(json.load(fh)["metrics"]["rel_L2"][solver]["mean"])


def gate(label: str, value: float, row: str, solver: str) -> None:
    limit = GATE_FACTOR * committed_mean(row, solver)
    say(f"  {label} rel_L2 {value:.6g}  limit {limit:.6g}")
    check(np.isfinite(value) and value <= limit,
          f"{label} rel_L2 {value} exceeds {limit}")


def rel_l2(u, exact) -> float:
    u = np.asarray(u, np.float64).ravel()
    exact = np.asarray(exact, np.float64).ravel()
    return float(np.linalg.norm(u - exact) / np.linalg.norm(exact))


def max_rel_err(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref))
                 / np.max(np.abs(ref)))


def run_runner(argv):
    """What ``runner.main(argv)`` does, returning the (eq, gp, mlp, scasml)
    the run built, so later phases reuse the trained surrogate."""
    config, extra = runner.configure(argv)
    solvers = runner.build_solvers(config)
    runner.run(config, solvers=solvers, **extra)
    return solvers


def check_row_sharded(label: str, a, cards: int) -> None:
    """``a`` lives on ``cards`` devices, each holding its 1/cards of the rows."""
    devices = a.sharding.device_set
    rows = sorted({s.data.shape[0] for s in a.addressable_shards})
    say(f"  {label}: {a.shape} on {len(devices)} device(s), {rows} rows each")
    check(len(devices) == cards and rows == [a.shape[0] // cards],
          f"{label} is not row-sharded over {cards} device(s)")


def read_metrics(save_path, equation, dim, variant, harness):
    path = os.path.join(save_path, equation, f"{dim}d", variant, harness,
                        "metrics.json")
    with open(path) as fh:
        return {k: v["rel_L2"] for k, v in json.load(fh)["metrics"].items()}


# ---------------------------------------------------------------- references
def exact_stats(x, y, gamma):
    """Pair statistics from float64 coordinate differences: no |x|^2+|y|^2
    -2x.y cancellation and no matmul precision involved.  Returned as the
    float32 PairStats the kernel blocks take."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    gs, gt, gr = (float(v) for v in split_gamma(gamma))
    xs, ys = x[:, :-1], y[:, :-1]
    q = np.zeros((x.shape[0], y.shape[0]))
    for i in range(xs.shape[1]):
        q += (xs[:, i][:, None] - ys[:, i][None, :]) ** 2
    s = xs.sum(1)[:, None] - ys.sum(1)[None, :]
    dt = x[:, -1][:, None] - y[:, -1][None, :]
    kappa = np.exp(-0.5 * (gs * q + gr * s * s + gt * dt * dt))
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return PairStats(kappa=f32(kappa), q=f32(q), s=f32(s), dt=f32(dt))


def gram_reference(x_dom, x_bdy, gamma, dim) -> np.ndarray:
    """The phi-phi Gram from exact pair statistics, float64."""
    pts = {"dom": x_dom, "bdy": x_bdy}
    st = {(a, b): exact_stats(pts[a], pts[b], gamma) for a in pts for b in pts}
    return np.concatenate([
        np.concatenate([
            np.asarray(op_block(a, b, st[(sa, sb)], gamma, dim), np.float64)
            for b, sb in zip(PHI_OPS, PHI_SETS)
        ], axis=1)
        for a, sa in zip(PHI_OPS, PHI_SETS)
    ], axis=0)


def gram_error(K, K_ref) -> float:
    """max |K - K_ref| after equilibrating K_ref to a unit diagonal (the
    blocks differ in scale by O(d^2))."""
    d = np.sqrt(np.maximum(np.diag(K_ref), 1e-30))
    return float(np.max(np.abs(np.asarray(K, np.float64) - K_ref)
                        / d[:, None] / d[None, :]))


def factorization_error(K_pert, C) -> float:
    """max |D^(1/2) (C K_pert - I) D^(-1/2)|, D = diag(K_pert), in float64:
    the residual of the equilibrated inverse the factorization computes."""
    K_pert = np.asarray(K_pert, np.float64)
    d = np.sqrt(np.diag(K_pert))
    Ce = d[:, None] * np.asarray(C, np.float64) * d[None, :]
    Ke = K_pert / d[:, None] / d[None, :]
    return float(np.max(np.abs(Ce @ Ke - np.eye(K_pert.shape[0]))))


def posterior_reference(x, x_dom, x_bdy, r, gamma, dim) -> dict:
    """u, grad, dt_u, div_u and lap_u from the unfused kernel blocks
    (kernels.op_block / grad_coeffs, each verified against autodiff) on exact
    pair statistics, contracted with the weights in float64."""
    f64 = lambda a: np.asarray(a, np.float64)
    r = f64(r)
    n_dom, n_bdy = x_dom.shape[0], x_bdy.shape[0]
    r_id, r_bdy = r[:n_dom], r[n_dom:n_dom + n_bdy]
    rest = r[n_dom + n_bdy:]
    fams = [(ID, r_id), (LAP, rest[:n_dom]), (DT, rest[n_dom:2 * n_dom]),
            (DIV, rest[2 * n_dom:])]
    sd = exact_stats(x, x_dom, gamma)
    sb = exact_stats(x, x_bdy, gamma)
    ref = {}
    for a, name in ((ID, "u"), (DT, "dt_u"), (DIV, "div_u"), (LAP, "lap_u")):
        ref[name] = sum(f64(op_block(a, b, sd, gamma, dim)) @ rb
                        for b, rb in fams)
        ref[name] = ref[name] + f64(op_block(a, ID, sb, gamma, dim)) @ r_bdy
    xn = f64(x)
    g_sp = np.zeros((xn.shape[0], dim))
    g_t = np.zeros(xn.shape[0])
    for (b, rb), st, ys in [(f, sd, f64(x_dom)) for f in fams] + [
            ((ID, r_bdy), sb, f64(x_bdy))]:
        co = grad_coeffs(b, st, gamma, dim)
        w = f64(co.a_sp) * rb[None, :]
        g_sp += xn[:, :-1] * w.sum(1)[:, None] - w @ ys[:, :-1]
        g_sp += ((f64(co.b_s) * f64(st.s) + f64(co.c)) @ rb)[:, None]
        g_t += (f64(co.a_t) * f64(st.dt)) @ rb + f64(co.e) @ rb
    ref["grad"] = np.concatenate([g_sp, g_t[:, None]], axis=1)
    return ref


def host_time(fn, k: int = 5):
    """Median host-clock seconds of fn() over k runs after a warm-up, each
    ending in block_until_ready."""
    jax.block_until_ready(fn())
    runs = []
    for _ in range(k):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        runs.append(time.perf_counter() - t)
    return float(np.median(runs)), runs


# (label, jax.default_matmul_precision value): the default, then "highest"
PRECISION_MODES = (("default", None), ("highest", "highest"))


def in_mode(mode, fn):
    if mode is None:
        return fn()
    with jax.default_matmul_precision(mode):
        return fn()


# -------------------------------------------------------------------- phases
def phase_device(ctx):
    from scasml_gp.utils.native import get_lib

    devices = require_gpu()
    ctx["devices"] = devices
    say(f"  jax {jax.__version__}  devices {device_record(devices)}")
    say(f"  compile cache dir: {jax.config.jax_compilation_cache_dir}")
    cards = card_lines()
    for line in cards:
        say(line)
    ctx["card"] = cards[0]
    builder = "native" if get_lib() is not None else "python fallback"
    say(f"  schedule builder: {builder}")


def phase_flagship(ctx):
    with tempfile.TemporaryDirectory() as save:
        t = time.perf_counter()
        eq, gp, _, _ = run_runner([
            "--dim", str(FLAGSHIP["dim"]), "--variant", "quadrature",
            "--harness", "SimpleUniform", "--save-path", save,
            "--seed", str(FLAGSHIP["seed"]),
            "--num-domain", str(FLAGSHIP["train"][0]),
            "--num-boundary", str(FLAGSHIP["train"][1]),
            "--test-domain", str(FLAGSHIP["test"][0]),
            "--test-boundary", str(FLAGSHIP["test"][1]),
        ])
        wall = time.perf_counter() - t
        rel = read_metrics(save, "GradDependentNonlinear", FLAGSHIP["dim"],
                           "quadrature", "SimpleUniform")
    say(f"  tuned kernel: ridge_scale {gp.config.ridge_scale}  "
        f"gamma_scale {gp.config.gamma_scale}")
    say(f"  tune+train+solve {wall:.1f} s host clock on {ctx['card']}")
    row = FLAGSHIP_ROW.format(variant="quadrature")
    gate("flagship GP", rel["GP"], row, "GP")
    gate("flagship SCaSML", rel["SCaSML"], row, "SCaSML")
    say(f"  flagship MLP rel_L2 {rel['MLP']:.6g}")
    check(rel["SCaSML"] < rel["GP"] < rel["MLP"],
          f"expected SCaSML < GP < MLP, got {rel}")

    from scasml_gp.picard.scasml import ScaSMLFullHistory

    # the harness's own test set: seed + 1
    x_test, exact = HarnessBase(eq, gp, None, None)._test_points(
        *FLAGSHIP["test"], FLAGSHIP["seed"] + 1)
    t = time.perf_counter()
    solver = ScaSMLFullHistory(eq, gp)
    u = jax.block_until_ready(solver.u_solve(2, 2, x_test, M=3))
    say(f"  full-history solve {time.perf_counter() - t:.1f} s host clock")
    gate("flagship full-history SCaSML (M=3)", rel_l2(u, exact),
         FLAGSHIP_ROW.format(variant="full_history"), "SCaSML")
    ctx["eq"], ctx["gp"] = eq, gp


def phase_precision(ctx):
    st = ctx["gp"].state
    dim = ctx["eq"].dim
    K_ref = gram_reference(st.x_dom, st.x_bdy, st.gamma, dim)
    for label, mode in PRECISION_MODES:
        K = in_mode(
            mode, lambda: gram_matrix(st.x_dom, st.x_bdy, st.gamma, dim))
        err = gram_error(K, K_ref)
        say(f"  gram d={dim} phi={K_ref.shape[0]} {label}: {err:.3g}  "
            f"tol {GRAM_TOL:.0e}")
        check(err <= GRAM_TOL, f"gram {label} error {err}")

    K = gram_matrix(st.x_dom, st.x_bdy, st.gamma, dim)
    nugget = jnp.float32(ctx["gp"].nugget)
    for label, mode in PRECISION_MODES:
        K_pert, C = in_mode(mode, lambda: regularized_factorization(K, nugget))
        err = factorization_error(K_pert, C)
        say(f"  factorization phi={K.shape[0]} {label}: {err:.3g}  "
            f"tol {FACTOR_TOL:.0e}")
        check(err <= FACTOR_TOL, f"factorization {label} error {err}")

    d, n = POSTERIOR["dim"], POSTERIOR["points"]
    eq = GradDependentNonlinear(n_input=d + 1)
    gp = GPGradDependentNonlinear(eq, GPConfig(**LARGE_N_KERNEL))
    x_dom, x_bdy = eq.generate_data(*POSTERIOR["train"],
                                    key=jax.random.PRNGKey(1234))
    gp.GPsolver(x_dom, x_bdy)
    s = gp.state
    x = eq.geometry().sample_domain(jax.random.PRNGKey(8), n)
    shape = f"d={d} n={n} N={x_dom.shape[0]}+{x_bdy.shape[0]}"
    ref = posterior_reference(x, s.x_dom, s.x_bdy, s.right_vector, s.gamma, d)

    def run():
        return posterior_eval(x, s.x_dom, s.x_bdy, s.right_vector, s.gamma,
                              d, want_grad=True, want_ops=True,
                              chunk=gp.eval_chunk)

    for label, mode in PRECISION_MODES:
        out = in_mode(mode, run)
        errs = {k: max_rel_err(getattr(out, k), ref[k]) for k in ref}
        say(f"  posterior {shape} {label}: "
            + "  ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"  tol {POSTERIOR_TOL:.0e}")
        check(max(errs.values()) <= POSTERIOR_TOL,
              f"posterior {label} errors {errs}")
    med, runs = host_time(run)
    say(f"  posterior {shape} (grad+ops): median {med:.6f} s "
        f"host clock over {len(runs)} runs on {ctx['card']}")


def _post(port, path, x):
    body = json.dumps({"points": np.asarray(x).tolist()}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return np.asarray(json.load(resp)["values"], np.float64)


def phase_serve(ctx):
    from scasml_gp.picard.scasml import ScaSML
    from scasml_gp.serve import (
        SurrogateServer, load_surrogate, save_surrogate, serve_http,
    )

    eq, gp = ctx["eq"], ctx["gp"]
    st = gp.state
    with tempfile.TemporaryDirectory() as ckpt:
        save_surrogate(ckpt, gp)
        served = load_surrogate(ckpt)
    server = SurrogateServer(served, ScaSML(eq, served))  # n = rho = 2
    httpd = serve_http(server, "127.0.0.1", 0)
    port = httpd.server_address[1]
    try:
        for n in PREDICT_REQUESTS:
            x = eq.geometry().sample_domain(jax.random.PRNGKey(n), n)
            got = _post(port, "/predict", x)[:, 0]
            want = posterior_eval(x, st.x_dom, st.x_bdy, st.right_vector,
                                  st.gamma, eq.dim).u
            err = max_rel_err(got, want)
            say(f"  /predict {n} points: max rel diff {err:.3g}  "
                f"tol {SERVE_TOL:.0e}")
            check(err <= SERVE_TOL, f"/predict {n} differs by {err}")

        n, bucket = SOLVE_REQUEST
        x = eq.geometry().sample_domain(jax.random.PRNGKey(11), n)
        got = _post(port, "/solve", x)[:, 0]
        direct = ScaSML(eq, gp)
        direct.key = jax.random.PRNGKey(server.solve_seed)
        x_pad = jnp.concatenate([x, jnp.repeat(x[-1:], bucket - n, axis=0)])
        want = np.asarray(direct.u_solve(2, 2, x_pad, num_valid=n))[:n, 0]
        err = max_rel_err(got, want)
        say(f"  /solve {n} points: max rel diff {err:.3g}  tol {SERVE_TOL:.0e}")
        check(err <= SERVE_TOL, f"/solve differs by {err}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    say(f"  server stats: {server.stats()}")


def large_n_config(save_path: str) -> RunConfig:
    return RunConfig(
        dim=LARGE_N["dim"], num_domain=LARGE_N["train"][0],
        num_boundary=LARGE_N["train"][1], test_domain=FLAGSHIP["test"][0],
        test_boundary=FLAGSHIP["test"][1], seed=FLAGSHIP["seed"],
        harness="SimpleUniform", save_path=save_path,
        gp=GPConfig(**LARGE_N_KERNEL),
        picard=PicardConfig(variant="full_history", M=3),
    )


def phase_large_n(ctx):
    with tempfile.TemporaryDirectory() as save:
        path = os.path.join(save, "config.json")
        with open(path, "w") as fh:
            fh.write(large_n_config(save).to_json())
        t = time.perf_counter()
        run_runner(["--config", path])
        wall = time.perf_counter() - t
        rel = read_metrics(save, "GradDependentNonlinear", LARGE_N["dim"],
                           "full_history", "SimpleUniform")
    say(f"  kernel {LARGE_N_KERNEL}; train+solve {wall:.1f} s host clock "
        f"on {ctx['card']}")
    gate("largeN GP", rel["GP"], LARGE_N_ROW, "GP")
    gate("largeN SCaSML", rel["SCaSML"], LARGE_N_ROW, "SCaSML")
    say(f"  largeN MLP rel_L2 {rel['MLP']:.6g}")


def phase_four_cards(ctx):
    from scasml_gp.gp.distributed import distributed_gpsolver
    from scasml_gp.parallel import make_mesh, make_sharded_train_and_solve
    from scasml_gp.picard.scasml import ScaSMLFullHistory

    devices = ctx["devices"]
    check(len(devices) >= 4, f"--four-cards needs 4 devices, has {len(devices)}")
    meshes = {"4 cards": make_mesh(data=1, model=4, devices=devices[:4]),
              "1 card": make_mesh(data=1, model=1, devices=devices[:1])}

    eq = GradDependentNonlinear(n_input=LARGE_N["dim"] + 1)
    x_dom, x_bdy = eq.generate_data(*LARGE_N["train"],
                                    key=jax.random.PRNGKey(FLAGSHIP["seed"]))
    x_test, exact = HarnessBase(eq, None, None, None)._test_points(
        *FLAGSHIP["test"], FLAGSHIP["seed"] + 1)
    out = {}
    for label, mesh in meshes.items():
        gp = GPGradDependentNonlinear(eq, GPConfig(**LARGE_N_KERNEL), mesh=mesh)
        check(gp._resolve_train_backend(x_dom, x_bdy) == "distributed",
              "large N must route to the distributed trainer")
        cfg = gp.config
        t = time.perf_counter()
        # the call GPsolver's large-N route makes; it also hands back K,
        # whose placement shows the run was really sharded
        _, K = distributed_gpsolver(
            gp, x_dom, x_bdy, mesh, gn_steps=cfg.dist_gn_steps,
            cg_tol=cfg.dist_cg_tol, cg_maxiter=cfg.dist_cg_maxiter)
        check_row_sharded("largeN Gram", K, mesh.size)
        del K
        pred = np.asarray(gp.predict(x_test))
        out[label] = (np.asarray(gp.state.right_vector), pred)
        say(f"  largeN train on {label}: {time.perf_counter() - t:.1f} s host "
            f"clock; GP rel_L2 {rel_l2(pred, exact):.6g}")
    (w4, p4), (w1, p1) = out["4 cards"], out["1 card"]
    dw = float(np.linalg.norm(w4 - w1) / np.linalg.norm(w1))
    dp = float(np.linalg.norm(p4 - p1) / np.linalg.norm(p1))
    say(f"  largeN 4 vs 1 card: right_vector rel diff {dw:.3g} tol "
        f"{FOUR_CARD_WEIGHTS_TOL:.0e}; predictions rel diff {dp:.3g} tol "
        f"{FOUR_CARD_PREDICT_TOL:.0e}")
    check(dw <= FOUR_CARD_WEIGHTS_TOL, f"right_vector differs by {dw}")
    check(dp <= FOUR_CARD_PREDICT_TOL, f"predictions differ by {dp}")

    eq = GradDependentNonlinear(n_input=FLAGSHIP["dim"] + 1)
    x_dom, x_bdy = eq.generate_data(*FLAGSHIP["train"],
                                    key=jax.random.PRNGKey(FLAGSHIP["seed"]))
    x_test, exact = HarnessBase(eq, None, None, None)._test_points(
        *FLAGSHIP["test"], FLAGSHIP["seed"] + 1)
    solves = {}
    data_meshes = {"4 cards": make_mesh(data=4, model=1, devices=devices[:4]),
                   "1 card": meshes["1 card"]}
    for label, mesh in data_meshes.items():
        gp = GPGradDependentNonlinear(eq, GPConfig(**FLAGSHIP_KERNEL),
                                      mesh=mesh)
        step = make_sharded_train_and_solve(
            eq, gp, ScaSMLFullHistory(eq, gp), mesh, n=2, M=3, gn_steps=20)
        t = time.perf_counter()
        u = jax.block_until_ready(
            step(x_dom, x_bdy, x_test, jax.random.PRNGKey(2)))
        check_row_sharded("sharded solve output", u, mesh.size)
        solves[label] = u = np.asarray(u)
        say(f"  sharded train+solve on {label}: {time.perf_counter() - t:.1f} s "
            f"host clock (incl. compile); SCaSML rel_L2 {rel_l2(u, exact):.6g}")
    du = float(np.linalg.norm(solves["4 cards"] - solves["1 card"])
               / np.linalg.norm(solves["1 card"]))
    say(f"  sharded solve 4 vs 1 card: rel diff {du:.3g} tol "
        f"{FOUR_CARD_SOLVE_TOL:.0e}")
    check(du <= FOUR_CARD_SOLVE_TOL, f"sharded solve differs by {du}")


PHASES = {
    "device": phase_device,
    "flagship": phase_flagship,
    "precision": phase_precision,
    "serve": phase_serve,
    "largeN": phase_large_n,
    "four_cards": phase_four_cards,
}


def select_phases(argv=None):
    """Phase names to run, in order, for the command line ``argv``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the paths that span four cards, each "
                         "beside its one-card run")
    args = ap.parse_args(argv)
    if args.four_cards:
        return ["device", "four_cards"]
    return ["device", "flagship", "precision", "serve", "largeN"]


def result_line(devices) -> str:
    """The last line of standard output: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": device_record(devices)})


def main(argv=None) -> None:
    ctx = {}
    for name in select_phases(argv):
        say(f"== {name}")
        t = time.perf_counter()
        PHASES[name](ctx)
        say(f"== {name} passed in {time.perf_counter() - t:.1f} s host clock")
    print(result_line(ctx["devices"]), flush=True)


if __name__ == "__main__":
    main()
