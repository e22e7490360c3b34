"""Serving layer: checkpoint round-trip, static-shape bucketed batching,
and the stdlib HTTP front end (scasml_gp/serve.py). The reference has
no deployment subsystem at all (its trained GP dies with the process,
models/GP.py:191-192,600)."""

import json
import urllib.request

import jax
import numpy as np
import pytest

from scasml_gp.config import GPConfig
from scasml_gp.equations import SineNonlinear
from scasml_gp.gp.solver import GPSineNonlinear
from scasml_gp.picard import ScaSMLFullHistory
from scasml_gp.serve import (
    SurrogateServer,
    load_surrogate,
    save_surrogate,
    serve_http,
)

D = 4


@pytest.fixture(scope="module")
def trained_gp():
    eq = SineNonlinear(n_input=D + 1)
    gp = GPSineNonlinear(eq, GPConfig(gn_steps=8))
    x_dom, x_bdy = eq.generate_data(150, 40, key=jax.random.PRNGKey(0))
    gp.GPsolver(x_dom, x_bdy)
    return eq, gp


def test_checkpoint_round_trip(tmp_path, trained_gp):
    eq, gp = trained_gp
    path = str(tmp_path / "ckpt")
    save_surrogate(path, gp)
    gp2 = load_surrogate(path)
    assert type(gp2).__name__ == "GPSineNonlinear"
    assert gp2.config == gp.config
    x = eq.geometry().sample_domain(jax.random.PRNGKey(1), 64)
    np.testing.assert_allclose(
        np.asarray(gp2.predict(x)), np.asarray(gp.predict(x)), atol=1e-6
    )


def test_untrained_gp_refuses_checkpoint(tmp_path):
    eq = SineNonlinear(n_input=D + 1)
    gp = GPSineNonlinear(eq, GPConfig())
    with pytest.raises(ValueError, match="no trained state"):
        save_surrogate(str(tmp_path / "x"), gp)


def test_bucketed_predict_matches_direct(trained_gp):
    eq, gp = trained_gp
    server = SurrogateServer(gp, buckets=(64, 128))
    # 33 rows -> padded into the 64 bucket; per-row posterior is independent
    # of the padding, so values must match the direct call exactly
    x = eq.geometry().sample_domain(jax.random.PRNGKey(2), 33)
    np.testing.assert_allclose(
        server.predict(np.asarray(x)), np.asarray(gp.predict(x)), atol=1e-6
    )
    # 150 rows -> chunked through the 128 bucket (128 + padded 22)
    x = eq.geometry().sample_domain(jax.random.PRNGKey(3), 150)
    np.testing.assert_allclose(
        server.predict(np.asarray(x)), np.asarray(gp.predict(x)), atol=1e-6
    )
    st = server.stats()
    assert st["requests"] == 2 and st["rows"] == 183


def test_gradient_endpoint(trained_gp):
    eq, gp = trained_gp
    server = SurrogateServer(gp, buckets=(64,))
    x = eq.geometry().sample_domain(jax.random.PRNGKey(4), 17)
    out = server.gradient(np.asarray(x))
    assert out.shape == (17, D + 1)
    np.testing.assert_allclose(
        out, np.asarray(gp.compute_gradient(x)), atol=1e-6
    )


def test_solve_endpoint(trained_gp):
    eq, gp = trained_gp
    sca = ScaSMLFullHistory(eq, gp)
    server = SurrogateServer(gp, sca, buckets=(64,), n=2, rho=None, M=4)
    x = eq.geometry().sample_domain(jax.random.PRNGKey(5), 40)
    out = server.solve(np.asarray(x))
    assert out.shape == (40, 1) and np.isfinite(out).all()
    exact = np.asarray(eq.exact_solution(x))
    rel = np.linalg.norm(out - exact) / np.linalg.norm(exact)
    assert rel < 0.25, rel


def test_bad_shape_rejected(trained_gp):
    _, gp = trained_gp
    server = SurrogateServer(gp, buckets=(64,))
    with pytest.raises(ValueError, match="expected"):
        server.predict(np.zeros((4, D + 7), np.float32))


def test_http_front_end(trained_gp):
    eq, gp = trained_gp
    server = SurrogateServer(gp, buckets=(64,))
    httpd = serve_http(server, port=0)  # ephemeral port
    port = httpd.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r) == {"ok": True}

        x = np.asarray(eq.geometry().sample_domain(jax.random.PRNGKey(6), 9))
        req = urllib.request.Request(
            f"{base}/predict",
            data=json.dumps({"points": x.tolist()}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            values = np.asarray(json.load(r)["values"])
        np.testing.assert_allclose(
            values, np.asarray(gp.predict(x)), atol=1e-5
        )

        # malformed request -> 400 with an error message, server stays up
        bad = urllib.request.Request(
            f"{base}/predict", data=b'{"points": [[1, 2]]}',
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400

        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            assert json.load(r)["requests"] >= 1
    finally:
        httpd.shutdown()


def test_serve_mesh_sharded_surrogate(tmp_path, trained_gp):
    """A checkpoint trained anywhere can be served model-sharded: the
    reloaded GP gets a ('data','model') mesh and the bucketed server's
    predictions match the replicated ones."""
    from scasml_gp.parallel.mesh import make_mesh

    eq, gp = trained_gp
    path = str(tmp_path / "ckpt")
    save_surrogate(path, gp)
    gp_sharded = load_surrogate(path, mesh=make_mesh(1, 8))
    server = SurrogateServer(gp_sharded, buckets=(64,))
    x = eq.geometry().sample_domain(jax.random.PRNGKey(7), 50)
    np.testing.assert_allclose(
        server.predict(np.asarray(x)), np.asarray(gp.predict(x)), atol=2e-4
    )


def test_hjb_cole_hopf_checkpoint_round_trip(tmp_path):
    """The d>=100 HJB flagship surrogate (Cole-Hopf semigroup GP) must be
    servable: save/load round-trip preserves predictions (VERDICT round-3
    Next #5)."""
    from scasml_gp.equations import EQUATIONS
    from scasml_gp.gp.cole_hopf import GPHJBColeHopf

    eq = EQUATIONS["HJB"](n_input=D + 1)
    gp = GPHJBColeHopf(eq)
    x_dom, x_bdy = eq.generate_data(120, 30, key=jax.random.PRNGKey(0))
    gp.GPsolver(x_dom, x_bdy)
    path = str(tmp_path / "hjb_ckpt")
    save_surrogate(path, gp)
    gp2 = load_surrogate(path)
    assert type(gp2).__name__ == "GPHJBColeHopf"
    assert gp2.width == pytest.approx(gp.width)
    x = eq.geometry().sample_domain(jax.random.PRNGKey(1), 64)
    np.testing.assert_allclose(
        np.asarray(gp2.predict(x)), np.asarray(gp.predict(x)), atol=1e-6
    )
    # a reloaded surrogate serves the full calibrated solve
    sca = ScaSMLFullHistory(eq, gp2)
    server = SurrogateServer(gp2, sca, buckets=(64,), n=1, rho=None, M=2)
    out = server.solve(np.asarray(x))
    assert out.shape == (64, 1) and np.isfinite(out).all()


@pytest.mark.parametrize("backend", ["mixture", "rbf"])
def test_allen_cahn_semigroup_checkpoint_round_trip(tmp_path, backend):
    """Round-5 Allen-Cahn surrogate: both terminal backends round-trip
    through save/load (the manifest pins the backend — the two backends
    interpret GPState differently — and the rbf backend's selected width,
    so no re-selection happens against absent data)."""
    from scasml_gp.equations import EQUATIONS
    from scasml_gp.gp.semigroup import GPAllenCahnSemigroup

    eq = EQUATIONS["AllenCahn"](n_input=D + 1)
    gp = GPAllenCahnSemigroup(eq, terminal_backend=backend)
    x_dom, x_bdy = eq.generate_data(120, 30, key=jax.random.PRNGKey(0))
    gp.GPsolver(x_dom, x_bdy)
    path = str(tmp_path / f"ac_{backend}_ckpt")
    save_surrogate(path, gp)
    gp2 = load_surrogate(path)
    assert type(gp2).__name__ == "GPAllenCahnSemigroup"
    assert gp2.terminal_backend == backend
    x = eq.geometry().sample_domain(jax.random.PRNGKey(1), 64)
    np.testing.assert_allclose(
        np.asarray(gp2.predict(x)), np.asarray(gp.predict(x)), atol=1e-6
    )
    sca = ScaSMLFullHistory(eq, gp2)
    server = SurrogateServer(gp2, sca, buckets=(64,), n=1, rho=None, M=2)
    out = server.solve(np.asarray(x))
    assert out.shape == (64, 1) and np.isfinite(out).all()


def test_empty_request(trained_gp):
    eq, gp = trained_gp
    sca = ScaSMLFullHistory(eq, gp)
    server = SurrogateServer(gp, sca, buckets=(64,), n=1, rho=None, M=2)
    x = np.zeros((0, D + 1), np.float32)
    assert server.predict(x).shape == (0, 1)
    assert server.gradient(x).shape == (0, D + 1)
    assert server.solve(x).shape == (0, 1)


def test_concurrent_solve_matches_sequential(trained_gp):
    """N simultaneous /solve posts return exactly the sequential results:
    the endpoint lock serializes the shared RNG stream / stat counters, and
    deterministic mode reseeds per request (VERDICT round-3 Weak #7)."""
    import threading
    import urllib.error

    eq, gp = trained_gp
    sca = ScaSMLFullHistory(eq, gp)
    server = SurrogateServer(gp, sca, buckets=(32,), n=1, rho=None, M=2)
    keys = jax.random.split(jax.random.PRNGKey(11), 6)
    batches = [
        np.asarray(eq.geometry().sample_domain(k, 20)) for k in keys
    ]
    sequential = [server.solve(b) for b in batches]
    # repeated identical request is bitwise identical (deterministic mode)
    np.testing.assert_array_equal(server.solve(batches[0]), sequential[0])

    httpd = serve_http(server, port=0)
    port = httpd.server_address[1]
    results = [None] * len(batches)
    errors = []

    def post(i):
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/solve",
                data=json.dumps({"points": batches[i].tolist()}).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = np.asarray(json.load(r)["values"])
        except Exception as e:  # surface thread failures to the test
            errors.append(e)

    try:
        threads = [
            threading.Thread(target=post, args=(i,))
            for i in range(len(batches))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        for i, res in enumerate(results):
            np.testing.assert_allclose(res, sequential[i], atol=1e-6)
        st = server.stats()
        assert st["requests"] == len(batches) * 2 + 1
    finally:
        httpd.shutdown()


def test_guarded_solve_pad_mask():
    """Pad rows are masked out of the variance-guard shrink statistics
    (ADVICE round-3 #1): lambda from a padded batch with num_valid set
    equals lambda from the real rows alone."""
    import jax.numpy as jnp

    from scasml_gp.equations import GradDependentNonlinear
    from scasml_gp.gp.solver import GPGradDependentNonlinear
    from scasml_gp.picard import ScaSML

    eq = GradDependentNonlinear(n_input=D + 1)
    gp = GPGradDependentNonlinear(eq, GPConfig(gn_steps=4))
    x_dom, x_bdy = eq.generate_data(80, 20, key=jax.random.PRNGKey(0))
    gp.GPsolver(x_dom, x_bdy)
    sca = ScaSML(eq, gp, variance_guard=True)

    x = eq.geometry().sample_domain(jax.random.PRNGKey(3), 8)
    x_pad = jnp.concatenate([x, jnp.repeat(x[-1:], 24, axis=0)], axis=0)
    # synthetic rollout output: [u_breve, z..., var]; pad rows get huge
    # values that would dominate an unmasked batch statistic
    rng = np.random.default_rng(0)
    out = np.zeros((32, 1 + D + 1), np.float32)
    out[:, 0] = rng.normal(0.0, 0.05, 32)
    out[:, -1] = 1e-4
    out[8:, 0] = 50.0
    out[8:, -1] = 1e3

    sca._guarded_u(jnp.asarray(out), x_pad, num_valid=8)
    lam_masked = sca.last_lambda
    sca._guarded_u(jnp.asarray(out[:8]), x)
    lam_direct = sca.last_lambda
    assert lam_masked == pytest.approx(lam_direct, rel=1e-6)

    # unmasked would see the pad rows and produce a different lambda
    sca._guarded_u(jnp.asarray(out), x_pad)
    assert abs(sca.last_lambda - lam_direct) > 1e-3
