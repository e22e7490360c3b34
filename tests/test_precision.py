"""PrecisionPolicy and MeshConfig wiring tests (VERDICT.md Next-round #3).

The policy must be REAL: bf16 Gram operands / bf16 rollout path storage must
change dtypes on the hot buffers while staying within Monte-Carlo error of the
fp32 path, and a config-driven mesh run must actually place arrays sharded.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scasml_gp.config import (
    GPConfig,
    MeshConfig,
    PicardConfig,
    PrecisionPolicy,
    RunConfig,
)
from scasml_gp.equations import GradDependentNonlinear
from scasml_gp.gp import GPGradDependentNonlinear
from scasml_gp.gp.gram import gram_matrix
from scasml_gp.harness.runner import build_solvers, run
from scasml_gp.picard.mlp import MLPFullHistory

D = 4
BF16 = PrecisionPolicy(gram="bfloat16", rollout="bfloat16")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_precision_policy_validation():
    with pytest.raises(ValueError):
        PrecisionPolicy(gram="float16")
    assert BF16.gram_dtype == jnp.bfloat16
    assert PrecisionPolicy().rollout_dtype == jnp.float32


def test_bf16_gram_close_to_fp32():
    eq = GradDependentNonlinear(n_input=D + 1)
    x_dom, x_bdy = eq.generate_data(48, 12, key=jax.random.PRNGKey(0))
    gamma = jnp.asarray((1.0, 1.0, 0.0), jnp.float32)
    K32 = np.asarray(gram_matrix(x_dom, x_bdy, gamma, D))
    K16 = np.asarray(gram_matrix(x_dom, x_bdy, gamma, D, "bfloat16"))
    assert K16.dtype == np.float32          # fp32 accumulation/storage
    assert _rel(K16, K32) < 2e-2            # bf16 operand rounding only


def test_bf16_gp_train_within_tolerance():
    """End-to-end GP train with the bf16 Gram policy lands close to fp32."""
    eq = GradDependentNonlinear(n_input=D + 1)
    key = jax.random.PRNGKey(1)
    x_dom, x_bdy = eq.generate_data(80, 16, key=key)
    x_test = eq.geometry().sample_domain(jax.random.PRNGKey(2), 128)
    exact = np.asarray(eq.exact_solution(x_test))

    errs = {}
    for name, prec in (("fp32", None), ("bf16", BF16)):
        gp = GPGradDependentNonlinear(eq, GPConfig(gn_steps=8), precision=prec)
        gp.GPsolver(x_dom, x_bdy)
        pred = np.asarray(gp.predict(x_test))
        errs[name] = _rel(pred, exact)
    # both fit; the bf16 degradation is a small fraction of the error itself
    assert errs["bf16"] < 0.5
    assert abs(errs["bf16"] - errs["fp32"]) < 0.25 * max(errs["fp32"], 1e-3)


def test_bf16_rollout_within_mc_error():
    """bf16 path storage changes the Picard estimate by less than its own
    Monte-Carlo spread."""
    eq = GradDependentNonlinear(n_input=D + 1)
    x_t = eq.geometry().sample_domain(jax.random.PRNGKey(3), 64)
    exact = np.asarray(eq.exact_solution(x_t))

    def err(prec, seed):
        s = MLPFullHistory(eq, precision=prec)
        s.key = jax.random.PRNGKey(seed)
        return _rel(np.asarray(s.u_solve(2, 2, x_t, M=4)), exact)

    e32 = [err(None, s) for s in range(3)]
    e16 = [err(BF16, s) for s in range(3)]
    spread = max(e32) - min(e32) + 1e-3
    assert abs(np.mean(e16) - np.mean(e32)) < max(3 * spread, 0.05), (e32, e16)


def test_mesh_config_places_arrays_sharded():
    """A config-driven mesh run actually shards: GP training points over
    'model', and the end-to-end result matches the single-device run."""
    config = RunConfig(
        dim=D, num_domain=64, num_boundary=16,
        gp=GPConfig(gn_steps=6),
        picard=PicardConfig(variant="full_history", M=2),
        mesh=MeshConfig(data=4, model=2),
    )
    eq, gp, mlp, scasml = build_solvers(config)
    assert gp.mesh is not None
    x_dom, x_bdy = eq.generate_data(64, 16, key=jax.random.PRNGKey(0))
    gp.GPsolver(x_dom, x_bdy)
    # placement: interior points sharded over 'model' (not fully replicated)
    spec = gp.state.x_dom.sharding.spec
    assert tuple(spec)[:1] == ("model",)
    sizes = {s.data.shape[0] for s in gp.state.x_dom.addressable_shards}
    assert sizes == {64 // 2}

    x_test = eq.geometry().sample_domain(jax.random.PRNGKey(1), 64)
    scasml.key = jax.random.PRNGKey(9)
    u_mesh = np.asarray(scasml.u_solve(2, 2, x_test, M=2))

    # single-device control with identical seeds
    config1 = dataclasses.replace(config, mesh=MeshConfig())
    eq1, gp1, _, sca1 = build_solvers(config1)
    gp1.GPsolver(x_dom, x_bdy)
    sca1.key = jax.random.PRNGKey(9)
    u_single = np.asarray(sca1.u_solve(2, 2, x_test, M=2))
    np.testing.assert_allclose(u_mesh, u_single, rtol=2e-3, atol=2e-4)


def test_runner_mesh_end_to_end(tmp_path):
    """run(config) with a non-trivial mesh completes and writes metrics."""
    config = RunConfig(
        dim=D,
        num_domain=64, num_boundary=16,
        test_domain=64, test_boundary=8,
        harness="SimpleUniform",
        save_path=str(tmp_path),
        gp=GPConfig(gn_steps=6),
        picard=PicardConfig(variant="full_history", M=2),
        mesh=MeshConfig(data=8, model=1),
        precision=BF16,
    )
    out = run(config)
    assert out["metrics"]["SCaSML"]["rel_L2"] < 1.0
