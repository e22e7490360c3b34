"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scasml_gp.config import GPConfig
from scasml_gp.equations import GradDependentNonlinear
from scasml_gp.gp import GPGradDependentNonlinear
from scasml_gp.parallel import (
    make_mesh,
    make_sharded_picard_solve,
    make_sharded_train_and_solve,
)
from scasml_gp.picard.core import build_full_history_uz
from scasml_gp.picard.mlp import MLPFullHistory
from scasml_gp.picard.scasml import ScaSMLFullHistory

D = 6


def test_mesh_shapes():
    mesh = make_mesh(data=4, model=2)
    assert mesh.shape == {"data": 4, "model": 2}
    mesh1 = make_mesh(model=2)  # data = -1 -> all remaining
    assert mesh1.shape["data"] * 2 == len(jax.devices())


def test_sharded_picard_matches_single_device():
    """The rollout is deterministic given the key, so the 'data'-sharded run
    must produce bitwise-identical (up to reduction order) results."""
    eq = GradDependentNonlinear(n_input=D + 1)
    solver = MLPFullHistory(eq)
    fn = solver._get_fn((2, 3))  # raw jitted uz fn
    x_t = jax.random.uniform(jax.random.PRNGKey(0), (64, D + 1),
                             minval=-0.4, maxval=0.4)
    key = jax.random.PRNGKey(7)

    single = np.asarray(fn(x_t, key, None))
    mesh = make_mesh(data=8, model=1)
    sharded = make_sharded_picard_solve(solver._build((2, 3)), mesh)
    multi = np.asarray(sharded(x_t, key, None))
    np.testing.assert_allclose(single, multi, rtol=1e-4, atol=1e-5)


def test_sharded_train_and_solve_end_to_end():
    """Full sharded pipeline (GP train on 'model' axis + ScaSML rollout on
    'data' axis) runs and improves on the raw MLP on a small problem."""
    eq = GradDependentNonlinear(n_input=D + 1)
    gp = GPGradDependentNonlinear(eq, GPConfig(gn_steps=8))
    scasml = ScaSMLFullHistory(eq, gp)
    mesh = make_mesh(data=4, model=2)

    x_dom, x_bdy = eq.generate_data(64, 16, key=jax.random.PRNGKey(0))
    x_test = eq.geometry().sample_domain(jax.random.PRNGKey(1), 64)
    step = make_sharded_train_and_solve(eq, gp, scasml, mesh, n=2, M=3,
                                        gn_steps=8)
    u = np.asarray(step(x_dom, x_bdy, x_test, jax.random.PRNGKey(2)))
    exact = np.asarray(eq.exact_solution(x_test))
    rel = np.linalg.norm(u - exact) / np.linalg.norm(exact)
    assert np.isfinite(u).all()
    assert rel < 0.5, rel


def test_graft_entry_contract():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (args[0].shape[0], 1)
    ge.dryrun_multichip(8)
