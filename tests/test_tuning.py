"""Validation-based hyperparameter selection tests."""

import jax
import numpy as np

from scasml_gp.config import GPConfig
from scasml_gp.equations import GradDependentNonlinear
from scasml_gp.gp import GPGradDependentNonlinear
from scasml_gp.gp.tuning import tune_gp, validation_score

D = 6


def test_tune_gp_selects_and_improves():
    eq = GradDependentNonlinear(n_input=D + 1)
    x_dom, x_bdy = eq.generate_data(150, 40, key=jax.random.PRNGKey(0))

    result = tune_gp(
        GPGradDependentNonlinear, eq, x_dom, x_bdy,
        base=GPConfig(gn_steps=8),
        ridge_scales=(0.0, 5.0),
        gn_steps=8,
    )
    assert len(result.table) == 2
    assert result.score == min(s for _, s in result.table)
    assert result.config.ridge_scale in (0.0, 5.0)

    # retraining the winner on full data must produce a working surrogate
    gp = GPGradDependentNonlinear(eq, result.config)
    gp.GPsolver(x_dom, x_bdy)
    x_test, _ = eq.generate_test_data(200, 1, key=jax.random.PRNGKey(1))
    pred = np.asarray(gp.predict(x_test)).ravel()
    exact = np.asarray(eq.exact_solution(x_test)).ravel()
    rel = np.linalg.norm(pred - exact) / np.linalg.norm(exact)
    assert rel < 0.3, rel


def test_validation_score_finite():
    eq = GradDependentNonlinear(n_input=D + 1)
    gp = GPGradDependentNonlinear(eq, GPConfig(gn_steps=6))
    x_dom, x_bdy = eq.generate_data(80, 20, key=jax.random.PRNGKey(2))
    gp.GPsolver(x_dom, x_bdy)
    v_dom, v_bdy = eq.generate_data(30, 10, key=jax.random.PRNGKey(3))
    score = validation_score(gp, v_dom, v_bdy)
    assert np.isfinite(score) and score >= 0


def test_tune_gp_distributed_backend():
    """tune_gp routes large-N candidates through the distributed dual-CG
    trainer (train_backend='distributed') and still picks a sensible
    candidate (same winner class as the dense tuner on the same data)."""
    import dataclasses

    import jax

    from scasml_gp.config import GPConfig
    from scasml_gp.equations import GradDependentNonlinear
    from scasml_gp.gp.solver import GPGradDependentNonlinear
    from scasml_gp.gp.tuning import tune_gp

    d = 6
    eq = GradDependentNonlinear(n_input=d + 1)
    # phi = 4N + Nb must divide the 8-device mesh now that candidates
    # train at FULL size (round 5): 4*120 + 32 = 512
    x_dom, x_bdy = eq.generate_data(120, 32, key=jax.random.PRNGKey(0))
    base = GPConfig(gn_steps=8, dist_gn_steps=8)

    dense = tune_gp(GPGradDependentNonlinear, eq, x_dom, x_bdy, base=base,
                    ridge_scales=(0.0, 30.0), train_backend="dense")
    dist = tune_gp(GPGradDependentNonlinear, eq, x_dom, x_bdy, base=base,
                   ridge_scales=(0.0, 30.0), train_backend="distributed")
    assert dense.config.ridge_scale == dist.config.ridge_scale
    # scores from the two trainers agree to a few percent (same objective,
    # CG-vs-Newton fixed points)
    for (cfg_a, sa), (cfg_b, sb) in zip(dense.table, dist.table):
        assert cfg_a == dataclasses.replace(cfg_b)
        assert abs(sa - sb) / max(abs(sa), 1e-12) < 0.2, (sa, sb)
