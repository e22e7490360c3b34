"""Harness-layer tests: each of the six harnesses runs end-to-end on a tiny
problem and produces the expected artifacts (log, metrics.json, PDFs)."""

import dataclasses
import json
import os

import pytest

from scasml_gp.config import GPConfig, PicardConfig, RunConfig
from scasml_gp.equations import GradDependentNonlinear
from scasml_gp.gp import GPGradDependentNonlinear
from scasml_gp.harness import (
    ComputingBudget,
    ConvergenceRate,
    InferenceScaling,
    RepeatedExperiment,
    SimpleScaling,
    SimpleUniform,
    run,
)
from scasml_gp.picard import MLP, MLPFullHistory, ScaSML, ScaSMLFullHistory

D = 3


def make_quad():
    eq = GradDependentNonlinear(n_input=D + 1)
    gp = GPGradDependentNonlinear(eq, GPConfig(gn_steps=6))
    return eq, gp, MLP(eq), ScaSML(eq, gp)


def make_fh():
    eq = GradDependentNonlinear(n_input=D + 1)
    gp = GPGradDependentNonlinear(eq, GPConfig(gn_steps=6))
    return eq, gp, MLPFullHistory(eq), ScaSMLFullHistory(eq, gp)


def _check_artifacts(base, harness_name, files):
    root = os.path.join(base, harness_name)
    for f in files:
        assert os.path.exists(os.path.join(root, f)), f
    with open(os.path.join(root, "metrics.json")) as fh:
        return json.load(fh)


def test_simple_uniform(tmp_path):
    h = SimpleUniform(*make_quad())
    out = h.test(str(tmp_path), rhomax=2, num_domain=80, num_boundary=16,
                 train_domain=60, train_boundary=16)
    m = _check_artifacts(tmp_path, "SimpleUniform",
                         ["SimpleUniform.log", "metrics.json",
                          "Error_Distribution.pdf", "GP_vs_SCaSML.pdf",
                          "Relative_L2_Improvement.pdf",
                          "GP_Spatiotemporal_Errors.pdf",
                          "MLP_Spatiotemporal_Errors.pdf",
                          "SCaSML_Spatiotemporal_Errors.pdf"])
    assert set(m["metrics"]) == {"GP", "MLP", "SCaSML"}
    assert out["metrics"]["SCaSML"]["rel_L2"] < 1.0


def test_repeated_experiment(tmp_path):
    h = RepeatedExperiment(*make_fh())
    out = h.test(str(tmp_path), rhomax=2, num_domain=60, num_boundary=12,
                 train_domain=60, train_boundary=16, num_repetitions=3, M=2)
    m = _check_artifacts(tmp_path, "RepeatedExperiment",
                         ["RepeatedExperiment.log", "metrics.json",
                          "RelL2_Repetitions.pdf"])
    assert m["num_repetitions"] == 3
    # full 9-test matrix: {rel_L2, L1, L2} x {GP-SCaSML, MLP-SCaSML, GP-MLP}
    # (reference tests/RepeatedExperiment.py:273-306)
    assert len(m["t_tests"]) == 9
    for metric in ("rel_L2", "L1", "L2"):
        for pair in ("GP_vs_SCaSML", "MLP_vs_SCaSML", "GP_vs_MLP"):
            assert f"{metric}:{pair}" in m["t_tests"]


def test_convergence_rate(tmp_path):
    h = ConvergenceRate(*make_quad())
    out = h.test(str(tmp_path), n_samples=60, gn_steps=6,
                 sizes_domain=[40, 80, 120], sizes_boundary=[8, 16, 24])
    _check_artifacts(tmp_path, "ConvergenceRate",
                     ["ConvergenceRate.log", "metrics.json",
                      "ConvergenceRate.pdf"])
    # errors should shrink with more data -> negative slope
    assert out["slopes"]["GP"] < 0.2


def test_inference_scaling(tmp_path):
    h = InferenceScaling(*make_quad())
    out = h.test(str(tmp_path), rhomax=2, n_samples=60, train_domain=60,
                 train_boundary=16, gn_steps=6)
    _check_artifacts(tmp_path, "InferenceScaling",
                     ["InferenceScaling.log", "metrics.json",
                      "InferenceScaling_Improvement.pdf"])
    assert len(out["improvement_pct"]) == 2
    assert out["evaluation_counter"][1] > out["evaluation_counter"][0]


def test_simple_scaling(tmp_path):
    h = SimpleScaling(*make_fh())
    out = h.test(str(tmp_path), max_base=3, n_samples=60, train_domain=60,
                 train_boundary=16, gn_steps=6)
    _check_artifacts(tmp_path, "SimpleScaling",
                     ["SimpleScaling.log", "metrics.json",
                      "SimpleScaling_Improvement.pdf"])
    assert out["sample_base"] == [2, 3]


def test_computing_budget(tmp_path):
    h = ComputingBudget(*make_quad())
    out = h.test(str(tmp_path), budget_levels=(1, 2), num_domain=60,
                 num_boundary=12, train_domain=60, train_boundary=16)
    _check_artifacts(tmp_path, "ComputingBudget",
                     ["ComputingBudget.log", "metrics.json",
                      "ComputingBudget_Errors.pdf",
                      "Improvement_Bar_Chart.pdf"])
    assert len(out["rel_L2"]["SCaSML"]) == 2


def test_wandb_stub_records_reference_keys(tmp_path, monkeypatch):
    """With a stub wandb module, a wandb=True harness run records the
    reference's metric-key families (tests/SimpleUniform.py:497-510) without
    any network access."""
    import sys
    import types

    logged = []
    uploaded = []
    stub = types.ModuleType("wandb")

    class _Artifact:
        def __init__(self, name, type="profile"):
            self.name = name
            self.files = []

        def add_file(self, path):
            self.files.append(path)

    stub.Artifact = _Artifact
    stub.init = lambda **kw: types.SimpleNamespace(
        **kw, log_artifact=lambda a: uploaded.append(a)
    )
    stub.log = lambda data: logged.append(data)
    stub.finish = lambda: None
    monkeypatch.setitem(sys.modules, "wandb", stub)

    prof_dir = str(tmp_path / "prof")
    h = SimpleUniform(*make_quad(), wandb=True)
    h.test(str(tmp_path), rhomax=2, num_domain=80, num_boundary=16,
           train_domain=60, train_boundary=16, make_plots=False,
           profile_dir=prof_dir)
    keys = {k for d in logged for k in d}
    assert any(k.startswith("mean of GP L2") for k in keys)
    assert any(k.startswith("p-value") for k in keys)
    assert any("positive count" in k for k in keys)
    # the cProfile dump must be uploaded as a wandb Artifact (reference
    # tests/SimpleUniform.py:147-149)
    assert len(uploaded) == 1
    assert uploaded[0].files[0].endswith("SimpleUniform_rho_2.prof")


def test_profile_dir_artifacts(tmp_path):
    """profile_dir produces the reference-style .prof dump plus an XLA trace
    directory (reference tests/SimpleUniform.py:57-58,143-149)."""
    prof_dir = str(tmp_path / "prof")
    h = SimpleUniform(*make_quad())
    h.test(str(tmp_path), rhomax=2, num_domain=80, num_boundary=16,
           train_domain=60, train_boundary=16, make_plots=False,
           profile_dir=prof_dir)
    assert os.path.exists(os.path.join(prof_dir, "SimpleUniform_rho_2.prof"))
    # the jax trace writes under <dir>/plugins/profile/...
    assert any(os.scandir(prof_dir))


def test_runner_auto_tune_policy():
    """CLI auto-tune default (VERDICT round-2 #2): flagless runs tune;
    explicit kernel flags, --no-tune, --fit-ml, or non-GPConfig equations
    opt out."""
    from scasml_gp.harness.runner import resolve_tune

    assert resolve_tune(None, 0.0, 1.0, False, "GradDependentNonlinear")
    # AllenCahn's semigroup surrogate selects its own terminal fit (round 5)
    assert not resolve_tune(None, 0.0, 1.0, False, "AllenCahn")
    # explicit flags win
    assert resolve_tune(True, 5.0, 1.0, False, "GradDependentNonlinear")
    assert not resolve_tune(False, 0.0, 1.0, False, "GradDependentNonlinear")
    # explicit kernel hyperparameters disable auto-tune
    assert not resolve_tune(None, 5.0, 1.0, False, "GradDependentNonlinear")
    assert not resolve_tune(None, 0.0, 2.0, False, "GradDependentNonlinear")
    # --fit-ml replaces the grid; HJB's Cole-Hopf GP tunes itself
    assert not resolve_tune(None, 0.0, 1.0, True, "GradDependentNonlinear")
    assert not resolve_tune(None, 0.0, 1.0, False, "HJB")


def test_runner_end_to_end(tmp_path):
    config = RunConfig(
        dim=D,
        num_domain=60, num_boundary=16,
        test_domain=60, test_boundary=12,
        harness="SimpleUniform",
        save_path=str(tmp_path),
        gp=GPConfig(gn_steps=6),
        picard=PicardConfig(variant="full_history", M=2),
    )
    out = run(config)
    assert out["metrics"]["SCaSML"]["rel_L2"] < 1.0
    assert os.path.exists(
        os.path.join(str(tmp_path), "GradDependentNonlinear", f"{D}d",
                     "full_history", "SimpleUniform", "metrics.json")
    )


def test_exact_solution_fallback_to_mc_reference():
    """Harnesses run on PDEs without a closed form: _test_points falls back
    to the deep-Picard MC reference (Allen-Cahn raises NotImplementedError
    from exact_solution)."""
    import numpy as np

    from scasml_gp.equations import AllenCahn
    from scasml_gp.harness.base import HarnessBase

    eq = AllenCahn(n_input=3)
    h = HarnessBase(eq, None, None, None)
    x_test, exact = h._test_points(24, 8, seed=0)
    assert x_test.shape == (32, 3) and exact.shape == (32, 1)
    assert np.isfinite(exact).all()
    # terminal rows must be near g (the MC reference is exact at t = T)
    g = np.asarray(eq.g(x_test[-8:]), np.float64)
    np.testing.assert_allclose(exact[-8:], g, atol=5e-2)


def test_runner_without_matplotlib(tmp_path, monkeypatch, capsys):
    """matplotlib is optional: with it unimportable the runner still writes
    metrics.json and the log, and reports the figures it skipped."""
    import sys

    from scasml_gp.harness.runner import main

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    out = main([
        "--dim", str(D), "--variant", "full_history", "--M", "2",
        "--no-tune", "--num-domain", "48", "--num-boundary", "12",
        "--test-domain", "40", "--test-boundary", "8",
        "--save-path", str(tmp_path),
    ])
    assert out["metrics"]["SCaSML"]["rel_L2"] < 1.0
    root = os.path.join(str(tmp_path), "GradDependentNonlinear", f"{D}d",
                        "full_history", "SimpleUniform")
    assert os.path.exists(os.path.join(root, "metrics.json"))
    assert os.path.exists(os.path.join(root, "SimpleUniform.log"))
    assert not [f for f in os.listdir(root) if f.endswith(".pdf")]
    assert "matplotlib not installed: skipped" in capsys.readouterr().err
