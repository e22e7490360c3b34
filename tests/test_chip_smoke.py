"""chip_smoke.py on the CPU: the device check, the last line, the gates, the
phase selection, and whether the precision tolerances tell fp32 from TF32."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from scasml_gp.config import GPConfig
from scasml_gp.equations import GradDependentNonlinear
from scasml_gp.gp import GPGradDependentNonlinear
from scasml_gp.gp.gram import gram_matrix
from scasml_gp.gp.posterior import posterior_eval
from scasml_gp.utils.device import require_gpu


def round_to_tf32(x):
    """fp32 values rounded to TF32's 10-bit mantissa (round half up on the
    dropped 13 bits), as a GPU's default-precision matmul sees its operands."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return jnp.asarray(bits.view(np.float32))


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        require_gpu()
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.phase_device({})


def test_last_line_has_exactly_the_contract_keys():
    line = chip_smoke.result_line(jax.devices())
    assert "\n" not in line
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}


def test_gates_read_the_committed_rows():
    mean = chip_smoke.committed_mean
    quad = chip_smoke.FLAGSHIP_ROW.format(variant="quadrature")
    fh = chip_smoke.FLAGSHIP_ROW.format(variant="full_history")
    assert mean(quad, "GP") == pytest.approx(0.0255, abs=1e-4)
    assert mean(quad, "SCaSML") == pytest.approx(0.0157, abs=1e-4)
    assert mean(fh, "SCaSML") == pytest.approx(0.0133, abs=1e-4)
    assert mean(chip_smoke.LARGE_N_ROW, "GP") == pytest.approx(0.0463, abs=1e-4)
    assert mean(chip_smoke.LARGE_N_ROW, "SCaSML") == pytest.approx(0.0320, abs=1e-4)
    limit = chip_smoke.GATE_FACTOR * mean(quad, "GP")
    chip_smoke.gate("at the limit", limit, quad, "GP")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.gate("above the limit", 1.01 * limit, quad, "GP")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.gate("not finite", float("nan"), quad, "GP")


@pytest.mark.parametrize("argv, phases", [
    ([], ["device", "flagship", "precision", "serve", "largeN"]),
    (["--four-cards"], ["device", "four_cards"]),
])
def test_phase_selection(argv, phases):
    assert chip_smoke.select_phases(argv) == phases
    assert set(phases) <= set(chip_smoke.PHASES)


@pytest.mark.parametrize("tf32, passes", [(False, True), (True, False)])
def test_gram_tolerance_tells_fp32_from_tf32(tf32, passes):
    d = 20
    eq = GradDependentNonlinear(n_input=d + 1)
    x_dom, x_bdy = eq.generate_data(60, 20, key=jax.random.PRNGKey(1234))
    gamma = jnp.asarray(GPGradDependentNonlinear(
        eq, GPConfig(ridge_scale=100.0, gamma_scale=0.1)).gamma, jnp.float32)
    K_ref = chip_smoke.gram_reference(x_dom, x_bdy, gamma, d)
    if tf32:
        x_dom, x_bdy = round_to_tf32(x_dom), round_to_tf32(x_bdy)
    err = chip_smoke.gram_error(gram_matrix(x_dom, x_bdy, gamma, d), K_ref)
    assert (err <= chip_smoke.GRAM_TOL) == passes, err


def test_posterior_reference_agrees_with_the_fused_posterior():
    d = 6
    eq = GradDependentNonlinear(n_input=d + 1)
    gp = GPGradDependentNonlinear(eq, GPConfig(gn_steps=6, ridge_scale=10.0))
    x_dom, x_bdy = eq.generate_data(40, 10, key=jax.random.PRNGKey(7))
    gp.GPsolver(x_dom, x_bdy)
    s = gp.state
    x = eq.geometry().sample_domain(jax.random.PRNGKey(8), 64)
    ref = chip_smoke.posterior_reference(x, s.x_dom, s.x_bdy, s.right_vector,
                                         s.gamma, d)
    out = posterior_eval(x, s.x_dom, s.x_bdy, s.right_vector, s.gamma, d,
                         want_grad=True, want_ops=True)
    for k, v in ref.items():
        assert chip_smoke.max_rel_err(getattr(out, k), v) <= chip_smoke.POSTERIOR_TOL, k


@pytest.mark.gpu
def test_precision_phase_on_card(gpu_device):
    """The Gram and posterior tolerances hold at the default matmul precision
    on the card (where a default fp32 matmul may run in TF32)."""
    d = 20
    eq = GradDependentNonlinear(n_input=d + 1)
    with jax.default_device(gpu_device):
        x_dom, x_bdy = eq.generate_data(400, 80, key=jax.random.PRNGKey(1234))
        gamma = jnp.asarray(GPGradDependentNonlinear(
            eq, GPConfig(ridge_scale=100.0, gamma_scale=0.1)).gamma, jnp.float32)
        K_ref = chip_smoke.gram_reference(x_dom, x_bdy, gamma, d)
        err = chip_smoke.gram_error(gram_matrix(x_dom, x_bdy, gamma, d), K_ref)
    assert err <= chip_smoke.GRAM_TOL, err


def test_four_card_phase_on_virtual_devices(monkeypatch, capsys):
    """--four-cards' comparison, on four virtual CPU devices at toy sizes:
    the large-N trainer and the 'data'-sharded solve really shard over four
    devices and agree with one within the phase's tolerances."""
    monkeypatch.setattr(chip_smoke, "LARGE_N", dict(dim=3, train=(64, 16)))
    monkeypatch.setattr(chip_smoke, "FLAGSHIP", dict(
        dim=3, train=(32, 8), test=(24, 8), seed=1234))
    monkeypatch.setattr(chip_smoke, "LARGE_N_KERNEL", dict(
        chip_smoke.LARGE_N_KERNEL, train_backend="distributed"))
    chip_smoke.phase_four_cards({"devices": jax.devices()[:4]})
    out = capsys.readouterr().out
    assert "largeN Gram: (272, 272) on 4 device(s), [68] rows each" in out
    assert "sharded solve output: (32, 1) on 4 device(s), [8] rows each" in out


def test_row_sharding_check_refuses_a_replicated_array():
    from scasml_gp.parallel import make_mesh
    from scasml_gp.parallel.mesh import replicated

    mesh = make_mesh(data=1, model=4, devices=jax.devices()[:4])
    a = jax.device_put(jnp.zeros((8, 2)), replicated(mesh))
    with pytest.raises(chip_smoke.SmokeFailure, match="not row-sharded"):
        chip_smoke.check_row_sharded("replicated", a, 4)


def test_run_runner_returns_the_surrogate_the_run_trained(tmp_path):
    eq, gp, mlp, scasml = chip_smoke.run_runner([
        "--dim", "3", "--variant", "full_history", "--M", "2", "--no-tune",
        "--num-domain", "48", "--num-boundary", "12", "--test-domain", "40",
        "--test-boundary", "8", "--save-path", str(tmp_path)])
    assert scasml.GP is gp and gp.state.x_dom.shape == (48, 4)
    rel = chip_smoke.read_metrics(str(tmp_path), "GradDependentNonlinear", 3,
                                  "full_history", "SimpleUniform")
    assert rel["SCaSML"] < 1.0
