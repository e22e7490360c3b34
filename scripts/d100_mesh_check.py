"""d=100 InferenceScaling on the sharded path — virtual-mesh correctness leg.

BASELINE.json config 4 asks for InferenceScaling at d=100 with the MC sample
tree sharded over a mesh.  Multi-chip hardware is unavailable, so this leg
runs the harness twice on a virtual 8-device CPU mesh — once on a (4, 2)
('data', 'model') mesh, once unsharded — with identical seeds, and asserts
the improvement-vs-evaluations curves agree.  The full-size single-chip
accuracy leg runs on the card via the runner CLI
(scripts/d100_inference_scaling follows in reports/).

    python scripts/d100_mesh_check.py     # forces CPU + 8 virtual devices
"""

from __future__ import annotations

import json
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from scasml_gp.config import (  # noqa: E402
    GPConfig,
    MeshConfig,
    PicardConfig,
    RunConfig,
)
from scasml_gp.harness.runner import run  # noqa: E402


def main():
    base = dict(
        equation="GradDependentNonlinear",
        dim=100,
        harness="InferenceScaling",
        gp=GPConfig(gn_steps=8),
        picard=PicardConfig(variant="quadrature"),
        seed=1234,
    )
    kwargs = dict(rhomax=2, n_samples=160, train_domain=192,
                  train_boundary=32, gn_steps=8, make_plots=False)

    out_dir = "reports/d100_inference_scaling"
    os.makedirs(out_dir, exist_ok=True)

    res = {}
    for tag, mesh in (("mesh_4x2", MeshConfig(data=4, model=2)),
                      ("single", MeshConfig())):
        config = RunConfig(save_path=f"{out_dir}/{tag}", mesh=mesh, **base)
        res[tag] = run(config, **kwargs)
        print(tag, json.dumps(res[tag]["improvement_pct"]))

    a = np.asarray(res["mesh_4x2"]["improvement_pct"])
    b = np.asarray(res["single"]["improvement_pct"])
    max_diff = float(np.max(np.abs(a - b)))
    agree = bool(max_diff < 1.0)  # same seeds; only reduction order differs
    summary = {
        "config": "BASELINE config 4 correctness leg (virtual 8-device mesh)",
        "mesh": "4x2 (data, model)",
        "improvement_pct_mesh": a.tolist(),
        "improvement_pct_single": b.tolist(),
        "max_abs_diff_pct_points": max_diff,
        "agree_within_1pt": agree,
        "rel_L2_mesh": res["mesh_4x2"]["rel_L2"],
        "evaluation_counter": res["mesh_4x2"]["evaluation_counter"],
    }
    with open(f"{out_dir}/mesh_check.json", "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps(summary, indent=2))
    assert agree, max_diff


if __name__ == "__main__":
    main()
