"""Where the package puts JAX's persistent compilation cache, each case in a
fresh interpreter (the choice is made once, at import)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax, scasml_gp; "
         "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir(**env_overrides):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(env_overrides)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_cache_env_var_is_honoured(tmp_path):
    assert _cache_dir(JAX_COMPILATION_CACHE_DIR=str(tmp_path)) == str(tmp_path)


def test_cpu_runs_keep_no_cache():
    assert _cache_dir(JAX_PLATFORMS="cpu") == "None"


@pytest.mark.parametrize("platforms", [None, "cuda"])
def test_device_cache_path_is_fixed(platforms):
    env = {} if platforms is None else {"JAX_PLATFORMS": platforms}
    first, second = _cache_dir(**env), _cache_dir(**env)
    assert first == second == os.path.join(REPO, ".jax_cache")
