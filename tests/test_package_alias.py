"""The package's former name, kept at the repo root as an alias of
``scasml_gp``: it must resolve to the very same module objects."""

import importlib
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIASES = [m.name for m in pkgutil.iter_modules([REPO])
           if m.ispkg and m.name.startswith("scasml_gp_")]


def test_an_alias_is_kept():
    assert ALIASES


@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize("sub", ["", ".gp.solver", ".harness.runner"])
def test_alias_yields_the_same_modules(alias, sub):
    real = importlib.import_module("scasml_gp" + sub)
    spec = real.__spec__
    assert importlib.import_module(alias + sub) is real
    assert real.__spec__ is spec and real.__name__ == "scasml_gp" + sub
    assert sys.modules[alias + sub] is real


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_import_honours_the_cache_env_var(alias, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(JAX_COMPILATION_CACHE_DIR=str(tmp_path), PYTHONPATH=REPO)
    probe = (f"import jax, {alias}.gp.gram as g, scasml_gp.gp.gram as h; "
             "assert g is h; print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path)
