"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding tests use ``xla_force_host_platform_device_count`` to fake an
8-device mesh (SURVEY.md §4 "Implication for the new build").  Tests that
need the GPU carry the ``gpu`` marker and skip, from the ``gpu_device``
fixture, where none is present.
"""

import os

# CPU unless the caller names a platform before the first backend init (the
# on-card run of the `gpu` tests sets JAX_PLATFORMS=cuda,cpu).  The package
# keeps no compile cache under JAX_PLATFORMS=cpu.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip.  Decided when a test runs, never at import
    or collection, so every worker collects the same tests."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU: run on the card with "
                    "`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`")
    return devices[0]
