import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

# Tests run on a virtual 8-device CPU mesh.  The tests marked `gpu` run
# on a card with JAX_PLATFORMS=cuda (see README); any other platform
# setting is pinned to the CPU here.
if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere "
        "(run with JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's backend is a GPU (decided here, when
    the test runs, never at import time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX's backend is "
                    f"{jax.default_backend()}")
    return jax.devices()[0]
