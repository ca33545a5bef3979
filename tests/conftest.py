"""Test configuration: run everything on a virtual 8-device CPU mesh so that
sharding tests work without accelerator hardware and tests are hermetic."""
import os

# Force CPU even when the environment pre-registers an accelerator backend
# (JAX_PLATFORMS may already be set by the host; override, don't default).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
