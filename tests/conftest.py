"""Test harness configuration: the CPU backend with 8 virtual devices, so
multi-device sharding is exercised without a GPU (the standard JAX
host-platform trick; SURVEY.md section 4 test plan).

Tests that need a CUDA GPU take the ``gpu`` fixture (and carry the ``gpu``
marker); the fixture skips them on any other backend.  To run them on a
card: ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a CUDA GPU (decided at test
    time, never at import: every xdist worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (the kernel has no interpret mode)")
    return jax.devices()[0]
