"""Test harness configuration.

The suite runs on the CPU with float64 enabled (the reference is float64
numpy) and an 8-device virtual CPU mesh for the sharding tests.  These must
be set before JAX starts, hence this conftest; the in-process
``jax_platforms`` update also holds when the environment names another
platform.  ``MARLPDE_TEST_PLATFORM=gpu`` leaves JAX on the GPU in float32 for
the ``gpu``-marked tests (``MARLPDE_TEST_PLATFORM=gpu python -m pytest -m gpu
tests/test_chip_checks.py``), which skip everywhere else.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("MARLPDE_TEST_PLATFORM") != "gpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided here, at test time,
    never at import: every xdist worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run by chip_smoke.py, or by "
                    "MARLPDE_TEST_PLATFORM=gpu python -m pytest -m gpu "
                    "tests/test_chip_checks.py")
