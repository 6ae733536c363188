"""Test harness config: run all tests on a virtual 8-device CPU mesh so the
multi-card sharding paths execute without GPUs.  The platform is the CPU
unless JAX_PLATFORMS names others; it is set through jax.config as well,
before any backend initializes.

Tests marked ``gpu`` need a card (``JAX_PLATFORMS=cuda,cpu python -m pytest
-m gpu tests/``): the ``gpu`` fixture decides at run time whether one is
present and skips otherwise (never at import or collection time, so every
xdist worker collects the same tests)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when no card is present."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run on the card: see README, 'Running on "
                    "the GPU')")
    return devs[0]
