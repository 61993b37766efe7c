"""Test harness config.

Tests run on CPU with 8 virtual devices so the multi-device sharding paths
(``jax.sharding.Mesh`` + ``shard_map``) are exercised without GPU hardware.
The platform is pinned before jax initializes a backend, through the env
var and jax.config both, so an attached GPU is never picked up.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
