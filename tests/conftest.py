"""Test harness setup: force CPU with 8 virtual devices.

Multi-chip sharding paths are validated on a virtual CPU mesh
(xla_force_host_platform_device_count), per the repo's test strategy
(SURVEY.md section 4). Must run before jax is imported anywhere.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

# Also force the platform through the config API, in case jax was imported
# before this file ran (the env var alone would then be too late).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from sgtd_tpu.config import (  # noqa: E402
    CapacityConfig,
    SGTDConfig,
)


@pytest.fixture(scope="session")
def small_config() -> SGTDConfig:
    """Capacity-reduced config so CPU tests stay fast."""
    return SGTDConfig().replace(
        caps=CapacityConfig(
            max_nodes=64,
            max_descriptors=512,
            bucket_cap=32,
            hits_per_descriptor=8,
            pairs_per_candidate=128,
        )
    )


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(42)
