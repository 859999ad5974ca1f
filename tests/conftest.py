"""Test harness configuration.

All tests run on a virtual 8-device CPU mesh so DP/CP/solver collectives are
exercised without accelerator hardware (SURVEY §4 test strategy).  Must set
XLA flags before jax import.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# A pytest plugin (jaxtyping) may import jax BEFORE this conftest runs,
# freezing the environment's platform choice; force the CPU again
# post-import so no test runs on an accelerator.
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


REFERENCE_DEMO = "/root/reference/demoImages"


def has_demo_images() -> bool:
    return os.path.isdir(REFERENCE_DEMO)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
