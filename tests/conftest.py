import os

# The tests run on the CPU with a virtual 8-device mesh for the sharding
# tests, even where a GPU is present: JAX_PLATFORMS=cpu pins JAX to XLA:CPU
# (set here unconditionally, before any backend initializes), and under it
# `--device gpu` runs the device programs on XLA:CPU.  Tests that need the
# card carry the `chip` marker and skip here.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import pytest
import numpy as np


@pytest.fixture(scope="session")
def fixtures_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)
