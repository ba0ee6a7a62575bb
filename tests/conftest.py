"""Test env: a virtual 8-device CPU mesh, pinned before JAX initializes.

Mirrors the reference's test approach of simulating multi-threadgroup GPU
execution serially on CPU (reference: CPUTests/*, e.g. RadixSortTest
main.cpp:9,140 loops over NUM_GRPS groups), but for real: the sharding
tests run the actual pjit/shard_map path over 8 virtual devices.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest

from raytracebvh_tpu.io.obj import load_obj
from raytracebvh_tpu.utils.assets import find_asset


def pytest_configure(config):
    """Tests run on the virtual CPU mesh, also on a machine with a GPU;
    only ``-m gpu`` (the card's own tests) leaves JAX its default
    platform.  Runs before any test module touches a backend."""
    if config.option.markexpr.strip() == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu tests/)")


@pytest.fixture(scope="session")
def rect_scene():
    path = find_asset("Rect.obj")
    if path is None:
        pytest.skip("Rect.obj asset not available")
    return load_obj(path)


@pytest.fixture(scope="session")
def test_scene():
    path = find_asset("Test.obj")
    if path is None:
        pytest.skip("Test.obj asset not available")
    return load_obj(path)
