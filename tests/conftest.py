"""Test config: force an 8-device virtual CPU platform so multi-device
sharding logic is exercised without accelerator hardware (SURVEY.md §4 test
strategy). Tests that need the GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them here; ``python chip_smoke.py``
covers each of them on the card."""

import os

# Must be set before jax import anywhere in the test process. Force CPU even
# if the machine has a GPU — tests exercise logic and multi-device sharding
# on the virtual 8-device CPU platform.
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from coala_gnn.graph.datasets import synthetic_graph


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (reference-scale or multi-epoch)")
    config.addinivalue_line(
        "markers", "gpu: needs the GPU; skips on the CPU test platform")


@pytest.fixture
def gpu_device():
    """The first GPU device, or skip: decided when the test runs, never at
    import or collection time, so every test worker collects the same
    tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs the GPU (python chip_smoke.py runs this check "
                    "on the card)")
    return gpus[0]


@pytest.fixture(scope="session")
def small_dataset():
    return synthetic_graph(num_nodes=2000, avg_degree=10, feature_dim=32,
                           num_classes=8, seed=7)


@pytest.fixture(scope="session")
def tiny_dataset():
    return synthetic_graph(num_nodes=300, avg_degree=6, feature_dim=16,
                           num_classes=4, seed=3)


@pytest.fixture
def rng():
    return np.random.default_rng(0)
