"""Shared fixtures. NOTE: no XLA_FLAGS here on purpose — smoke tests and
benches must see the real (1-device) platform. Multi-device tests run
in subprocesses that force their own host-device counts (see
tests/test_distributed.py and tests/test_sharded.py)."""
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; the test skips itself "
        "when none is present")
