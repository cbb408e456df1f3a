"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see 1 device by design;
multi-device tests spawn subprocesses with their own flag."""

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without a card")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _seed_numpy():
    np.random.seed(0)
