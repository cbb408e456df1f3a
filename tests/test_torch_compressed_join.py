"""Compressed execution on the port: every join case of
``tests/test_compressed_execution.py`` (``JOIN_CASES``), single-device and
sharded, side by side with the JAX package.

Encoded equi-joins on one shared table-level dictionary: the raw-code probe
equals the plain-value probe and the ``repro.kernels.ref`` sort-probe
oracle, snapshot included, and the port's results and ``EngineStats`` equal
the JAX engine's (the harness of ``test_torch_compressed.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import test_compressed_execution as tce  # noqa: E402
from test_torch_compressed import differential_join  # noqa: E402


def test_join_case_census():
    assert len(tce.JOIN_CASES) == 22
    assert sum(shards is not None for _, shards, _ in tce.JOIN_CASES) == 6


@pytest.mark.parametrize("revision,shards,seed", tce.JOIN_CASES)
def test_differential_join(revision, shards, seed):
    differential_join(revision, shards, seed)
