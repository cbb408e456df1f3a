"""Compressed execution on the port's sharded engine: the sharded mixed-tick
cases of ``tests/test_compressed_execution.py`` side by side with the JAX
package (its sharded join cases are in ``test_torch_compressed_join.py``).

The same harness as ``test_torch_compressed.py`` (encoded table, plain twin,
``repro.kernels.ref`` oracle; results equal the JAX engine's byte for byte,
every ``EngineStats`` field equal), here on ``ShardedEngine(num_shards=3 or
4)`` in both packages: the JAX one with ``revision="xla"``, as the
reference's cases, the port's on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
import test_compressed_execution as tce  # noqa: E402
from test_torch_compressed import (  # noqa: E402
    differential_mixed_tick,
    string_column_tick,
    zero_decodes_in_fused_pass,
)

SHARDED_CASES = [c for c in tce.CASES if c[1] is not None]


def test_sharded_case_census():
    assert len(SHARDED_CASES) == 12
    assert {shards for _, shards, _ in SHARDED_CASES} == {3, 4}


@pytest.mark.parametrize("revision,shards,seed", SHARDED_CASES)
def test_sharded_differential_mixed_tick(revision, shards, seed):
    differential_mixed_tick(revision, shards, seed)


def test_sharded_zero_decodes_in_fused_pass(monkeypatch):
    zero_decodes_in_fused_pass(monkeypatch, T.ShardedEngine(num_shards=4, device="cpu"))


def test_sharded_string_column_through_query_server_mixed_tick():
    """The string tick on 4 shards: one shared scan (one fused pass per
    shard), the group-by's per-code partials combined before the remap."""
    eng = T.ShardedEngine(num_shards=4, device="cpu")
    snap = string_column_tick(eng, shared_scans=1)
    assert snap["engine_collective_ops"] >= 1
    assert np.all(np.asarray(eng.shard_health()) == "healthy")
