"""Engine parity: the same op sequences on the JAX engine and the port's.

Both engines get tables built from the same numpy arrays and the same
writes; the JAX engine runs its Pallas kernels in interpret mode, the port's
runs on the CPU (``device="cpu"``, the kernels' plain versions).  Results
must match under the kernel tolerances (packed blocks, masks and counts
bit-equal, int32 sums exact), and every ``EngineStats`` field must be equal
except the counters of paths this slice does not port (``OUT_OF_SLICE``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402

# the sharded backend and fault tolerance are later slices
OUT_OF_SLICE = {"bytes_collective", "collective_ops", "retries", "failovers",
                "bytes_failover"}

N = 600


def columns(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return {f"A{i + 1}": rng.integers(-1000, 1000, n).astype(np.int32)
            for i in range(16)}


class Pair:
    """One table and one engine in each package, driven in lockstep."""

    def __init__(self, n=N, seed=0, schema_cols=None, codecs=None, **engine_kw):
        self.cols = schema_cols or columns(n, seed)
        self.j_schema = J.benchmark_schema(64, 4) if codecs is None else codecs[0]
        self.t_schema = T.benchmark_schema(64, 4) if codecs is None else codecs[1]
        self.jt = J.RelationalTable.from_columns(self.j_schema, self.cols)
        self.tt = T.RelationalTable.from_columns(self.t_schema, self.cols)
        self.je = J.RelationalMemoryEngine(**engine_kw)
        self.te = T.RelationalMemoryEngine(device="cpu", **engine_kw)

    def both(self, fn):
        """``fn(pkg, engine, table)`` on both sides; returns (jax, port)."""
        return fn(J, self.je, self.jt), fn(T, self.te, self.tt)

    def write(self, fn):
        fn(self.jt)
        fn(self.tt)
        np.testing.assert_array_equal(self.jt.words(), self.tt.words())

    def check(self, pair_of_results):
        jres, tres = pair_of_results
        assert len(jres) == len(tres)
        for j, t in zip(jres, tres):
            assert_same(j, t)
        self.check_stats()

    def check_stats(self):
        js = dataclasses.asdict(self.je.stats)
        ts = dataclasses.asdict(self.te.stats)
        assert set(js) == set(ts)
        diff = {k: (js[k], ts[k]) for k in js
                if k not in OUT_OF_SLICE and js[k] != ts[k]}
        assert not diff, diff


def assert_same(j, t):
    if isinstance(j, tuple):
        assert isinstance(t, tuple) and len(j) == len(t)
        for a, b in zip(j, t):
            assert_same(a, b)
        return
    want = np.asarray(j)
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert got.shape == want.shape
    if want.dtype == np.bool_:
        assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


def mixed_batch(pkg, eng, t, ts=None):
    b = pkg.BatchExecutor(eng)
    b.add_columns(t, ["A1", "A5", "A9", "A13"])
    b.add_columns(t, ["A1", "A5"])  # subsumed by the first view
    b.add_filter(t, ["A2", "A3"], "A4", "gt", 0, snapshot_ts=ts)
    b.add_filter(t, ["A2", "A3"], "A4", "gt", 0, snapshot_ts=ts)  # duplicate
    b.add_aggregate(t, "A6", "A7", "lt", 100, snapshot_ts=ts)
    b.add_groupby(t, "A16", "A8", 7, snapshot_ts=ts)
    return b.submit()


# ------------------------------------------------------------- solo ops
def test_solo_ops_match_jax():
    p = Pair()
    p.check(p.both(lambda pkg, e, t: [e.register(t, ["A2", "A9", "A10"]).packed()]))
    p.check(p.both(lambda pkg, e, t: e.execute_many(
        [pkg.FilterOp(e.register(t, ["A1", "A3"]), "A5", "lt", -20)])))
    p.check(p.both(lambda pkg, e, t: [e.aggregate(t, "A4", "A5", "gt", 7)]))
    p.check(p.both(lambda pkg, e, t: e.execute_many(
        [pkg.GroupByOp(t, "A1", "A2", 1000, "A3", "gt", -500)])))
    assert p.te.stats.shared_scans == 0 and p.te.stats.uploads == 1


def test_mixed_batch_dedupe_subsumption_and_hot_hit():
    p = Pair()
    p.check(p.both(lambda pkg, e, t: mixed_batch(pkg, e, t)))
    assert p.te.stats.shared_scans == 1 and p.te.stats.subsumed_requests == 1
    # both projections landed in the reorg cache: a second access is hot
    p.check(p.both(lambda pkg, e, t: [e.register(t, ["A1", "A5"]).packed(),
                                      e.register(t, ["A13", "A9", "A1", "A5"]).packed()]))
    assert p.te.stats.hot_hits == 2
    # a filter covered by a weaker one, a projection by a wider one
    p.check(p.both(lambda pkg, e, t: e.execute_many([
        pkg.FilterOp(e.register(t, ["A2", "A3", "A4"]), "A4", "gt", -10),
        pkg.FilterOp(e.register(t, ["A3"]), "A4", "gt", 50),
        pkg.ProjectOp(e.register(t, ["A11", "A12", "A14"])),
        pkg.ProjectOp(e.register(t, ["A12"])),
    ])))
    assert p.te.stats.subsumed_requests == 3


def test_writes_then_snapshot_batch_over_base_and_tail():
    p = Pair()
    p.check(p.both(lambda pkg, e, t: mixed_batch(pkg, e, t)))
    extra = columns(128, seed=5)
    p.write(lambda t: t.append(extra))
    p.write(lambda t: t.update(np.arange(10, 40), {"A1": np.full(30, 9, np.int32)}))
    p.write(lambda t: t.delete(np.arange(100, 160, 3)))
    ts = p.tt.now()
    # the project views were cached at N rows: now delta-served over the tail
    p.check(p.both(lambda pkg, e, t: mixed_batch(pkg, e, t, ts=ts)))
    assert p.te.stats.delta_hits >= 1 and p.te.stats.delta_uploads == 1
    assert len(p.te.rowstore.chunks(p.tt)) == 2
    p.check(p.both(lambda pkg, e, t: [e.aggregate(t, "A1", snapshot_ts=ts)]))
    # a later write leaves the pinned snapshot's answers unchanged
    p.write(lambda t: t.delete(np.arange(0, 600, 5)))
    p.check(p.both(lambda pkg, e, t: mixed_batch(pkg, e, t, ts=ts)))
    # the views read through the engine's device words
    p.check(p.both(lambda pkg, e, t: [e.register(t, ["A3", "A7"], snapshot_ts=ts)
                                      .column("A7"),
                                      e.valid_mask(t, ts)]))


def test_tail_chunks_compact_past_the_cap():
    p = Pair(n=300)
    p.check(p.both(lambda pkg, e, t: mixed_batch(pkg, e, t)))
    lengths = []
    for i in range(tengine.MAX_TAIL_CHUNKS + 1):
        p.write(lambda t, i=i: t.append(columns(17, seed=10 + i)))
        # a fused pass reads the chunk list as it is (a solo op would
        # coalesce it)
        p.check(p.both(lambda pkg, e, t: e.execute_many([
            pkg.AggregateOp(t, "A2", "A3", "gt", 0),
            pkg.GroupByOp(t, "A4", "A2", 3)])))
        lengths.append(len(p.te.rowstore.chunks(p.tt)))
    # one tail chunk per append, compacted device-side past the cap
    cap = tengine.MAX_TAIL_CHUNKS
    assert lengths == list(range(2, cap + 1)) + [1, 2]
    p.check(p.both(lambda pkg, e, t: mixed_batch(pkg, e, t, ts=t.now())))


def test_whole_table_uploads_without_delta():
    p = Pair(delta_uploads=False)
    p.check(p.both(lambda pkg, e, t: mixed_batch(pkg, e, t)))
    p.write(lambda t: t.append(columns(50, seed=3)))
    p.write(lambda t: t.delete(np.arange(5)))
    p.check(p.both(lambda pkg, e, t: mixed_batch(pkg, e, t, ts=t.now())))
    assert p.te.stats.delta_uploads == 0 and p.te.stats.uploads == 2


def test_vmem_guard_halves_the_modeled_tile():
    p = Pair(vmem_bytes=32 << 10)
    p.check(p.both(lambda pkg, e, t: mixed_batch(pkg, e, t)))
    assert p.te.stats.last_block_rows < 256


def test_encoded_columns_match_jax():
    """Dictionary and FOR columns: code-space predicates, FOR sums, dict
    group-by remap and decode-on-read."""
    rng = np.random.default_rng(7)
    spec = [("k", "int32", None, "dict"), ("s", "str", None, None),
            ("f", "int32", None, "for"), ("v", "int32", None, None)]
    schemas = tuple(pkg.TableSchema.of(*[pkg.Column(*c) for c in spec])
                    for pkg in (J, T))
    cols = {"k": rng.integers(-50, 50, N).astype(np.int32),
            "s": rng.choice(np.array(["ab", "cd", "ef", "gh"]), N),
            "f": rng.integers(10**6, 10**6 + 900, N).astype(np.int32),
            "v": rng.integers(-1000, 1000, N).astype(np.int32)}
    p = Pair(schema_cols=cols, codecs=schemas)
    np.testing.assert_array_equal(p.jt.words(), p.tt.words())
    p.check(p.both(lambda pkg, e, t: e.execute_many([
        pkg.GroupByOp(t, "k", "v", 7, "f", "gt", 10**6 + 300),
        pkg.GroupByOp(t, "s", "v", 4),
        pkg.FilterOp(e.register(t, ["k", "v"]), "k", "lt", 0),
    ])))
    p.check(p.both(lambda pkg, e, t: [e.aggregate(t, "v", "k", "gt", 5)]))
    p.check(p.both(lambda pkg, e, t: [e.execute_many([pkg.GroupByOp(t, "k", "f", 5)])[0]]))
    jv, tv = p.both(lambda pkg, e, t: e.register(t, ["k", "s", "f"]))
    for name in ("k", "f"):
        np.testing.assert_array_equal(tv.column(name).numpy(),
                                      np.asarray(jv.column(name)))
    np.testing.assert_array_equal(tv.column("s"), jv.column("s"))
    p.check_stats()


def test_unported_paths_raise():
    with pytest.raises(ValueError, match="ROADMAP"):
        T.RelationalMemoryEngine(revision="bsl", device="cpu")
    e = T.RelationalMemoryEngine(device="cpu")
    with pytest.raises(TypeError, match="scan op"):
        e.execute_many([object()])
