"""The write-ahead log on the port: the cases of ``tests/test_wal.py`` on
both packages (recovered tables served by the single-device and the sharded
engine), and logs carried across.

A server crash may tear the WAL at any record boundary or corrupt its tail
record; recovery must rebuild, from the surviving prefix, a table whose
words, ``row_count`` and MVCC clock equal the live table's after exactly
that many writes, and the recovered table must serve identically.  The
record format is the reference's byte for byte: a log written by either
package recovers the same table in the other.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro.serve.query_server as JQ  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.serve.query_server as TQ  # noqa: E402


@dataclasses.dataclass
class Side:
    name: str
    core: object
    serve: object

    def engine(self):
        if self.core is J:
            return J.RelationalMemoryEngine(revision="xla")
        return T.RelationalMemoryEngine(device="cpu")

    def sharded_engine(self):
        if self.core is J:
            from repro.core.distributed import ShardedEngine
            return ShardedEngine(num_shards=2, revision="xla")
        return T.ShardedEngine(num_shards=2, device="cpu")

    def schema(self, strings=False):
        c = self.core
        cols = [c.Column("a", "int32"), c.Column("b", "int32"), c.Column("g", "int32")]
        if strings:
            cols.append(c.Column("s", "str"))
        return c.TableSchema(tuple(cols))


SIDES = (Side("jax", J, JQ), Side("port", T, TQ))
PKGS = pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)


def _cols(rng, n, strings=False):
    out = {"a": rng.integers(-100, 100, n).astype(np.int32),
           "b": rng.integers(0, 1000, n).astype(np.int32),
           "g": rng.integers(0, 8, n).astype(np.int32)}
    if strings:
        out["s"] = np.array(["x", "yy", "zzz"])[rng.integers(0, 3, n)]
    return out


def _state(t):
    return (t._words[: t.row_count].copy(), t.row_count, t._clock)


def logged_history(side, seed=0, strings=False):
    """A write workload through a WAL-attached server: the WAL, the live
    table, and its state after the checkpoint and after each write."""
    rng = np.random.default_rng(seed)
    t = side.core.RelationalTable.from_columns(side.schema(strings),
                                               _cols(rng, 40, strings))
    wal = side.core.WriteAheadLog()
    srv = side.serve.QueryServer(side.engine(), wal=wal)
    states = [_state(t)]

    def step(submit):
        submit()
        srv.drain()
        states.append(_state(t))

    step(lambda: srv.submit_insert(t, _cols(rng, 8, strings)))
    step(lambda: srv.submit_update(t, np.array([1, 5, 41], np.int64),
                                   {"b": np.array([7, 8, 9], np.int32)}))
    step(lambda: srv.submit_delete(t, np.array([0, 44], np.int64)))
    step(lambda: srv.submit_insert(t, _cols(rng, 3, strings)))
    step(lambda: srv.submit_update(t, np.array([2], np.int64),
                                   {"a": np.array([-1], np.int32)}))
    step(lambda: srv.submit_delete(t, np.array([3], np.int64)))
    assert wal.record_count == len(states)  # checkpoint + one per write
    snap = srv.snapshot()
    assert snap["wal_records"] == wal.record_count and snap["wal_bytes"] == wal.nbytes
    return wal, t, states


def assert_recovers_to(recovered, state):
    words, row_count, clock = state
    assert recovered is not None
    assert recovered.row_count == row_count
    assert recovered._clock == clock
    np.testing.assert_array_equal(recovered._words[:row_count], words)


@PKGS
class TestCrashRecovery:
    def test_truncation_at_every_record_boundary(self, side):
        wal, t, states = logged_history(side)
        bounds = wal.boundaries()
        assert len(bounds) == len(states) + 1
        for k, cut in enumerate(bounds):
            recovered = side.core.RelationalTable.recover(wal.truncated(cut), t.uid)
            if k == 0:
                assert recovered is None
            else:
                assert_recovers_to(recovered, states[k - 1])

    def test_truncation_inside_a_record_drops_the_torn_tail(self, side):
        wal, t, states = logged_history(side)
        bounds = wal.boundaries()
        for k in range(1, len(bounds)):
            recovered = side.core.RelationalTable.recover(
                wal.truncated(bounds[k] - 3), t.uid)
            if k == 1:
                assert recovered is None
            else:
                assert_recovers_to(recovered, states[k - 2])

    def test_corrupted_tail_checksum_recovers_prefix(self, side):
        wal, t, states = logged_history(side)
        recovered = side.core.RelationalTable.recover(wal.corrupted_tail(), t.uid)
        assert_recovers_to(recovered, states[-2])

    def test_full_log_replays_to_live_table(self, side):
        wal, t, states = logged_history(side, strings=True)
        recovered = side.core.RelationalTable.recover(wal, t.uid)
        assert_recovers_to(recovered, states[-1])
        assert recovered.codecs.keys() == t.codecs.keys() == {"s"}
        for ts in range(t._clock + 1):
            np.testing.assert_array_equal(recovered.snapshot_mask(ts),
                                          t.snapshot_mask(ts))

    def test_recover_ignores_other_tables_records(self, side):
        rng = np.random.default_rng(3)
        t1 = side.core.RelationalTable.from_columns(side.schema(), _cols(rng, 10))
        t2 = side.core.RelationalTable.from_columns(side.schema(), _cols(rng, 12))
        wal = side.core.WriteAheadLog()
        srv = side.serve.QueryServer(side.engine(), wal=wal)
        srv.submit_insert(t1, _cols(rng, 2))
        srv.submit_insert(t2, _cols(rng, 5))
        srv.drain()
        r1 = side.core.RelationalTable.recover(wal, t1.uid)
        r2 = side.core.RelationalTable.recover(wal, t2.uid)
        assert r1.row_count == 12 and r2.row_count == 17
        np.testing.assert_array_equal(r1.words(), t1.words())
        np.testing.assert_array_equal(r2.words(), t2.words())

    def test_file_backed_log_survives_reopen(self, side, tmp_path):
        path = tmp_path / "server.wal"
        rng = np.random.default_rng(4)
        t = side.core.RelationalTable.from_columns(side.schema(), _cols(rng, 20))
        wal = side.core.WriteAheadLog(path)
        srv = side.serve.QueryServer(side.engine(), wal=wal)
        srv.submit_insert(t, _cols(rng, 6))
        srv.submit_delete(t, np.array([2], np.int64))
        srv.drain()
        wal.close()
        reopened = side.core.WriteAheadLog.open(path)
        assert reopened.record_count == wal.record_count
        assert_recovers_to(side.core.RelationalTable.recover(reopened, t.uid), _state(t))


def aggregate_and_groupby(side, t):
    c = side.core
    return side.engine().execute_many([c.AggregateOp(t, "b"),
                                       c.GroupByOp(t, "g", "b", num_groups=8)])


def to_np(results):
    out = []
    for r in results:
        for x in (r if isinstance(r, tuple) else (r,)):
            out.append(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
    return out


@PKGS
class TestRecoveredTableServes:
    def test_full_recovery_serves_identically(self, side):
        wal, t, _ = logged_history(side)
        recovered = side.core.RelationalTable.recover(wal, t.uid)
        for a, b in zip(to_np(aggregate_and_groupby(side, t)),
                        to_np(aggregate_and_groupby(side, recovered))):
            np.testing.assert_array_equal(a, b)

    def test_every_truncation_prefix_serves_identically(self, side):
        wal, t, states = logged_history(side)
        bounds = wal.boundaries()
        for k in range(1, len(bounds)):
            recovered = side.core.RelationalTable.recover(wal.truncated(bounds[k]), t.uid)
            words, row_count, clock = states[k - 1]
            reference = side.core.RelationalTable(side.schema(), capacity=max(row_count, 16))
            reference._words[:row_count] = words
            reference.row_count, reference._clock = row_count, clock
            live = side.engine().execute_many([side.core.AggregateOp(reference, "b")])
            redo = side.engine().execute_many([side.core.AggregateOp(recovered, "b")])
            np.testing.assert_array_equal(to_np(live)[0], to_np(redo)[0])

    def test_recovered_table_accepts_new_writes(self, side):
        wal, t, _ = logged_history(side)
        recovered = side.core.RelationalTable.recover(wal.corrupted_tail(), t.uid)
        srv = side.serve.QueryServer(side.engine())
        srv.submit_insert(recovered, _cols(np.random.default_rng(9), 4))
        tk = srv.submit(side.core.plan(recovered).aggregate("b"))
        srv.drain()
        assert float(np.asarray(tk.result())) == float(
            np.sum(np.asarray(recovered.read_column("b"), np.float64)))


@PKGS
class TestShardedRecoveredTableServes:
    """``tests/test_wal.py::TestRecoveredTableServes[sharded]``: a recovered
    table served by a 2-shard engine equals the live table, and the port's
    results equal the JAX package's."""

    def test_full_recovery_serves_identically(self, side):
        wal, t, _ = logged_history(side)
        recovered = side.core.RelationalTable.recover(wal, t.uid)
        ops = lambda tab: [side.core.AggregateOp(tab, "b"),  # noqa: E731
                           side.core.GroupByOp(tab, "g", "b", num_groups=8)]
        live = to_np(side.sharded_engine().execute_many(ops(t)))
        redo = to_np(side.sharded_engine().execute_many(ops(recovered)))
        for a, b, c in zip(live, redo, to_np(aggregate_and_groupby(side, t))):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)  # == the single-device engine

    def test_every_truncation_prefix_serves_identically(self, side):
        wal, t, states = logged_history(side)
        bounds = wal.boundaries()
        for k in range(1, len(bounds)):
            recovered = side.core.RelationalTable.recover(wal.truncated(bounds[k]), t.uid)
            words, row_count, clock = states[k - 1]
            reference = side.core.RelationalTable(side.schema(), capacity=max(row_count, 16))
            reference._words[:row_count] = words
            reference.row_count, reference._clock = row_count, clock
            live = side.sharded_engine().execute_many([side.core.AggregateOp(reference, "b")])
            redo = side.sharded_engine().execute_many([side.core.AggregateOp(recovered, "b")])
            np.testing.assert_array_equal(to_np(live)[0], to_np(redo)[0])

    def test_recovered_table_accepts_new_writes(self, side):
        wal, t, _ = logged_history(side)
        recovered = side.core.RelationalTable.recover(wal.corrupted_tail(), t.uid)
        srv = side.serve.QueryServer(side.sharded_engine())
        srv.submit_insert(recovered, _cols(np.random.default_rng(9), 4))
        tk = srv.submit(side.core.plan(recovered).aggregate("b"))
        srv.drain()
        assert float(np.asarray(tk.result())) == float(
            np.sum(np.asarray(recovered.read_column("b"), np.float64)))


def test_sharded_recovery_equal_across_packages():
    """The recovered table's sharded results and stats, JAX against port."""
    outs = []
    for side in SIDES:
        wal, t, _ = logged_history(side)
        recovered = side.core.RelationalTable.recover(wal, t.uid)
        eng = side.sharded_engine()
        res = eng.execute_many([side.core.AggregateOp(recovered, "b"),
                                side.core.GroupByOp(recovered, "g", "b", num_groups=8)])
        outs.append((to_np(res), dataclasses.asdict(eng.stats)))
    (ja, js), (ta, ts) = outs
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(b, a)
    assert js == ts


# ------------------------------------------------------ across the packages
@pytest.mark.parametrize("strings", [False, True])
@pytest.mark.parametrize("writer,reader", [(SIDES[0], SIDES[1]), (SIDES[1], SIDES[0])],
                         ids=["jax-log-to-port", "port-log-to-jax"])
def test_log_recovers_across_packages(writer, reader, strings):
    wal, t, states = logged_history(writer, strings=strings)
    carried = reader.core.WriteAheadLog.from_bytes(wal.to_bytes())
    bounds = carried.boundaries()
    assert bounds == wal.boundaries()
    for k in range(1, len(bounds)):
        recovered = reader.core.RelationalTable.recover(carried.truncated(bounds[k]), t.uid)
        assert_recovers_to(recovered, states[k - 1])
        # the reader's own classes, not the writer's
        assert isinstance(recovered.schema, reader.core.TableSchema)
    recovered = reader.core.RelationalTable.recover(carried, t.uid)
    np.testing.assert_array_equal(recovered.words(), t.words())
    assert set(recovered.codecs) == set(t.codecs)
    for a, b in zip(to_np(aggregate_and_groupby(reader, recovered)),
                    to_np(aggregate_and_groupby(writer, t))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strings", [False, True])
def test_record_bytes_identical_across_packages(strings):
    """The same write history logs the same bytes in both packages, once the
    table keys (each package numbers its own tables) are set equal."""
    logs = []
    for side in SIDES:
        wal, _, _ = logged_history(side, strings=strings)
        same_key = side.core.WriteAheadLog()
        for rec in wal.records():
            same_key.append(0, rec.kind, rec.payload)
        logs.append(same_key.to_bytes())
    assert logs[0] == logs[1]
