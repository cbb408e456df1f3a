"""QueryServer parity: the same tick scripts on the JAX server and the port's.

Both servers get tables built from the same numpy columns (the port's are
carried over byte for byte) and the same submissions, writes included.  The
JAX engine runs its Pallas kernels in interpret mode, the port's engine the
plain versions on the CPU.  Every ticket's result must match (packed blocks,
masks, join outputs and counts bit-equal; finalized averages within 1 ulp),
and the ``ServerStats`` and ``EngineStats`` must be equal apart from timing
fields (latency reservoirs, percentiles).  The sharded cases run the same
scripts on ``ShardedEngine`` servers, every ``EngineStats`` field equal, the collective and failover counters
included.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro.serve as JS  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.serve import query_server as TQS  # noqa: E402
from test_torch_planner import assert_same, assert_stats, port  # noqa: E402

N_S, N_R = 400, 64
TIMING = ("latency", "queue_wait", "service")


@pytest.fixture(autouse=True)
def _fresh_build_caches():
    JP.clear_join_build_cache()
    TP.clear_join_build_cache()
    yield
    JP.clear_join_build_cache()
    TP.clear_join_build_cache()


def cols(seed, n):
    rng = np.random.default_rng(seed)
    return {f"A{i + 1}": rng.integers(-100, 100, n).astype(np.int32) for i in range(16)}


class Rig:
    """A fact table S and a dimension table R (primary key ``A2``), a
    server over each package's engine, driven in lockstep."""

    def __init__(self, num_shards=None, **server_kw):
        s = cols(0, N_S)
        s["A2"] = np.random.default_rng(1).integers(-8, 2 * N_R, N_S).astype(np.int32)
        r = cols(2, N_R)
        r["A2"] = np.arange(N_R, dtype=np.int32)
        js, jr = (J.RelationalTable.from_columns(J.benchmark_schema(64, 4), c)
                  for c in (s, r))
        self.tables = {J: (js, jr), T: (port(js), port(jr))}
        if num_shards is None:
            self.je = J.RelationalMemoryEngine()
            self.te = T.RelationalMemoryEngine(device="cpu")
        else:
            from repro.core.distributed import ShardedEngine
            self.je = ShardedEngine(num_shards=num_shards)
            self.te = T.ShardedEngine(num_shards=num_shards, device="cpu")
        self.servers = {J: JS.QueryServer(self.je, **server_kw),
                        T: TS.QueryServer(self.te, **server_kw)}
        # express reads the port left to finish_tick (a counter the reference
        # lacks): none on the CPU, where every answer is ready at begin_tick
        self.deferred = 0

    def both(self, fn):
        """``fn(pkg, server, S, R)`` on both sides; returns (jax, port)."""
        return tuple(fn(pkg, self.servers[pkg], *self.tables[pkg]) for pkg in (J, T))

    def check(self, tickets):
        jt, tt = tickets
        assert len(jt) == len(tt)
        for a, b in zip(jt, tt):
            assert b.done() == a.done()
            assert b.route == a.route and b.lane == a.lane
            ja, ta = outcome(a), outcome(b)
            if isinstance(ja, BaseException):
                assert type(ta).__name__ == type(ja).__name__, (ja, ta)
            else:
                assert_same(ja, ta)
        self.check_stats()

    def check_stats(self):
        assert_stats(self.je, self.te)
        js, ts = (server_counts(self.servers[pkg]) for pkg in (J, T))
        jsnap, tsnap = (self.servers[pkg].snapshot() for pkg in (J, T))
        assert ts.pop("express_deferred") == tsnap.pop("express_deferred") == self.deferred
        assert js == ts
        assert set(tsnap) <= set(jsnap)
        assert not {k for k in set(jsnap) - set(tsnap) if not k.startswith("breaker")}
        diff = {k: (jsnap[k], tsnap[k]) for k in tsnap
                if not (k.endswith("_ms") or k.endswith("_latency_s"))
                and jsnap[k] != tsnap[k]}
        assert not diff, diff


def outcome(ticket):
    try:
        return ticket.result(timeout=30)
    except Exception as e:  # the ticket's own error is part of its outcome
        return e


def server_counts(server):
    """ServerStats without the timing reservoirs."""
    out = {}
    for f in dataclasses.fields(server.stats):
        v = getattr(server.stats, f.name)
        if f.name in TIMING:
            continue
        if f.name == "lanes":
            v = {name: {g.name: getattr(lane, g.name) for g in dataclasses.fields(lane)
                        if g.name not in TIMING} for name, lane in v.items()}
        out[f.name] = v
    return out


def join(pkg, s, r, proj="A3"):
    return pkg.plan(s).join(r, key="A2", left_proj="A1", right_proj=proj)


def test_join_stream_and_snapshot_ticks():
    """The chip smoke test's tick script at a small size: a cold solo join
    and a stream; the same join again (build cache hit); then writes and
    one tick of five reads over S riding one shared scan."""
    smoke_ticks(Rig())


def test_sharded_join_stream_and_snapshot_ticks():
    """The same tick script on 4-shard servers: the solo join probes every
    shard after one broadcast of the build partitions (none on the cache
    hit); tick C's five reads ride one fused pass per shard."""
    rig = Rig(num_shards=4)
    smoke_ticks(rig)
    assert rig.te.stats.collective_ops > 0 and rig.te.stats.bytes_collective > 0


def smoke_ticks(rig):
    def tick_a(pkg, srv, s, r):
        tks = [srv.submit(join(pkg, s, r)),
               srv.submit(pkg.plan(s).project("A1", "A4"), stream=True,
                          stream_chunk_rows=96)]
        srv.drain()
        return tks

    rig.check(rig.both(tick_a))
    assert rig.te.stats.join_builds == 1
    rig.check(rig.both(lambda pkg, srv, s, r: [srv.submit(join(pkg, s, r)),
                                                srv.drain()][:1]))
    assert rig.te.stats.join_builds == 1 and TP.JOIN_BUILD_STATS["hits"] == 1
    assert TP.JOIN_BUILD_STATS == JP.JOIN_BUILD_STATS

    def tick_c(pkg, srv, s, r):
        rng = np.random.default_rng(11)
        srv.submit_insert(s, cols(12, 40))
        srv.submit_update(s, rng.choice(N_S, 6, replace=False),
                          {"A1": rng.integers(-9, 9, 6).astype(np.int32)})
        srv.submit_delete(s, rng.choice(N_S, 6, replace=False))
        tks = [srv.submit(pkg.plan(s).filter("A3", "gt", 10).sum("A1")),
               srv.submit(pkg.plan(s).groupby("A4", "A1", "avg", 16)),
               srv.submit(pkg.plan(s).project("A1", "A5")),
               srv.submit(join(pkg, s, r)),
               srv.submit(join(pkg, s, r).join(r, key="A2", left_proj="A1",
                                               right_proj="A5"))]
        srv.drain()
        return tks

    before = rig.te.stats.shared_scans
    rig.check(rig.both(tick_c))
    assert rig.te.stats.shared_scans == before + 1


@pytest.mark.parametrize("pipeline", [True, False])
def test_mixed_ticks_pipelined_and_serial(pipeline):
    rig = Rig(pipeline=pipeline, max_batch=4)

    def script(pkg, srv, s, r):
        tks = [srv.submit(pkg.plan(s).project("A1", "A3")),
               srv.submit(pkg.plan(s).filter("A5", "gt", 10).project("A1", "A2")),
               srv.submit(pkg.plan(s).sum("A2")),
               srv.submit(pkg.plan(s).groupby("A2", "A1", "avg", 16)),
               srv.submit(pkg.plan(r).project("A2", "A4")),
               srv.submit(join(pkg, s, r)),
               srv.submit(pkg.plan(r).filter("A4", "lt", 5).sum("A1")),
               srv.submit(pkg.plan(s).project("A1", "A3"))]
        srv.submit_insert(r, cols(4, 3))
        tks.append(srv.submit(pkg.plan(r).filter("A4", "lt", 5).sum("A1")))
        tks.append(srv.submit(join(pkg, s, r, proj="A6")))
        srv.drain()
        return tks

    rig.check(rig.both(script))
    assert rig.servers[T].stats.ticks == 3


@pytest.mark.parametrize("pipeline", [True, False])
def test_sharded_mixed_ticks_pipelined_and_serial(pipeline):
    """``tests/test_query_server.py::test_overlapped_ticks_match_serial``,
    sharded: 3 shards, forced into several ticks, both packages equal."""
    rig = Rig(num_shards=3, pipeline=pipeline, max_batch=2)

    def script(pkg, srv, s, r):
        tks = [srv.submit(pkg.plan(s).project("A1", "A3")),
               srv.submit(pkg.plan(s).filter("A5", "gt", 10).project("A1", "A2")),
               srv.submit(pkg.plan(s).sum("A2")),
               srv.submit(pkg.plan(s).groupby("A2", "A1", "avg", 16)),
               srv.submit(pkg.plan(r).project("A2", "A4")),
               srv.submit(pkg.plan(r).filter("A4", "lt", 5).sum("A1"))]
        srv.drain()
        return tks

    rig.check(rig.both(script))
    if pipeline:
        assert rig.servers[T].stats.ticks_overlapped > 0


def test_sharded_streamed_chunks_concat_to_blocking_result():
    """``tests/test_query_server.py::test_streamed_chunks_concat_to_blocking_
    result``, sharded: a cold streamed projection arrives in more than one
    chunk, in global row order, equal to the blocking result."""
    blocking = Rig(num_shards=3)

    def block(pkg, srv, s, r):
        tk = srv.submit(pkg.plan(s).project("A1", "A4"))
        srv.drain()
        return [tk]

    tickets = blocking.both(block)
    blocking.check(tickets)
    expect = tickets[1][0].result(timeout=5)
    rig = Rig(num_shards=3)

    def stream(pkg, srv, s, r):
        tk = srv.submit(pkg.plan(s).project("A1", "A4"), stream=True,
                        stream_chunk_rows=64)
        srv.drain()
        assert len(list(tk.chunks(timeout=5))) > 1
        return [tk]

    tickets = rig.both(stream)
    rig.check(tickets)
    chunks = list(tickets[1][0].chunks(timeout=5))
    assert torch.equal(torch.cat(chunks), expect)
    assert rig.servers[T].snapshot()["stream_chunks"] == len(chunks)


def test_express_lane_finishes_while_bulk_in_flight():
    rig = Rig()

    def script(pkg, srv, s, r):
        bulk = srv.submit(join(pkg, s, r))
        exp = srv.submit(pkg.plan(s).sum("A1"))
        tick = srv.begin_tick()
        assert exp.done() and not bulk.done()
        assert srv.finish_tick(tick) == 2
        return [bulk, exp]

    rig.check(rig.both(script))


def test_deadlines_errors_and_poison_free_ticks():
    rig = Rig()

    def script(pkg, srv, s, r):
        tks = [srv.submit(pkg.plan(s).project("A1"), deadline_s=0.0),
               srv.submit(pkg.plan(s).project("A2")),
               srv.submit(pkg.plan(s).sum("no_such_column")),
               srv.submit(join(pkg, s, r), lane="express")]
        srv.run_tick()
        return tks

    rig.check(rig.both(script))
    assert rig.servers[T].stats.deadline_misses == 1
    assert rig.servers[T].stats.failed == 2


def test_streaming_chunks_and_written_table():
    rig = Rig()

    def script(pkg, srv, s, r):
        stream = srv.submit(pkg.plan(s).project("A1", "A4"), stream=True,
                            stream_chunk_rows=50)
        srv.drain()
        got = list(stream.chunks(timeout=5))
        assert len(got) == -(-N_S // 50)
        srv.submit_delete(r, np.array([0, 1]))
        bad = srv.submit(pkg.plan(r).project("A1"), stream=True)
        srv.drain()
        return [stream, bad]

    rig.check(rig.both(script))


def test_backpressure_shed_and_degrade():
    for kw in ({"max_queue": 2}, {"max_queue": 2, "overload": "degrade"}):
        rig = Rig(**kw)

        def script(pkg, srv, s, r):
            tks, refused = [], []
            for i in range(5):
                try:
                    tks.append(srv.submit(pkg.plan(s).sum(f"A{i + 1}"),
                                          deadline_s=10.0))
                except Exception as e:
                    refused.append(type(e).__name__)
            try:
                srv.submit_insert(s, cols(7, 4))
            except Exception as e:
                refused.append(type(e).__name__)
            srv.drain()
            assert refused and set(refused) == {"ServerOverloaded"}
            return tks

        rig.check(rig.both(script))


def test_background_thread_serves_joins():
    rig = Rig()
    for pkg in (J, T):
        srv = rig.servers[pkg]
        s, r = rig.tables[pkg]
        with srv:
            tks = [srv.submit(join(pkg, s, r), client=f"c{i % 2}") for i in range(4)]
            results = [tk.result(timeout=60) for tk in tks]
        assert srv._thread is None
        for res in results[1:]:
            for f in ("s_proj", "r_proj", "matched"):
                np.testing.assert_array_equal(np.asarray(getattr(res, f)),
                                              np.asarray(getattr(results[0], f)))
        assert set(srv.client_latencies()) == {"c0", "c1"}
    jt, tt = rig.tables[J], rig.tables[T]
    want = JS.QueryServer(J.RelationalMemoryEngine())
    got = TS.QueryServer(T.RelationalMemoryEngine(device="cpu"))
    a, b = want.submit(join(J, *jt)), got.submit(join(T, *tt))
    want.drain()
    got.drain()
    assert_same(a.result(), b.result())


def test_concurrent_clients_share_one_tick():
    rig = Rig()

    def script(pkg, srv, s, r):
        tickets, barrier = {}, threading.Barrier(4)

        def client(i, c):
            barrier.wait()
            tickets[i] = srv.submit(pkg.plan(s).project(*c), client=f"c{i}")

        groups = (("A1",), ("A1", "A2", "A3", "A4"), ("A1", "A3"), ("A2", "A4"))
        threads = [threading.Thread(target=client, args=(i, g))
                   for i, g in enumerate(groups)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        srv.run_tick()
        return [tickets[i] for i in range(4)]

    rig.check(rig.both(script))
    assert rig.te.stats.shared_scans == 1


def test_unported_options_raise_with_their_roadmap_item():
    """Every server option is ported: ``num_shards`` builds a sharded
    engine on the server's device, a ``mesh`` must be a device list, and
    the argument checks stay."""
    eng = T.RelationalMemoryEngine(device="cpu")
    sharded = TS.QueryServer(num_shards=2, device="cpu").engine
    assert isinstance(sharded, T.ShardedEngine) and sharded.backend == "sharded"
    assert sharded.num_shards == 2 and sharded.device == torch.device("cpu")
    meshed = TS.QueryServer(mesh=["cpu", torch.device("cpu")]).engine
    assert meshed.num_shards == 2 and meshed.device == torch.device("cpu")
    with pytest.raises(TypeError, match="sequence of devices"):
        TS.QueryServer(mesh=object())
    with pytest.raises(TypeError, match="sequence of devices"):
        TS.QueryServer(mesh="cpu")
    assert TS.QueryServer(eng, wal=T.WriteAheadLog()).snapshot()["wal_records"] == 0
    with pytest.raises(ValueError, match="not both"):
        TS.QueryServer(eng, num_shards=2)
    with pytest.raises(ValueError, match="overload"):
        TS.QueryServer(eng, overload="drop")
    with pytest.raises(ValueError, match="not both"):
        TS.QueryServer(eng, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.QueryServer()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.QueryServer(num_shards=2)


# ------------------------------------- express sums settled in finish_tick
@pytest.fixture
def deferring(monkeypatch):
    """The port's tokens report not ready at ``begin_tick``, as an express
    sum's does on the card while its pass runs.  Returns the port's tickets
    in the order they resolve."""
    monkeypatch.setattr(TP.PhysicalQuery, "ready", lambda self, token: False)
    resolved, real = [], TQS.QueryTicket._resolve

    def _resolve(ticket, *args, **kw):
        resolved.append(ticket)
        return real(ticket, *args, **kw)

    monkeypatch.setattr(TQS.QueryTicket, "_resolve", _resolve)
    return resolved


@pytest.mark.parametrize("mode", ["run_tick", "drain", "start"])
def test_deferred_express_reads_settle_first_in_their_ticks_finish(deferring, mode):
    """Express reads left to ``finish_tick`` settle there, before the tick's
    bulk reads, with the reference's answers under the serial tick, the
    pipelined ``drain()`` and the background loop; ``express_deferred``
    counts them."""
    rig = Rig()

    def script(pkg, srv, s, r):
        srv.submit_insert(r, cols(4, 3))
        tks = [srv.submit(pkg.plan(s).project("A1", "A3")),
               srv.submit(pkg.plan(s).sum("A2")),
               srv.submit(join(pkg, s, r)),
               srv.submit(pkg.plan(s).groupby("A2", "A1", "avg", 16)),
               srv.submit(pkg.plan(r).filter("A4", "lt", 5).sum("A1")),
               srv.submit(pkg.plan(s).filter("A5", "gt", 10).project("A1", "A2"))]
        if mode == "run_tick":
            assert srv.run_tick() == 7
        elif mode == "drain":
            assert srv.drain() == 7
        else:
            with srv:
                for tk in tks:
                    tk.result(timeout=60)
        return tks

    tickets = rig.both(script)
    rig.deferred = 3  # two sums and the group-by
    rig.check(tickets)
    reads = [tk for tk in deferring if any(tk is t for t in tickets[1])]
    assert [tk.lane for tk in reads] == ["express"] * 3 + ["bulk"] * 3


@pytest.mark.parametrize("case", ["express_only", "deadline_lapses"])
def test_an_express_only_ticks_handle_settles_its_deferred_reads(deferring, case):
    """An express-only tick returns a handle whose ``finish_tick`` settles
    the reads ``begin_tick`` left: with their sums, or, where a deadline
    lapsed while the pass was in flight, with ``DeadlineExceeded``."""
    c = cols(0, N_S)
    s = T.RelationalTable.from_columns(T.benchmark_schema(64, 4), c)
    srv = TS.QueryServer(T.RelationalMemoryEngine(device="cpu"))
    deadline = 0.5 if case == "deadline_lapses" else None
    tks = [srv.submit(T.plan(s).sum("A1"), deadline_s=deadline),
           srv.submit(T.plan(s).filter("A3", "gt", 10).sum("A2"), deadline_s=deadline)]
    tick = srv.begin_tick()
    assert tick.deferred == srv.stats.express_deferred == 2
    assert not any(tk.done() for tk in tks)
    if case == "deadline_lapses":
        while not tks[1].expired():
            time.sleep(0.01)
    assert srv.finish_tick(tick) == 2
    assert srv.finish_tick(tick) == 0
    if case == "express_only":
        assert tks[0].result(timeout=0) == float(c["A1"].sum())
        assert tks[1].result(timeout=0) == float(c["A2"][c["A3"] > 10].sum())
        assert srv.snapshot()["express_served"] == 2
    else:
        for tk in tks:
            with pytest.raises(TS.DeadlineExceeded, match="finish_tick"):
                tk.result(timeout=0)
        assert srv.stats.lanes["express"].deadline_misses == 2
    assert srv.snapshot()["express_deferred"] == 2


def test_a_repeated_covered_pair_uploads_nothing(monkeypatch):
    """A covered request's word index and predicate constant come from
    ``device_map``: served again, the pair finds both maps kept from the
    first time, and the answers equal an engine's that does not subsume."""
    monkeypatch.setattr(_cuda, "_DEVICE_MAPS", {})
    kept, real = [], TE.device_map

    def device_map(words, device):
        kept.append((device.index, tuple(words)) in _cuda._DEVICE_MAPS)
        return real(words, device)

    monkeypatch.setattr(TE, "device_map", device_map)
    t = T.RelationalTable.from_columns(T.benchmark_schema(64, 4), cols(0, N_S))

    def pair(eng):
        return eng.execute_many([
            T.FilterOp(eng.register(t, ["A2", "A3", "A4"]), "A4", "gt", -10),
            T.FilterOp(eng.register(t, ["A3"]), "A4", "gt", 50)])

    eng = T.RelationalMemoryEngine(device="cpu")
    first = pair(eng)
    assert kept == [False, False]
    maps = dict(_cuda._DEVICE_MAPS)
    second = pair(eng)
    assert kept[2:] == [True, True] and eng.stats.subsumed_requests == 2
    assert _cuda._DEVICE_MAPS.keys() == maps.keys()
    assert all(_cuda._DEVICE_MAPS[k] is v for k, v in maps.items())
    want = pair(T.RelationalMemoryEngine(device="cpu", subsume=False))
    for got in (first, second):
        for (gp, gm), (wp, wm) in zip(got, want):
            assert torch.equal(gp, wp) and torch.equal(gm, wm)
