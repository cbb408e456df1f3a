"""QueryServer parity: the same tick scripts on the JAX server and the port's.

Both servers get tables built from the same numpy columns (the port's are
carried over byte for byte) and the same submissions, writes included.  The
JAX engine runs its Pallas kernels in interpret mode, the port's engine the
plain versions on the CPU.  Every ticket's result must match (packed blocks,
masks, join outputs and counts bit-equal; finalized averages within 1 ulp),
and the ``ServerStats`` and ``EngineStats`` must be equal apart from timing
fields (latency reservoirs, percentiles).
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro.serve as JS  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
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

    def __init__(self, **server_kw):
        s = cols(0, N_S)
        s["A2"] = np.random.default_rng(1).integers(-8, 2 * N_R, N_S).astype(np.int32)
        r = cols(2, N_R)
        r["A2"] = np.arange(N_R, dtype=np.int32)
        js, jr = (J.RelationalTable.from_columns(J.benchmark_schema(64, 4), c)
                  for c in (s, r))
        self.tables = {J: (js, jr), T: (port(js), port(jr))}
        self.je = J.RelationalMemoryEngine()
        self.te = T.RelationalMemoryEngine(device="cpu")
        self.servers = {J: JS.QueryServer(self.je, **server_kw),
                        T: TS.QueryServer(self.te, **server_kw)}

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
        assert js == ts
        jsnap, tsnap = (self.servers[pkg].snapshot() for pkg in (J, T))
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
    rig = Rig()

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
    eng = T.RelationalMemoryEngine(device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        TS.QueryServer(num_shards=2)
    with pytest.raises(NotImplementedError, match="item 6"):
        TS.QueryServer(mesh=object())
    with pytest.raises(NotImplementedError, match="item 4"):
        TS.QueryServer(eng, wal=object())
    with pytest.raises(ValueError, match="not both"):
        TS.QueryServer(eng, num_shards=2)
    with pytest.raises(ValueError, match="overload"):
        TS.QueryServer(eng, overload="drop")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.QueryServer()
