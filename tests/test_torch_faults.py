"""Fault injection and the circuit breaker: the single-device classes of
``tests/test_faults.py``, run side by side on the JAX package and the port.

Each scenario runs once per package under its own ``FaultPlan`` (installed
with the ``fault_plan`` context manager only, so xdist workers stay
independent) and returns its results, the plan's fired counts, the server's
retry counters and the breaker's snapshot; the two must be equal.  The JAX
engine runs ``revision="xla"`` where the reference test does and ``"mlp"``
(Pallas in interpret mode) where the breaker is exercised; the port's
engine runs on the CPU (``device="cpu"``).  ``TestShardFailover`` runs the
sharded engines (``ShardedEngine(num_shards=2)``; the port's on the CPU) and
holds every ``EngineStats`` field equal too.

The port differs from the reference in one deliberate way, checked last: a
non-injected exception raised by a kernel wrapper propagates and is never
rerouted or counted by the breaker — nor, on the sharded engine, retried or
failed over.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro.serve.query_server as JQ  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.serve.query_server as TQ  # noqa: E402
from repro.core import operators as JO  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import rme_scan_multi as TR  # noqa: E402


@dataclasses.dataclass
class Side:
    name: str
    core: object
    serve: object

    def engine(self, revision="xla", **kw):
        if self.core is J:
            return J.RelationalMemoryEngine(revision=revision, **kw)
        return T.RelationalMemoryEngine(device="cpu", **kw)

    def sharded(self, num_shards=2, **kw):
        if self.core is J:
            from repro.core.distributed import ShardedEngine
            return ShardedEngine(num_shards=num_shards, revision="xla", **kw)
        return T.ShardedEngine(num_shards=num_shards, device="cpu", **kw)

    def server(self, revision="xla", engine_kw=None, **kw):
        return self.serve.QueryServer(self.engine(revision, **(engine_kw or {})), **kw)

    def table(self, n=200, seed=0):
        c = self.core
        schema = c.TableSchema((c.Column("a", "int32"), c.Column("b", "int32"),
                                c.Column("g", "int32")))
        rng = np.random.default_rng(seed)
        return c.RelationalTable.from_columns(schema, {
            "a": rng.integers(-100, 100, n).astype(np.int32),
            "b": rng.integers(0, 1000, n).astype(np.int32),
            "g": rng.integers(0, 8, n).astype(np.int32),
        })

    def clear_build_cache(self):
        (JO if self.core is J else TP).clear_join_build_cache()


SIDES = (Side("jax", J, JQ), Side("port", T, TQ))
PKGS = pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)


def as_np(x):
    if isinstance(x, (tuple, list)):
        return [a for p in x for a in as_np(p)]
    if hasattr(x, "s_proj"):
        return as_np((x.s_proj, x.r_proj, x.matched))
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [np.asarray(x)]


def side_by_side(scenario):
    """Run ``scenario(side)`` on both packages; its returned dict must be
    equal (arrays element-wise)."""
    outs = []
    for side in SIDES:
        side.clear_build_cache()
        outs.append(scenario(side))
        side.clear_build_cache()
    jax_out, port_out = outs
    assert jax_out.keys() == port_out.keys()
    for key in jax_out:
        a, b = as_np(jax_out[key]), as_np(port_out[key])
        assert len(a) == len(b), key
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x, err_msg=key)
    return port_out


SERVER_KEYS = ("served", "failed", "retries", "poisoned", "poison_quarantined",
               "breaker_trips", "breaker_fallbacks", "breaker_probes",
               "breaker_open")


def server_counters(srv):
    snap = srv.snapshot()
    return [snap[k] for k in SERVER_KEYS]


# --------------------------------------------------------------- FaultPlan
@PKGS
class TestFaultPlan:
    def test_fires_on_nth_hit_for_times_hits(self, side):
        p = side.core.FaultPlan().inject("upload", at=2, times=2)
        outcomes = []
        for _ in range(5):
            try:
                p.hit("upload")
                outcomes.append("ok")
            except side.core.TransientFault:
                outcomes.append("fault")
        assert outcomes == ["ok", "fault", "fault", "ok", "ok"]
        assert p.fired("upload") == 2

    def test_match_context_restricts_hits(self, side):
        p = side.core.FaultPlan().inject("shard_pass", shard=1)
        p.hit("shard_pass", shard=0)
        with pytest.raises(side.core.TransientFault):
            p.hit("shard_pass", shard=1)
        assert p.hits_at("shard_pass") == 1

    def test_permanent_kind_and_typed_attributes(self, side):
        p = side.core.FaultPlan().inject("lowering", kind="permanent")
        with pytest.raises(side.core.PermanentFault) as exc:
            p.hit("lowering")
        assert exc.value.site == "lowering" and exc.value.hit == 1
        assert isinstance(exc.value, side.core.faults.FaultError)
        assert not isinstance(exc.value, side.core.TransientFault)

    def test_times_none_fires_forever(self, side):
        p = side.core.FaultPlan().inject("upload", times=None)
        for _ in range(4):
            with pytest.raises(side.core.TransientFault):
                p.hit("upload")

    def test_seeded_random_schedule_is_reproducible(self, side):
        def schedule(seed):
            p = side.core.FaultPlan(seed=seed).inject_random("upload", p=0.5)
            out = []
            for _ in range(32):
                try:
                    p.hit("upload")
                    out.append(0)
                except side.core.TransientFault:
                    out.append(1)
            return out

        assert schedule(7) == schedule(7) != schedule(8)
        assert sum(schedule(7)) > 0

    def test_unknown_site_and_kind_rejected(self, side):
        with pytest.raises(ValueError):
            side.core.FaultPlan().inject("nonsense")
        with pytest.raises(ValueError):
            side.core.FaultPlan().inject("upload", kind="flaky")

    def test_context_manager_restores_previous_plan(self, side):
        faults = side.core.faults
        assert faults.active_plan() is None
        outer = side.core.FaultPlan()
        with side.core.fault_plan(outer):
            with side.core.fault_plan(side.core.FaultPlan()) as inner:
                assert faults.active_plan() is inner
            assert faults.active_plan() is outer
        assert faults.active_plan() is None

    def test_maybe_fault_is_noop_without_plan(self, side):
        side.core.faults.maybe_fault("upload")


def test_random_schedules_equal_across_packages():
    def schedule(core):
        p = core.FaultPlan(seed=11).inject_random("stream_chunk", p=0.3)
        out = []
        for _ in range(64):
            try:
                p.hit("stream_chunk")
                out.append(0)
            except core.TransientFault:
                out.append(1)
        return out

    assert schedule(J) == schedule(T)


# ---------------------------------------------------------- CircuitBreaker
@PKGS
class TestCircuitBreaker:
    def test_trips_after_threshold_then_cooldown_then_half_open(self, side):
        br = side.core.CircuitBreaker(threshold=2, cooldown=2)
        key = ("t", "r")
        assert br.allow(key)
        br.record_failure(key)
        assert br.allow(key)
        br.record_failure(key)
        assert br.state(key) == "open" and br.trips == 1
        assert not br.allow(key)
        assert not br.allow(key)
        assert br.state(key) == "half_open"
        assert br.allow(key) and br.probes == 1
        br.record_success(key)
        assert br.state(key) == "closed" and br.fallbacks == 2

    def test_failed_probe_reopens(self, side):
        br = side.core.CircuitBreaker(threshold=1, cooldown=1)
        br.record_failure("k")
        assert not br.allow("k")
        assert br.allow("k")
        br.record_failure("k")
        assert br.state("k") == "open" and br.trips == 2

    def test_success_resets_streak(self, side):
        br = side.core.CircuitBreaker(threshold=2, cooldown=1)
        br.record_failure("k")
        br.record_success("k")
        br.record_failure("k")
        assert br.state("k") == "closed"


# ----------------------------------------------- engine sites (single dev)
class TestEngineSites:
    def test_upload_fault_recovers_via_server_retry(self):
        def scenario(side):
            srv0 = side.server()
            tk = srv0.submit(side.core.plan(side.table()).project("a", "b"))
            srv0.drain()
            ref = tk.result()
            srv = side.server()
            with side.core.fault_plan(side.core.FaultPlan().inject("upload")) as p:
                tk = srv.submit(side.core.plan(side.table()).project("a", "b"))
                srv.drain()
            out = tk.result()
            for a, b in zip(as_np(out), as_np(ref)):
                np.testing.assert_array_equal(a, b)
            return {"out": out, "fired": p.fired("upload"),
                    "counters": server_counters(srv)}

        out = side_by_side(scenario)
        assert out["fired"] == 1 and out["counters"][0] == 1

    def test_delta_upload_fault_leaves_store_consistent(self):
        def scenario(side):
            t = side.table()
            srv = side.server()
            tk = srv.submit(side.core.plan(t).aggregate("b"))
            srv.drain()
            tk.result()
            new = {"a": np.array([1], np.int32), "b": np.array([50], np.int32),
                   "g": np.array([0], np.int32)}
            plan = side.core.FaultPlan().inject("upload", delta=True)
            with side.core.fault_plan(plan) as p:
                srv.submit_insert(t, new)
                rd = srv.submit(side.core.plan(t).aggregate("b"))
                srv.drain()
            total = float(np.asarray(rd.result()))
            assert total == float(np.sum(np.asarray(t.read_column("b"), np.float64)))
            return {"total": total, "fired": p.fired("upload"),
                    "counters": server_counters(srv)}

        assert side_by_side(scenario)["fired"] == 1

    def test_scan_launch_permanent_fault_fails_typed_no_retry(self):
        def scenario(side):
            t = side.table()
            srv = side.server()
            plan = side.core.FaultPlan().inject("scan_launch", kind="permanent",
                                                times=None)
            with side.core.fault_plan(plan) as p:
                tk = srv.submit(side.core.plan(t).aggregate("b"))
                srv.drain()
            with pytest.raises(side.core.PermanentFault):
                tk.result()
            return {"fired": p.fired("scan_launch"), "counters": server_counters(srv)}

        assert side_by_side(scenario)["counters"][2] == 0  # no retries

    def test_join_build_fault_recovers(self):
        def scenario(side):
            left, right = side.table(150, seed=1), side.table(40, seed=2)
            q = (side.core.plan(left).join(right, key="a", left_proj="b",
                                           right_proj="b").build())
            srv = side.server()
            with side.core.fault_plan(side.core.FaultPlan().inject("join_build")) as p:
                tk = srv.submit(q)
                srv.drain()
            return {"out": tk.result(), "fired": p.fired("join_build"),
                    "counters": server_counters(srv)}

        assert side_by_side(scenario)["fired"] == 1

    def test_stream_chunk_fault_before_first_chunk_retries_clean(self):
        def scenario(side):
            t = side.table(300)
            srv = side.server()
            plan = side.core.FaultPlan().inject("stream_chunk", at=1)
            with side.core.fault_plan(plan) as p:
                tk = srv.submit(side.core.plan(t).project("a", "b"), stream=True,
                                stream_chunk_rows=64)
                srv.drain()
            return {"out": tk.result(), "fired": p.fired("stream_chunk"),
                    "counters": server_counters(srv)}

        out = side_by_side(scenario)
        assert out["fired"] == 1 and out["counters"][2] == 1

    def test_stream_fault_mid_stream_fails_typed_prefix_intact(self):
        def scenario(side):
            t = side.table(300)
            srv = side.server()
            plan = side.core.FaultPlan().inject("stream_chunk", index=1, times=None)
            with side.core.fault_plan(plan) as p:
                tk = srv.submit(side.core.plan(t).project("a", "b"), stream=True,
                                stream_chunk_rows=64)
                srv.drain()
            with pytest.raises(side.core.TransientFault):
                tk.result()
            return {"prefix": list(tk._chunks), "fired": p.fired("stream_chunk"),
                    "counters": server_counters(srv)}

        out = side_by_side(scenario)
        assert len(out["prefix"]) == 1 and out["counters"][3] == 0


# ------------------------------------------------- lowering circuit breaker
def lowering_ops(core, t):
    return [core.AggregateOp(t, "b"), core.GroupByOp(t, "g", "b", num_groups=8)]


class TestLoweringBreaker:
    def test_lowering_fault_falls_back_byte_identical(self):
        def scenario(side):
            t = side.table()
            ref = side.engine().execute_many(lowering_ops(side.core, t))
            eng = side.engine("mlp", breaker_threshold=2, breaker_cooldown=2)
            plan = side.core.FaultPlan().inject("lowering", times=None, op="scan")
            with side.core.fault_plan(plan) as p:
                outs = [eng.execute_many(lowering_ops(side.core, t)) for _ in range(5)]
            for out in outs:
                for a, b in zip(as_np(out), as_np(ref)):
                    np.testing.assert_array_equal(a, b)
            return {"outs": outs, "fired": p.fired("lowering"),
                    "hits": p.hits_at("lowering"),
                    "breaker": list(eng.breaker.snapshot().values())}

        out = side_by_side(scenario)
        trips, fallbacks, _, open_routes = out["breaker"]
        assert trips >= 1 and fallbacks >= 1 and open_routes == 1

    def test_half_open_probe_recovers_route(self):
        def scenario(side):
            t = side.table()
            eng = side.engine("mlp", breaker_threshold=1, breaker_cooldown=1)
            with side.core.fault_plan(side.core.FaultPlan().inject("lowering", op="scan")):
                eng.execute_many(lowering_ops(side.core, t))
            route = next(iter(eng.breaker._routes))
            states = [eng.breaker.state(route)]
            eng.execute_many(lowering_ops(side.core, t))  # cooldown serve
            eng.execute_many(lowering_ops(side.core, t))  # half-open probe
            states.append(eng.breaker.state(route))
            return {"states": states, "breaker": list(eng.breaker.snapshot().values())}

        out = side_by_side(scenario)
        assert list(out["states"]) == ["open", "closed"] and out["breaker"][2] == 1

    def test_solo_and_join_routes(self):
        def scenario(side):
            left, right = side.table(150, seed=1), side.table(40, seed=2)
            eng = side.engine("mlp", breaker_threshold=1, breaker_cooldown=2)
            join = side.core.JoinOp(eng.register(left, ["a", "b"]), "b", "a",
                                    right, "g")
            plan = (side.core.FaultPlan().inject("lowering", op="join", times=2)
                    .inject("lowering", op="scan", times=1))
            outs = []
            with side.core.fault_plan(plan) as p:
                for _ in range(4):
                    outs += eng.execute_many([join])
                    outs += eng.execute_many([side.core.AggregateOp(left, "b")])
            return {"outs": outs, "fired": [p.fired("lowering")],
                    "breaker": list(eng.breaker.snapshot().values()),
                    "stats": list(dataclasses.asdict(eng.stats).values())}

        out = side_by_side(scenario)
        assert out["fired"][0] == 3 and out["breaker"][0] >= 2

    def test_other_site_faults_pass_through_breaker(self):
        def scenario(side):
            t = side.table()
            eng = side.engine("mlp")
            eng.execute_many(lowering_ops(side.core, t))
            with side.core.fault_plan(side.core.FaultPlan().inject("scan_launch",
                                                                   times=None)):
                with pytest.raises(side.core.TransientFault):
                    eng.execute_many(lowering_ops(side.core, t))
            return {"open": eng.breaker.open_routes}

        assert side_by_side(scenario)["open"] == 0


# -------------------------------------------------- sharded shard failover
def shard_ops(core, t):
    return [core.AggregateOp(t, "b"), core.GroupByOp(t, "g", "b", num_groups=8)]


def single_reference(side):
    return side.engine().execute_many(shard_ops(side.core, side.table()))


def stats_of(eng):
    return list(dataclasses.asdict(eng.stats).values())


class TestShardFailover:
    """``tests/test_faults.py::TestShardFailover``, side by side: results
    equal the single-device engine's, and every stats field the JAX one's."""

    def test_transient_shard_fault_retries_byte_identical(self):
        def scenario(side):
            ref = single_reference(side)
            eng = side.sharded()
            with side.core.fault_plan(
                    side.core.FaultPlan().inject("shard_pass", shard=1)) as p:
                out = eng.execute_many(shard_ops(side.core, side.table()))
            for a, b in zip(as_np(out), as_np(ref)):
                np.testing.assert_array_equal(a, b)
            return {"out": out, "fired": p.fired("shard_pass"),
                    "stats": stats_of(eng)}

        out = side_by_side(scenario)
        assert out["fired"] == 1

    def test_permanent_shard_fault_fails_over_byte_identical(self):
        def scenario(side):
            ref = single_reference(side)
            eng = side.sharded()
            plan = side.core.FaultPlan().inject("shard_pass", kind="permanent",
                                                times=None, shard=0)
            with side.core.fault_plan(plan):
                out = eng.execute_many(shard_ops(side.core, side.table()))
            assert eng.stats.failovers == 1 and eng.stats.bytes_failover > 0
            for a, b in zip(as_np(out), as_np(ref)):
                np.testing.assert_array_equal(a, b)
            return {"out": out, "stats": stats_of(eng)}

        side_by_side(scenario)

    def test_retry_exhaustion_fails_over(self):
        def scenario(side):
            ref = single_reference(side)
            eng = side.sharded(shard_retries=1)
            plan = side.core.FaultPlan().inject("shard_pass", times=None, shard=1)
            with side.core.fault_plan(plan):
                out = eng.execute_many(shard_ops(side.core, side.table()))
            assert eng.stats.retries == 1 and eng.stats.failovers == 1
            for a, b in zip(as_np(out), as_np(ref)):
                np.testing.assert_array_equal(a, b)
            return {"out": out, "stats": stats_of(eng)}

        side_by_side(scenario)

    def test_quarantine_and_probe_recovery(self):
        def scenario(side):
            ref = single_reference(side)
            eng = side.sharded(shard_retries=0, quarantine_after=2,
                               quarantine_probe_every=2)
            t = side.table()
            plan = side.core.FaultPlan().inject("shard_pass", times=None, shard=0)
            with side.core.fault_plan(plan):
                eng.execute_many(shard_ops(side.core, t))
                eng.execute_many(shard_ops(side.core, t))  # second failure
            health = [eng.shard_health()]
            eng.execute_many(shard_ops(side.core, t))  # skipped: failover
            health.append(eng.shard_health())
            out = eng.execute_many(shard_ops(side.core, t))  # half-open probe
            health.append(eng.shard_health())
            assert health == [["quarantined", "healthy"],
                              ["quarantined", "healthy"],
                              ["healthy", "healthy"]]
            for a, b in zip(as_np(out), as_np(ref)):
                np.testing.assert_array_equal(a, b)
            return {"out": out, "health": health, "stats": stats_of(eng)}

        side_by_side(scenario)

    def test_collective_combine_transient_retries(self):
        def scenario(side):
            ref = single_reference(side)
            eng = side.sharded()
            with side.core.fault_plan(
                    side.core.FaultPlan().inject("collective_combine")):
                out = eng.execute_many(shard_ops(side.core, side.table()))
            assert eng.stats.retries == 1
            for a, b in zip(as_np(out), as_np(ref)):
                np.testing.assert_array_equal(a, b)
            return {"out": out, "stats": stats_of(eng)}

        side_by_side(scenario)

    def test_collective_combine_permanent_propagates_typed(self):
        def scenario(side):
            eng = side.sharded()
            plan = side.core.FaultPlan().inject("collective_combine",
                                                kind="permanent", times=None)
            with side.core.fault_plan(plan) as p:
                with pytest.raises(side.core.PermanentFault):
                    eng.execute_many(shard_ops(side.core, side.table()))
            return {"fired": p.fired("collective_combine"),
                    "stats": stats_of(eng)}

        side_by_side(scenario)

    def test_sharded_server_recovers_through_failover(self):
        def scenario(side):
            ref_srv = side.server()
            tk = ref_srv.submit(side.core.plan(side.table()).aggregate("b"))
            ref_srv.drain()
            ref = tk.result()
            srv = side.serve.QueryServer(side.sharded())
            plan = side.core.FaultPlan().inject("shard_pass", kind="permanent",
                                                times=None, shard=1)
            with side.core.fault_plan(plan):
                tk = srv.submit(side.core.plan(side.table()).aggregate("b"))
                srv.drain()
            out = tk.result()
            assert float(np.asarray(out)) == float(np.asarray(ref))
            snap = srv.snapshot()
            assert snap["engine_failovers"] >= 1
            assert snap["engine_bytes_failover"] > 0
            return {"out": out, "counters": server_counters(srv),
                    "failover": [snap["engine_failovers"],
                                 snap["engine_bytes_failover"]]}

        side_by_side(scenario)


# ------------------------------------------------ server-level degradation
class TestServerDegradation:
    def test_transient_fault_retried_and_tick_mates_unaffected(self):
        def scenario(side):
            t = side.table()
            srv = side.server()
            plan = side.core.FaultPlan().inject("scan_launch", at=1, times=2)
            with side.core.fault_plan(plan):
                a = srv.submit(side.core.plan(t).aggregate("b"))
                b = srv.submit(side.core.plan(t).project("a"))
                srv.drain()
            return {"out": [a.result(), b.result()], "counters": server_counters(srv)}

        served, failed, retries = side_by_side(scenario)["counters"][:3]
        assert served == 2 and failed == 0 and retries >= 1

    def test_poison_quarantine_resolves_typed_and_blocks_resubmits(self):
        def scenario(side):
            t = side.table()
            srv = side.server(max_retries=2, poison_cooldown_ticks=2)
            q_bad = side.core.plan(t).aggregate("b").build()
            plan = side.core.FaultPlan().inject("scan_launch", times=None, table=t.uid)
            with side.core.fault_plan(plan):
                bad = srv.submit(q_bad)
                srv.drain()
                with pytest.raises(side.core.TransientFault):
                    bad.result()
                again = srv.submit(q_bad)
                srv.drain()
                with pytest.raises(side.serve.PoisonedPlanError):
                    again.result()
            return {"counters": server_counters(srv)}

        counters = side_by_side(scenario)["counters"]
        assert counters[2] == 2 and counters[3] == 1

    def test_quarantine_expires_after_cooldown(self):
        def scenario(side):
            t = side.table()
            srv = side.server(max_retries=1, poison_cooldown_ticks=1)
            q = side.core.plan(t).aggregate("b").build()
            plan = side.core.FaultPlan().inject("scan_launch", times=None, table=t.uid)
            with side.core.fault_plan(plan):
                bad = srv.submit(q)
                srv.drain()
                with pytest.raises(side.core.TransientFault):
                    bad.result()
            srv.submit(side.core.plan(t).aggregate("a"))
            srv.drain()
            ok = srv.submit(q)
            srv.drain()
            return {"ok": float(np.asarray(ok.result())),
                    "counters": server_counters(srv)}

        side_by_side(scenario)

    def test_poison_does_not_starve_other_plans(self):
        def scenario(side):
            t = side.table()
            srv = side.server(max_retries=1)
            plan = side.core.FaultPlan().inject("scan_launch", times=None, table=t.uid)
            with side.core.fault_plan(plan):
                bad = srv.submit(side.core.plan(t).aggregate("b").build())
                srv.drain()
                with pytest.raises(side.core.TransientFault):
                    bad.result()
            good = srv.submit(side.core.plan(t).project("a").build())
            srv.drain()
            return {"good": good.result(), "counters": server_counters(srv)}

        side_by_side(scenario)

    def test_lowering_faults_through_the_server(self):
        def scenario(side):
            t = side.table(300, seed=4)
            srv = side.server("mlp", engine_kw=dict(breaker_threshold=1,
                                                    breaker_cooldown=1))
            plan = side.core.FaultPlan().inject("lowering", op="scan", times=3)
            outs = []
            with side.core.fault_plan(plan) as p:
                for _ in range(4):
                    tks = [srv.submit(side.core.plan(t).aggregate("b")),
                           srv.submit(side.core.plan(t).groupby("g", "b", "sum", 8))]
                    srv.drain()
                    outs += [tk.result() for tk in tks]
            return {"outs": outs, "fired": p.fired("lowering"),
                    "counters": server_counters(srv)}

        out = side_by_side(scenario)
        # an open route skips the lowering site: fewer hits than serves
        assert out["fired"] == 2 and out["counters"][5] >= 1  # tripped, counted

    def test_per_lane_shed_counts_and_depths_in_message(self):
        def scenario(side):
            t = side.table()
            srv = side.server(max_queue=1, overload="degrade")
            srv.submit(side.core.plan(t).project("a"))
            srv.submit(side.core.plan(t).project("b"))
            with pytest.raises(side.serve.ServerOverloaded) as exc:
                srv.submit(side.core.plan(t).project("g"))
            msg = str(exc.value)
            assert "shed lane: bulk" in msg
            assert "express=0" in msg and "bulk=2" in msg
            srv.drain()
            return {"shed": [srv.stats.lanes["bulk"].shed,
                             srv.stats.lanes["express"].shed]}

        assert side_by_side(scenario)["shed"] == [1, 0]

    def test_expired_inflight_ticket_dropped_before_transfer(self):
        import time

        def scenario(side):
            t = side.table(2000)
            srv = side.server(pipeline=True)
            tk = srv.submit(side.core.plan(t).project("a", "b"), deadline_s=0.0)
            tick = srv.begin_tick()
            time.sleep(0.01)  # the deadline lapses while the pass is in flight
            srv.finish_tick(tick)
            with pytest.raises(TimeoutError):
                tk.result()
            snap = srv.snapshot()
            return {"misses": [snap["deadline_misses"], snap["bulk_deadline_misses"]]}

        assert side_by_side(scenario)["misses"] == [1, 1]


# ------------------------------------- the port's narrower breaker `except`
@pytest.mark.parametrize("path", ["fused", "solo", "join"])
def test_real_kernel_errors_propagate_unrecorded(monkeypatch, path):
    """A non-injected exception raised inside a kernel wrapper (as a CUDA
    build or launch error would be) propagates; the breaker neither
    reroutes nor records it."""
    def broken(*args, **kwargs):
        raise RuntimeError("rm_scan_multi launch: CUDA error 700")

    side = SIDES[1]
    left, right = side.table(150, seed=1), side.table(40, seed=2)
    eng = side.engine(breaker_threshold=1)
    if path == "fused":
        monkeypatch.setattr(TR, "scan_multi", broken)
        ops = lowering_ops(T, left)
    elif path == "solo":
        monkeypatch.setattr(TK, "aggregate", broken)
        ops = [T.AggregateOp(left, "b")]
    else:
        monkeypatch.setattr(TK, "hash_join", broken)
        ops = [T.JoinOp(eng.register(left, ["a", "b"]), "b", "a", right, "g")]
    for _ in range(3):
        with pytest.raises(RuntimeError, match="CUDA error"):
            eng.execute_many(ops)
    assert eng.breaker.snapshot() == {"breaker_trips": 0, "breaker_fallbacks": 0,
                                      "breaker_probes": 0, "breaker_open": 0}


def test_real_kernel_error_on_a_shard_propagates_without_failover(monkeypatch):
    """A non-injected exception of the fused scan inside a shard pass is not
    an injected fault: no retry, no failover, nothing counted."""
    def broken(*args, **kwargs):
        raise RuntimeError("rm_scan_multi launch: CUDA error 700")

    side = SIDES[1]
    eng = side.sharded()
    monkeypatch.setattr(TR, "scan_multi", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        eng.execute_many(shard_ops(T, side.table()))
    assert (eng.stats.retries, eng.stats.failovers, eng.stats.bytes_failover) == (0, 0, 0)
    assert eng.shard_health() == ["healthy", "healthy"]
