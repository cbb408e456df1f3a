"""The port's spans (``repro_torch.tracing``): the gate that makes them
nothing when no profiler records, and the tree a ``torch.profiler`` session
sees inside a served tick and a train step, counted against the program's
own counters."""

import contextlib
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as T
from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.core.plan import plan
from repro_torch.data import RecordStore, TrainPipeline, synthetic_corpus
from repro_torch.models import build_model
from repro_torch.serve import QueryServer
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.step import init_train_state


def recorded(fn) -> list:
    """The ``rm::`` events of a CPU profile around ``fn()``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith("rm::")]


def names(events) -> list[str]:
    return [e.name for e in events]


def parents(e) -> list[str]:
    """The names of ``e``'s enclosing ``rm::`` spans, innermost first."""
    out, p = [], e.cpu_parent
    while p is not None:
        if p.name.startswith("rm::"):
            out.append(p.name)
        p = p.cpu_parent
    return out


def table(n: int = 512):
    rng = np.random.default_rng(0)
    cols = {f"A{i + 1}": rng.integers(-100, 100, n).astype(np.int32) for i in range(16)}
    return T.RelationalTable.from_columns(T.benchmark_schema(64, 4), cols)


def server(**kw):
    return QueryServer(T.RelationalMemoryEngine(device="cpu"), snapshot_reads=True,
                       pipeline=True, lanes=True, **kw)


# ---------------------------------------------------------------- the gate
def test_without_a_profiler_a_span_is_the_one_shared_null_context():
    a, b = tracing.span("rm::a"), tracing.span(tracing.WAIT)
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = tracing.span("rm::a")
        assert on is not a
        assert isinstance(on, torch._C._profiler._RecordFunctionFast)
    assert tracing.span("rm::a") is a


def test_a_span_lands_in_the_trace_only_while_recording():
    def body():
        with tracing.span("rm::outer"):
            with tracing.span("rm::inner"):
                torch.ones(4).sum()

    body()  # nothing records: nothing to see, nothing raised
    ev = recorded(body)
    assert sorted(names(ev)) == ["rm::inner", "rm::outer"]
    inner = next(e for e in ev if e.name == "rm::inner")
    assert parents(inner) == ["rm::outer"]


# ---------------------------------------------------------------- serving
def test_a_tick_nests_compile_launch_pass_and_the_express_wait():
    t, srv = table(), server()
    total = srv.submit(plan(t).sum("A1"))
    packed = srv.submit(plan(t).project("A1", "A3"))
    ev = recorded(srv.drain)
    assert total.lane == "express" and packed.lane == "bulk"
    assert total.result(timeout=0) == pytest.approx(float(t.read_column("A1").sum()))
    assert names(ev).count("rm::serve.tick") == 1
    assert names(ev).count("rm::serve.finish") == 1
    plans = [e for e in ev if e.name == "rm::planner.compile_plan"]
    assert len(plans) == 2
    assert all(parents(e) == ["rm::serve.compile", "rm::serve.tick"] for e in plans)
    (passes,) = [e for e in ev if e.name == "rm::engine.pass"]
    assert parents(passes) == ["rm::serve.launch", "rm::serve.tick"]
    # the express sum's pull of its scalar pair, inside the tick's finalize
    waits = [parents(e) for e in ev if e.name == tracing.WAIT]
    assert ["rm::serve.finalize", "rm::serve.tick"] in waits
    finalizes = [parents(e) for e in ev if e.name == "rm::serve.finalize"]
    assert sorted(finalizes) == [["rm::serve.finish"], ["rm::serve.tick"]]


@pytest.mark.parametrize("pipeline", [True, False])
def test_span_counts_equal_the_servers_counters(pipeline):
    t = table()
    srv = QueryServer(T.RelationalMemoryEngine(device="cpu"), snapshot_reads=True,
                      pipeline=pipeline, lanes=True, max_batch=3)
    queries = [plan(t).sum("A1"), plan(t).project("A2"),
               plan(t).filter("A3", "gt", 0).project("A4", "A5"),
               plan(t).groupby("A2", "A6", "avg", 16), plan(t).filter("A7", "lt", 5).sum("A8")]

    def serve():
        for q in queries * 2:
            srv.submit(q)
        srv.drain()
        srv.drain()  # an empty poll opens no tick span

    before = (srv.stats.ticks, srv.stats.served)
    ev = recorded(serve)
    assert names(ev).count("rm::serve.tick") == srv.stats.ticks - before[0] == 4
    assert names(ev).count("rm::planner.compile_plan") == srv.stats.served - before[1] == 10
    assert names(ev).count("rm::serve.compile") == 4
    # the express lane drains first: two ticks of three express reads, then
    # the two that carry the bulk reads, each finished by a finish span
    assert names(ev).count("rm::serve.finish") == 2


def test_a_deferred_express_read_settles_inside_finish(monkeypatch):
    """An express sum whose answer is not ready at ``begin_tick`` (as on the
    card while its pass runs) is settled in ``finish_tick``: one
    ``rm::serve.settle`` a deferred read, inside ``rm::serve.finish``, holds
    its wait, and the tick holds none."""
    monkeypatch.setattr(T.planner.PhysicalQuery, "ready", lambda self, token: False)
    t, srv = table(), server()
    srv.engine.device_words(t)  # the row store's upload, a wait of its own
    total = srv.submit(plan(t).sum("A1"))
    packed = srv.submit(plan(t).project("A1", "A3"))
    alone = srv.submit(plan(t).filter("A2", "gt", 0).sum("A4"))
    ev = recorded(lambda: (srv.drain(), srv.submit(plan(t).sum("A5")), srv.drain()))
    assert total.lane == alone.lane == "express" and packed.done()
    assert total.result(timeout=0) == pytest.approx(float(t.read_column("A1").sum()))
    settles = [parents(e) for e in ev if e.name == "rm::serve.settle"]
    assert settles == [["rm::serve.finish"]] * 3 and srv.stats.express_deferred == 3
    # the express-only second tick opens finish for its deferred read
    assert names(ev).count("rm::serve.tick") == names(ev).count("rm::serve.finish") == 2
    waits = [parents(e) for e in ev if e.name == tracing.WAIT]
    assert waits.count(["rm::serve.settle", "rm::serve.finish"]) == 3
    assert not [w for w in waits if "rm::serve.tick" in w]


def test_the_engines_blocking_members_are_waits():
    t = table()
    eng = T.RelationalMemoryEngine(device="cpu")
    ev = recorded(lambda: eng.aggregate(t, "A1"))
    assert names(ev).count(tracing.WAIT) == 2  # the row store's upload, the pair's pull
    ev = recorded(lambda: eng.aggregate(t, "A1"))
    assert names(ev).count(tracing.WAIT) == 1
    handle = eng.execute_many_async([T.AggregateOp(t, "A1")])
    ev = recorded(handle.block_until_ready)
    assert names(ev) == [tracing.WAIT]


# ---------------------------------------------------------------- training
def test_a_train_step_of_two_microbatches():
    cfg = get_smoke_config("qwen3-8b")
    model = build_model(cfg, device="cpu", seed=0, param_dtype=cfg.param_dtype)
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3), grad_accum=2)
    store = RecordStore(seq_len=16, device="cpu")
    store.ingest(*synthetic_corpus(32, 16, cfg.vocab, seed=1))
    batches = TrainPipeline(store, batch_size=4, seed=0).batches()
    state = init_train_state(model)
    state, _ = step_fn(state, next(batches))  # the row store's upload is set-up's

    def step():
        step_fn(state, next(batches))

    ev = recorded(step)
    count = {n: names(ev).count(n) for n in set(names(ev)) - {tracing.GC}}
    assert count == {"rm::data.batch": 1, "rm::train.forward": 2,
                     "rm::train.backward": 2, "rm::train.update": 1}
    assert all(parents(e) == [] for e in ev if e.name != tracing.GC)


# ---------------------------------------------------------------- collector
def test_the_collector_is_a_span_only_while_recording():
    def collect():
        gc.collect()

    collect()  # off: the hook opens nothing and leaves nothing open
    assert names(recorded(collect)).count(tracing.GC) == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    gc.collect()  # after the session: not recorded anywhere
    assert not [e for e in prof.events() if e.name == tracing.GC]
