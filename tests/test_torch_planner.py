"""Planner parity: the same plans compiled by both packages.

Tables are built by the JAX package from seeded numpy columns and carried
into the port byte for byte (``RelationalTable.from_state``).  Every plan is
compiled by ``repro.core.compile_plan`` on a JAX engine (Pallas kernels in
interpret mode) and by ``repro_torch.core.compile_plan`` on a CPU engine;
both must choose the same ``route``, fire the same ``passes``, print the
same ``explain()`` text, return equal results and leave equal
``EngineStats`` (the join counters included).

Tolerances: packed blocks, masks, join outputs, counts and int32-valued
sums bit-equal.  A finalized average divides two float32 values on both
sides: equal within 1 ulp.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
import strategies  # noqa: E402
import test_compressed_execution as tce  # noqa: E402
from repro.core import operators as JO  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro_torch.core import operators as TO  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from test_torch_state import state_of  # noqa: E402

# the sharded backend and fault tolerance are later slices
OUT_OF_SLICE = {"bytes_collective", "collective_ops", "retries", "failovers",
                "bytes_failover"}


def port(t):
    return T.RelationalTable.from_state(state_of(t))


def engines(**kw):
    return J.RelationalMemoryEngine(**kw), T.RelationalMemoryEngine(device="cpu", **kw)


@pytest.fixture(autouse=True)
def _fresh_build_caches():
    JP.clear_join_build_cache()
    TP.clear_join_build_cache()
    yield
    JP.clear_join_build_cache()
    TP.clear_join_build_cache()


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_same(j, t):
    if isinstance(j, (J.JoinResult, JP.MultiJoinResult)):
        assert type(t).__name__ == type(j).__name__
        for f in dataclasses.fields(j):
            assert_same(getattr(j, f.name), getattr(t, f.name))
        return
    if isinstance(j, tuple):
        assert isinstance(t, tuple) and len(t) == len(j)
        for a, b in zip(j, t):
            assert_same(a, b)
        return
    if isinstance(j, float):
        assert isinstance(t, float)
        np.testing.assert_array_max_ulp(np.float32(t), np.float32(j), maxulp=1)
        return
    want, got = to_np(j), to_np(t)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind == "f":
        np.testing.assert_array_max_ulp(got.astype(np.float32),
                                        want.astype(np.float32), maxulp=1)
    else:
        np.testing.assert_array_equal(got, want)


def assert_stats(je, te):
    js, ts = dataclasses.asdict(je.stats), dataclasses.asdict(te.stats)
    assert set(js) == set(ts)
    diff = {k: (js[k], ts[k]) for k in js if k not in OUT_OF_SLICE and js[k] != ts[k]}
    assert not diff, diff


def compile_pair(spell, tables, je, te, options=None, **kw):
    """Compile ``spell(pkg, *tables)`` in both packages; check route, passes,
    explain and the join order; return the two physical queries."""
    jq = J.compile_plan(spell(J, *tables[0]), je,
                        options=None if options is None else J.CompileOptions(**options), **kw)
    tq = T.compile_plan(spell(T, *tables[1]), te,
                        options=None if options is None else T.CompileOptions(**options), **kw)
    assert tq.route == jq.route
    assert tq.passes == jq.passes
    assert tq.explain() == jq.explain()
    assert tq.join_order == jq.join_order
    assert tq.backend == jq.backend == "single"
    return jq, tq


def run_pair(spell, tables, je, te, options=None, **kw):
    jq, tq = compile_pair(spell, tables, je, te, options, **kw)
    j, t = jq.run(), tq.run()
    assert_same(j, t)
    assert_stats(je, te)
    return j, t


# -------------------------------------------------- the differential matrix
def spelling(kind, p, decorated):
    """The ``kind`` plan of a case, optionally in the decorated spelling the
    optimizer must canonicalize (as ``tests/test_optimizer.py`` spells it)."""
    def spell(pkg, t):
        b = pkg.plan(t)
        if kind == "project":
            if decorated:
                b = b.project(*t.schema.names)
            return b.project(*p["cols"])
        if kind == "filter":
            if decorated:
                return (b.project(*p["cols"])
                        .filter(p["pred_col"], p["pred_op"], p["pred_k"]))
            return b.filter(p["pred_col"], p["pred_op"], p["pred_k"]).project(*p["cols"])
        if kind == "aggregate":
            b = b.filter(p["pred_col"], p["pred_op"], p["pred_k"])
            if decorated:
                b = b.project(*t.schema.names)
            return b.sum(p["agg_col"])
        if decorated:
            b = b.project(p["group_col"], p["agg_col"])
        return b.groupby(p["group_col"], p["agg_col"], "sum", p["num_groups"])
    return spell


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", strategies.PLAN_KINDS)
def test_differential_matrix(seed, kind):
    """Optimized, unoptimized and decorated spellings of every plan kind, on
    the encoded table and its plain twin: the port equals the JAX package
    case for case."""
    enc_j, plain_j, ts = tce._build_twins(seed)
    p = strategies.plan_params(seed, kind)
    opts = {"snapshot_ts": ts if p["snapshot"] else None}
    for table_j in (enc_j, plain_j):
        tables = ((table_j,), (port(table_j),))
        je, te = engines()
        for decorated in (True, False):
            for optimize in (True, False):
                run_pair(spelling(kind, p, decorated), tables, je, te,
                         options=opts, optimize=optimize)


# ------------------------------------------------------------------- joins
def join_fixture(n=200, unique_probe=False, seed=42):
    """The three tables of ``tests/test_optimizer.py``'s join cases, in both
    packages."""
    rng = np.random.default_rng(seed)
    k1 = (rng.permutation(np.arange(n, dtype=np.int32)) if unique_probe
          else rng.integers(0, 50, n).astype(np.int32))
    probe = {"K1": k1, "K2": rng.integers(0, 30, n).astype(np.int32),
             "V": rng.integers(-50, 50, n).astype(np.int32)}
    bk1 = np.unique(rng.integers(0, 50, 40).astype(np.int32))
    b1 = {"K1": bk1, "B1": rng.integers(-9, 9, bk1.size).astype(np.int32)}
    bk2 = np.unique(rng.integers(0, 30, 25).astype(np.int32))
    b2 = {"K2": bk2, "B2": rng.integers(-9, 9, bk2.size).astype(np.int32)}

    def tables(pkg):
        def mk(cols):
            schema = pkg.TableSchema(tuple(pkg.Column(c, "int32") for c in cols))
            return pkg.RelationalTable.from_columns(schema, cols)
        return mk(probe), mk(b1), mk(b2)

    return tables(J), tables(T)


def chain(pkg, probe, b1, b2):
    return (pkg.plan(probe).join(b1, "K1", "V", "B1")
            .join(b2, "K2", "V", "B2"))


def single(pkg, probe, b1, b2):
    return pkg.plan(probe).join(b1, "K1", "V", "B1")


ROUTES = ("device-hash-join", "shared-scan-join", "flipped-scan-join")


@pytest.mark.parametrize("route", ROUTES)
def test_join_routes_agree_with_each_other_and_jax(route):
    tables = join_fixture(unique_probe=True)
    je, te = engines()
    j, t = run_pair(single, tables, je, te, options={"join_route": route})
    # warm: the second run hits the build cache in both packages
    run_pair(single, tables, je, te, options={"join_route": route})
    assert TP.JOIN_BUILD_STATS == JP.JOIN_BUILD_STATS
    assert TP.JOIN_BUILD_STATS["hits"] >= 1
    # every route gives the device route's answer
    ref_e = T.RelationalMemoryEngine(device="cpu")
    want = T.compile_plan(single(T, *tables[1]), ref_e, options=T.CompileOptions(
        join_route="device-hash-join")).run()
    for f in ("s_proj", "r_proj", "matched"):
        assert torch.equal(getattr(t, f), getattr(want, f)), f


def test_route_chooser_matches_cold_and_warm():
    """The costed route choice follows the cache state alike in both."""
    tables = join_fixture(unique_probe=True)
    je, te = engines()
    for _ in range(3):
        run_pair(single, tables, je, te)
    run_pair(lambda pkg, p, b1, b2: pkg.plan(p).project("V", "K1"), tables, je, te)
    run_pair(single, tables, je, te)


def test_multi_join_chain_and_cost_order():
    tables = join_fixture()
    je, te = engines()
    # warm b2's device build, leave b1 cold: the chain probes b2 first
    run_pair(lambda pkg, p, b1, b2: pkg.plan(p).join(b2, "K2", "V", "B2"),
             tables, je, te, options={"join_route": "device-hash-join"})
    jq, tq = compile_pair(chain, tables, je, te)
    assert [k for k, _, _ in tq.join_order] == ["K2", "K1"]
    assert_same(jq.run(), tq.run())
    assert_stats(je, te)
    assert te.stats.join_builds == 2


def test_joins_in_one_execute_many_batch_share_the_probe_scan():
    """A join beside other ops on its table probes the shared pass's packed
    block; a join alone on its table streams the row-store chunks."""
    (jp, jb1, _), (tp, tb1, _) = join_fixture()
    je, te = engines()

    def ops(pkg, eng, p, b1, ts):
        view = eng.register(p, ("V", "K1"), snapshot_ts=ts)
        return [pkg.JoinOp(view, "V", "K1", b1, "B1", snapshot_ts=ts),
                pkg.AggregateOp(p, "V", "K2", "gt", 10, snapshot_ts=ts),
                pkg.ProjectOp(eng.register(p, ("K2",)))]

    for ts in (None, 0):
        for batch in (ops, lambda pkg, eng, p, b1, ts: ops(pkg, eng, p, b1, ts)[:1]):
            for a, b in zip(je.execute_many(batch(J, je, jp, jb1, ts)),
                            te.execute_many(batch(T, te, tp, tb1, ts))):
                assert_same(a, b)
            assert_stats(je, te)
    # a JoinOp built without cached partitions builds its own each time
    assert te.stats.shared_scans == 2 and te.stats.join_builds == 4


def test_snapshot_join_after_writes_and_build_mutation():
    (jp, jb1, jb2), (tp, tb1, tb2) = join_fixture()
    je, te = engines()
    tables = ((jp, jb1, jb2), (tp, tb1, tb2))
    rng = np.random.default_rng(3)
    for step in range(3):
        rows = rng.choice(jb1.row_count, 3, replace=False)
        vals = {"B1": rng.integers(-9, 9, 3).astype(np.int32)}
        for b in (jb1, tb1):
            b.update(rows, vals)  # MVCC version pairs: duplicate build keys
        extra = {"K1": rng.integers(0, 50, 9).astype(np.int32),
                 "K2": rng.integers(0, 30, 9).astype(np.int32),
                 "V": rng.integers(-50, 50, 9).astype(np.int32)}
        for p in (jp, tp):
            p.append(extra)
            p.delete(np.array([step, 10 + step]))
        ts = max(jp.now(), jb1.now())
        run_pair(single, tables, je, te, options={"snapshot_ts": ts})
        run_pair(single, tables, je, te, options={"snapshot_ts": ts - 1})
        # unpinned: both build versions match and their payloads add
        run_pair(single, tables, je, te,
                 options={"join_route": "device-hash-join"})
    assert te.stats.join_builds == 3


def test_probe_predicate_pushed_below_the_join():
    tables = join_fixture()
    je, te = engines()
    run_pair(lambda pkg, p, b1, b2: pkg.plan(p).filter("K2", "gt", 12)
             .join(b1, "K1", "V", "B1"), tables, je, te)
    run_pair(lambda pkg, p, b1, b2: pkg.plan(p).filter("K2", "lt", 7)
             .join(b1, "K1", "V", "B1").join(b2, "K2", "V", "B2"), tables, je, te)


@pytest.mark.parametrize("seed", range(4))
def test_encoded_joins_on_a_shared_dictionary(seed):
    (enc_p, enc_b), (plain_p, plain_b), _ = strategies.build_tables(seed)
    for probe, build in ((enc_p, enc_b), (plain_p, plain_b)):
        tables = ((probe, build), (port(probe), port(build)))
        je, te = engines()
        for route in ("device-hash-join", "shared-scan-join"):
            run_pair(lambda pkg, p, b: pkg.plan(p).join(b, "K", "V", "B"),
                     tables, je, te, options={"join_route": route})


@pytest.mark.parametrize("path", ["row", "col"])
def test_host_paths_join_and_scan(path):
    (jp, jb1, jb2), (tp, tb1, tb2) = join_fixture()
    je, te = engines()
    tables = ((jp, jb1, jb2), (tp, tb1, tb2))
    opts = {"path": path}
    if path == "col":
        opts["colstore"] = J.columnar_copy(jp, ["K1", "K2", "V"])
        np.testing.assert_equal(T.columnar_copy(tp, ["K1", "K2", "V"]), opts["colstore"])
        opts["right_colstore"] = J.columnar_copy(jb1, ["K1", "B1"])
    run_pair(single, tables, je, te, options=opts)
    run_pair(lambda pkg, p, b1, b2: pkg.plan(p).filter("K2", "gt", 3)
             .join(b1, "K1", "V", "B1"), tables, je, te, options=opts)
    run_pair(lambda pkg, p, b1, b2: pkg.plan(p).filter("V", "lt", 0).project("K2", "V"),
             tables, je, te, options=opts)
    run_pair(lambda pkg, p, b1, b2: pkg.plan(p).filter("V", "lt", 10).sum("K2"),
             tables, je, te, options=opts)
    run_pair(lambda pkg, p, b1, b2: pkg.plan(p).groupby("K2", "V", "avg", 6),
             tables, je, te, options=opts)


# ------------------------------------------------- operators and the API
@pytest.mark.parametrize("path", ["rme", "row", "col"])
def test_operators_q0_to_q5(path):
    rng = np.random.default_rng(5)
    cols = {f"A{i + 1}": rng.integers(-100, 100, 400).astype(np.int32) for i in range(16)}
    rcols = {f"A{i + 1}": rng.integers(-50, 50, 96).astype(np.int32) for i in range(16)}
    rcols["A2"] = np.arange(96, dtype=np.int32)
    je, te = engines()
    js, jr = (J.RelationalTable.from_columns(J.benchmark_schema(64, 4), c)
              for c in (cols, rcols))
    ts_, tr = port(js), port(jr)
    kw_j = kw_t = {}
    if path == "col":
        kw_j = kw_t = {"colstore": JO.make_colstore(js, [f"A{i}" for i in range(1, 5)])}
    for name, args in (("q0", ()), ("q1", (("A1", "A3"),)), ("q2", ()), ("q3", ()),
                       ("q4", ())):
        assert_same(JO.run_query(name, je, js, *args, path=path, **kw_j),
                    TO.run_query(name, te, ts_, *args, path=path, **kw_t))
        assert_stats(je, te)
    q5_kw = {}
    if path == "col":
        q5_kw = {"s_colstore": JO.make_colstore(js, ["A1", "A2"]),
                 "r_colstore": JO.make_colstore(jr, ["A2", "A3"])}
    assert_same(JO.q5_hash_join(je, js, jr, path=path, **q5_kw),
                TO.q5_hash_join(te, ts_, tr, path=path, **q5_kw))
    assert_stats(je, te)


def test_cost_model_batch_plan_and_execute_sum():
    rng = np.random.default_rng(8)
    cols = {f"A{i + 1}": rng.integers(-100, 100, 300).astype(np.int32) for i in range(16)}
    je, te = engines()
    jt = J.RelationalTable.from_columns(J.benchmark_schema(64, 4), cols)
    tt = port(jt)
    for group in (["A1"], ["A1", "A2", "A3"], [f"A{i}" for i in range(1, 13)]):
        assert str(TP.plan_query(te, tt, group)) == str(JP.plan_query(je, jt, group))
    groups = [["A1", "A2"], ["A2", "A5"], ["A9"]]
    assert str(TP.plan_batch(te, tt, groups)) == str(JP.plan_batch(je, jt, groups))
    for args in (("A1",), ("A2", "A3", "gt", 5), ("A4", "A5", "lt", 0)):
        (js_, jplan), (ts__, tplan) = (JP.execute_sum(je, jt, *args),
                                       TP.execute_sum(te, tt, *args))
        assert str(tplan) == str(jplan) and ts__ == js_
    te.register(tt, ["A1", "A2", "A3"]).packed()
    je.register(jt, ["A1", "A2", "A3"]).packed()
    assert str(TP.plan_query(te, tt, ["A1", "A2", "A3"])) == str(
        JP.plan_query(je, jt, ["A1", "A2", "A3"]))
    assert_stats(je, te)


def test_legacy_spelling_warns_and_matches():
    tables = join_fixture()
    je, te = engines()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with pytest.raises(DeprecationWarning, match="CompileOptions"):
            T.compile_plan(te, single(T, *tables[1]), path="rme")
    with pytest.warns(DeprecationWarning):
        legacy = T.compile_plan(te, single(T, *tables[1]), join_route="shared-scan-join")
    with pytest.warns(DeprecationWarning):
        want = J.compile_plan(je, single(J, *tables[0]), join_route="shared-scan-join")
    assert legacy.route == want.route == "shared-scan-join"
    assert_same(want.run(), legacy.run())
    q = single(T, *tables[1])
    with pytest.raises(TypeError, match="not both"):
        T.compile_plan(q, te, options=T.CompileOptions(), path="rme")
    with pytest.raises(TypeError, match="unexpected keyword"):
        T.compile_plan(q, te, no_such_option=1)
    with pytest.raises(TypeError, match="needs a plan and an engine"):
        T.compile_plan(q)
    with pytest.raises(T.PlanError, match="backend"):
        T.compile_plan(q, te, options=T.CompileOptions(backend="sharded"))


def test_reset_clears_the_join_build_cache_and_keys_by_device():
    tables = join_fixture()
    je, te = engines()
    run_pair(single, tables, je, te, options={"join_route": "device-hash-join"})
    _, b1, _ = tables[1]
    assert TP._peek_build_entry(b1, "K1", "B1", TP.DEVICE_JOIN_PATH, te.device) is not None
    # an entry built on one device is never handed to an engine on another
    assert TP._peek_build_entry(b1, "K1", "B1", TP.DEVICE_JOIN_PATH,
                                torch.device("cuda")) is None
    je.reset()
    te.reset()
    assert not TP._BUILD_INDEX_CACHE and TP._build_index_bytes == 0
    assert TP.JOIN_BUILD_STATS == {"hits": 0, "misses": 0}
    run_pair(single, tables, je, te, options={"join_route": "device-hash-join"})
    assert te.stats.join_builds == 2
