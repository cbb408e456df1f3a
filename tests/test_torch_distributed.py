"""The sharded backend and the free ``dist_*`` operators, side by side with
the JAX package (``tests/test_distributed.py``'s sharded cases).

Tables are built from the same seeded numpy columns in both packages (the
encoded ones carried into the port byte for byte).  The JAX engines run in
this process on its one CPU device (``ShardedEngine(num_shards=...)`` runs
logical shards there; its Pallas kernels in interpret mode); the port's on
the CPU (``device="cpu"``), logical shards or a ``mesh`` of CPU devices.
Results must be equal — packed blocks, masks, join outputs, counts and
sums bit-equal (int32 payloads below 2^24, so re-associated float32 sums
are exact) — and every ``EngineStats`` field must be equal, the collective
and failover counters included.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.core as J  # noqa: E402
import repro.serve as JS  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
import strategies  # noqa: E402
from repro.core import distributed as JD  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.kernels.ref import groupby_sum_ref, hash_join_ref  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.kernels import rme_scan_multi as TR  # noqa: E402
from test_torch_planner import port  # noqa: E402

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _fresh_build_caches():
    JP.clear_join_build_cache()
    TP.clear_join_build_cache()
    yield
    JP.clear_join_build_cache()
    TP.clear_join_build_cache()


# ------------------------------------------------------------------ helpers
def sharded_case(seed=7, n=1003, n_extra=37):
    """``tests/test_distributed.py::_sharded_case``: bounded int values, so
    every partial sum is exact in float32."""
    rng = np.random.default_rng(seed)
    names = [f"A{i + 1}" for i in range(16)]
    cols = {c: rng.integers(-50, 50, n).astype(np.int32) for c in names}
    extra = {c: rng.integers(-50, 50, n_extra).astype(np.int32) for c in names}
    return cols, extra


def table(pkg, cols):
    return pkg.RelationalTable.from_columns(pkg.benchmark_schema(64, 4),
                                            {k: v.copy() for k, v in cols.items()})


def jax_sharded(num_shards, revision="mlp", **kw):
    return JD.ShardedEngine(num_shards=num_shards, revision=revision, **kw)


def port_sharded(num_shards, **kw):
    return T.ShardedEngine(num_shards=num_shards, device="cpu", **kw)


def mk_ops(pkg, engine, t, r_t, snapshot_ts=None):
    return [
        pkg.ProjectOp(engine.register(t, ("A1", "A2"))),
        pkg.FilterOp(engine.register(t, ("A1", "A3")), "A3", "gt", 5,
                     snapshot_ts=snapshot_ts),
        pkg.AggregateOp(t, "A1", pred_col="A2", pred_op="lt", pred_k=0,
                        snapshot_ts=snapshot_ts),
        pkg.GroupByOp(t, "A2", "A1", 16, snapshot_ts=snapshot_ts),
        pkg.JoinOp(engine.register(t, ("A1", "A4")), "A1", "A4", r_t, "A3",
                   snapshot_ts=snapshot_ts),
    ]


def flatten(result):
    if hasattr(result, "s_proj"):
        return [result.s_proj, result.r_proj, result.matched]
    if isinstance(result, (tuple, list)):
        return [x for r in result for x in flatten(r)]
    return [result]


def to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_results_equal(want, got, label=""):
    a, b = flatten(want), flatten(got)
    assert len(a) == len(b), label
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = to_np(x), to_np(y)
        assert y.shape == x.shape, (label, i)
        np.testing.assert_array_equal(y, x, err_msg=f"{label} output {i}")


def assert_stats_equal(je, te):
    js, ts = dataclasses.asdict(je.stats), dataclasses.asdict(te.stats)
    assert set(js) == set(ts)
    diff = {k: (js[k], ts[k]) for k in js if js[k] != ts[k]}
    assert not diff, diff


# ------------------------------------------------------------- shard_ranges
@pytest.mark.parametrize("n_rows,shards", [(0, 3), (1, 4), (7, 3), (1003, 4),
                                           (1003, 8), (64, 1), (5, 8)])
def test_shard_ranges_match_jax(n_rows, shards):
    got = T.shard_ranges(n_rows, shards)
    assert got == JD.shard_ranges(n_rows, shards)
    assert sum(n for _, n in got) == n_rows
    assert [s for s, _ in got] == list(np.cumsum([0] + [n for _, n in got])[:-1])


# ------------------------------------------------------- engine equality
@pytest.mark.parametrize("snapshot", [False, True])
@pytest.mark.parametrize("shards", [3, 4])
def test_sharded_engine_matches_single_device(shards, snapshot):
    """Every op kind, with and without a snapshot, on a table whose row
    count the shard count does not divide: the port's sharded engine equals
    its single-device engine and both JAX engines, stats field for field."""
    cols, _ = sharded_case()
    rng_r = np.random.default_rng(11)
    r_cols = {f"A{i + 1}": rng_r.integers(-50, 50, 130).astype(np.int32)
              for i in range(16)}
    r_cols["A1"] = np.arange(130, dtype=np.int32) - 7  # unique keys incl. 0

    def run(pkg, engine):
        t, r_t = table(pkg, cols), table(pkg, r_cols)
        ts = t.now() if snapshot else None
        return engine.execute_many(mk_ops(pkg, engine, t, r_t, snapshot_ts=ts))

    ref = run(J, J.RelationalMemoryEngine())
    je, te = jax_sharded(shards), port_sharded(shards)
    want, got = run(J, je), run(T, te)
    assert_results_equal(ref, want, "jax sharded")
    assert_results_equal(ref, got, "port sharded")
    assert_results_equal(ref, run(T, T.RelationalMemoryEngine(device="cpu")),
                         "port single")
    assert_stats_equal(je, te)
    # the aggregate's and the group-by's combines; the join rode the fused
    # pass and probed its gathered packed block, so nothing was broadcast
    assert te.stats.collective_ops == 2


def test_sharded_mixed_tick_one_fused_pass_per_shard(monkeypatch):
    """A mixed-kind tick launches exactly one fused ``scan_multi`` per
    shard, and the server snapshots agree across packages."""
    cols, _ = sharded_case()
    calls = []
    orig = TR.scan_multi

    def spy(words, requests):
        calls.append((words.shape[0], len(tuple(requests))))
        return orig(words, requests)

    monkeypatch.setattr(TR, "scan_multi", spy)
    snaps = []
    for pkg, serve, engine in ((J, JS, jax_sharded(4, "xla")),
                               (T, TS, port_sharded(4))):
        t = table(pkg, cols)
        server = serve.QueryServer(engine, snapshot_reads=False)
        for q in (pkg.plan(t).project("A1", "A2"),
                  pkg.plan(t).aggregate("A1", "sum"),
                  pkg.plan(t).groupby("A2", "A1", "sum", num_groups=8)):
            server.submit(q)
        server.run_tick()
        assert engine.stats.shared_scans == 1
        snaps.append(server.snapshot())
    assert len(calls) == 4, calls  # one fused pass per shard, nothing else
    assert all(n_req == 3 for _, n_req in calls), calls
    assert sum(rows for rows, _ in calls) == 1003
    jsnap, tsnap = snaps
    assert tsnap["engine_collective_ops"] == 2  # aggregate + group-by combines
    assert tsnap["engine_bytes_collective"] == 3 * (8 + 8 * 2 * 4)
    for k, v in tsnap.items():
        if k.startswith("engine_"):
            assert jsnap[k] == v, k


def test_sharded_append_lands_only_in_owning_shard():
    """An append uploads O(new rows) bytes to exactly one shard's chunks,
    round-robin; the chunk segments equal the JAX store's."""
    cols, extra = sharded_case()
    segs = []
    for pkg, engine in ((J, jax_sharded(4, "xla")), (T, port_sharded(4))):
        t = table(pkg, cols)
        engine.execute_many([pkg.AggregateOp(t, "A1")])  # full upload
        before = [[c.segments for c in chunks]
                  for chunks in engine.rowstore.shard_parts(t)]
        n0 = t.row_count
        t.append({k: v.copy() for k, v in extra.items()})
        delta0 = engine.stats.bytes_uploaded_delta
        engine.execute_many([pkg.AggregateOp(t, "A1")])  # syncs the delta
        assert engine.stats.bytes_uploaded_delta - delta0 == 37 * t.row_words * 4
        after = [[c.segments for c in chunks]
                 for chunks in engine.rowstore.shard_parts(t)]
        changed = [s for s in range(4) if after[s] != before[s]]
        assert changed == [0], changed  # exactly one owning shard grew
        assert after[0][-1] == ((n0, 37),)
        segs.append(after)
    assert segs[0] == segs[1]


def test_sharded_mvcc_snapshot_reads_under_concurrent_writes():
    """A pinned read is equal across backends and packages while writes
    land (append, delete, update)."""
    cols, extra = sharded_case(seed=13)

    def run(pkg, engine):
        t = table(pkg, cols)
        engine.execute_many([pkg.AggregateOp(t, "A1")])  # resident first
        ts = t.now()
        t.append({k: v.copy() for k, v in extra.items()})
        t.delete(np.arange(20))
        t.update(np.arange(30, 40), {"A1": np.full(10, 7, np.int32)})
        pinned = engine.execute_many([
            pkg.AggregateOp(t, "A1", snapshot_ts=ts),
            pkg.GroupByOp(t, "A2", "A1", 8, snapshot_ts=ts),
            pkg.FilterOp(engine.register(t, ("A1", "A2")), "A2", "gt", 0,
                         snapshot_ts=ts),
        ])
        live = engine.execute_many([pkg.AggregateOp(t, "A1", snapshot_ts=t.now())])
        return pinned + live

    ref = run(J, J.RelationalMemoryEngine(revision="xla"))
    je, te = jax_sharded(4, "xla"), port_sharded(4)
    assert_results_equal(ref, run(J, je), "jax sharded")
    assert_results_equal(ref, run(T, te), "port sharded")
    assert_stats_equal(je, te)


def test_sharded_compaction_and_patches_keep_global_order():
    """Sustained appends push every shard past ``MAX_TAIL_CHUNKS``: the
    shard-local compaction merges non-adjacent segments, later patches
    route through them, and every gathered consumer (``get``, ``chunks``,
    ``tail``, ``valid_mask``, a streamed projection) sees global row order."""
    cols, _ = sharded_case(n=203)
    rng = np.random.default_rng(3)
    batches = [{f"A{i + 1}": rng.integers(-50, 50, 5).astype(np.int32)
                for i in range(16)} for _ in range(4 * 9 + 1)]
    outs = []
    for pkg, engine in ((J, jax_sharded(4, "xla")), (T, port_sharded(4))):
        t = table(pkg, cols)
        engine.execute_many([pkg.AggregateOp(t, "A1")])
        for b in batches:
            t.append({k: v.copy() for k, v in b.items()})
            engine.execute_many([pkg.AggregateOp(t, "A1")])
        t.delete(np.arange(0, t.row_count, 7))
        t.update(np.arange(205, 260, 3), {"A1": np.full(19, 3, np.int32)})
        ts = t.now()
        res = engine.execute_many(mk_ops(pkg, engine, t, table(pkg, cols), ts)[:4])
        parts = engine.rowstore.shard_parts(t)
        # each shard compacted past MAX_TAIL_CHUNKS, then took more tails
        assert [len(p) for p in parts] == [3, 3, 2, 2]
        assert [len(p[0].segments) for p in parts] == [9, 9, 9, 9]
        words = to_np(engine.device_words(t))
        np.testing.assert_array_equal(words, t.words())
        np.testing.assert_array_equal(
            np.concatenate([to_np(c) for c in engine.device_chunks(t)]), t.words())
        np.testing.assert_array_equal(to_np(engine.rowstore.tail(t, 100)),
                                      t.words()[100:])
        np.testing.assert_array_equal(to_np(engine.valid_mask(t, ts)),
                                      (t.words()[:, 16] <= ts) & (ts < t.words()[:, 17]))
        stream = engine.stream_project(engine.register(t, ("A2", "A5")), chunk_rows=64)
        streamed = np.concatenate([to_np(c) for c in stream])
        np.testing.assert_array_equal(streamed, t.words()[:, [1, 4]])
        outs.append((res, [[c.segments for c in p] for p in parts], engine))
    assert_results_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    assert_stats_equal(outs[0][2], outs[1][2])


def test_held_results_do_not_change_under_later_patches():
    """The port patches timestamp words in place: a packed block, a filter
    result and a ``get()`` view handed out before a delete keep their
    contents (blocks carry no timestamp word; the view's user words are
    never patched)."""
    cols, _ = sharded_case(n=300)
    t = table(T, cols)
    eng = port_sharded(3)
    packed = eng.register(t, ("A1", "A2")).packed().clone()
    fp, fm = eng.execute_many([T.FilterOp(eng.register(t, ("A1", "A3")), "A3",
                                          "gt", 5, snapshot_ts=t.now())])[0]
    fp, fm = fp.clone(), fm.clone()
    held = eng.register(t, ("A1", "A2")).packed()
    view = eng.device_words(t)
    user_words = view[:, :16].clone()
    t.delete(np.arange(0, 300, 4))
    eng.execute_many([T.AggregateOp(t, "A1", snapshot_ts=t.now())])  # syncs
    assert torch.equal(held, packed)
    assert torch.equal(view[:, :16], user_words)
    again = eng.execute_many([T.FilterOp(eng.register(t, ("A1", "A3")), "A3",
                                         "gt", 5, snapshot_ts=t.now())])[0]
    assert torch.equal(again[1], fm & torch.from_numpy(
        np.arange(300) % 4 != 0))
    assert torch.equal(fp[again[1]], again[0][again[1]])


def test_zero_row_table_answers_empty():
    """A 0-row table owns no chunk on any shard: every request kind still
    answers with its canonical empty output, as the JAX engine does."""
    cols = {f"A{i + 1}": np.zeros(0, np.int32) for i in range(16)}
    r_cols = {f"A{i + 1}": np.arange(4, dtype=np.int32) for i in range(16)}
    je, te = jax_sharded(3, "xla"), port_sharded(3)
    want = je.execute_many(mk_ops(J, je, table(J, cols), table(J, r_cols)))
    got = te.execute_many(mk_ops(T, te, table(T, cols), table(T, r_cols)))
    assert_results_equal(want, got)
    assert_stats_equal(je, te)


def test_sharded_reset_drops_broadcast_cache():
    cols, _ = sharded_case()
    rng = np.random.default_rng(17)
    r_cols = {f"A{i + 1}": rng.integers(-50, 50, 64).astype(np.int32)
              for i in range(16)}
    r_cols["A1"] = np.arange(64, dtype=np.int32)
    stats = []
    for pkg, engine in ((J, jax_sharded(4)), (T, port_sharded(4))):
        t, r_t = table(pkg, cols), table(pkg, r_cols)

        def join():
            return engine.execute_many([pkg.JoinOp(
                engine.register(t, ("A1", "A4")), "A1", "A4", r_t, "A3")])

        first = join()
        assert engine._bcast_parts  # broadcast replicas cached
        ops0, bytes0 = engine.stats.collective_ops, engine.stats.bytes_collective
        engine.reset()
        assert not engine._bcast_parts
        assert_results_equal(first, join())  # the fresh build is broadcast again
        assert engine.stats.collective_ops == ops0 + 1
        assert engine.stats.bytes_collective == 2 * bytes0
        stats.append(engine)
    assert_stats_equal(*stats)


def test_broadcast_replicas_never_enter_the_build_cache():
    """A solo join served twice: one build in the planner's cache (on the
    root device), one broadcast; the warm tick reuses the replicas, which
    live only in the engine's broadcast cache."""
    cols, _ = sharded_case()
    r_cols = {f"A{i + 1}": np.arange(64, dtype=np.int32) for i in range(16)}
    server = TS.QueryServer(mesh=CPU8[:4])
    engine = server.engine
    t, r_t = table(T, cols), table(T, r_cols)
    results = []
    for _ in range(2):
        tk = server.submit(T.plan(t).join(r_t, key="A1", left_proj="A4",
                                          right_proj="A3"))
        server.drain()
        results.append(tk.result())
    assert_results_equal(*results)
    assert engine.stats.join_builds == 1
    (parts, replicas), = engine._bcast_parts.values()
    assert len(replicas) == 4
    assert len(TP._BUILD_INDEX_CACHE) == 1
    (entry,) = TP._BUILD_INDEX_CACHE.values()
    assert entry is parts
    assert engine.stats.bytes_collective == 3 * parts.nbytes
    assert engine.stats.collective_ops == 1


def test_sharded_collective_bytes_scale_with_results_not_rows():
    """Interconnect bytes are a function of result size only."""
    rng = np.random.default_rng(19)

    def collective_bytes(pkg, engine, n):
        t = table(pkg, {f"A{i + 1}": rng.integers(-50, 50, n).astype(np.int32)
                        for i in range(16)})
        engine.execute_many([pkg.AggregateOp(t, "A1"),
                             pkg.GroupByOp(t, "A2", "A1", 16)])
        return engine.stats.bytes_collective, engine.stats.bytes_from_dram

    for pkg, mk in ((J, lambda: jax_sharded(4, "xla")), (T, lambda: port_sharded(4))):
        coll_small, dram_small = collective_bytes(pkg, mk(), 500)
        coll_large, dram_large = collective_bytes(pkg, mk(), 2000)
        assert dram_large > 3 * dram_small  # the scan itself does scale
        assert coll_large == coll_small == 3 * (8 + 16 * 8)  # the interconnect does not


def test_group_ids_agree_across_paths():
    """Hostile keys (negative, near-overflow) group identically on the
    fused kernel, the sharded engine, ``dist_groupby`` and the oracle."""
    n, G = 512, 16
    rng = np.random.default_rng(23)
    hostile = np.concatenate([
        rng.integers(-(2**31), 2**31 - 1, n - 8).astype(np.int32),
        np.asarray([0, -1, -16, 2**31 - 1, -(2**31), 17, -17, 5], np.int32),
    ])
    cols = {f"A{i + 1}": rng.integers(-10, 10, n).astype(np.int32) for i in range(16)}
    cols["A2"] = hostile
    fused = T.RelationalMemoryEngine(device="cpu").execute_many(
        [T.GroupByOp(table(T, cols), "A2", "A1", G)])[0]
    sharded = port_sharded(4).execute_many([T.GroupByOp(table(T, cols), "A2", "A1", G)])[0]
    words = table(T, cols).words()
    dist = TD.dist_groupby(TD.pad_rows_to(words, 8), CPU8, group_word=1,
                           agg_word=0, num_groups=G, valid_rows=n)
    oracle = groupby_sum_ref(jnp.asarray(words), 1, 0, "int32", G)
    for got in (sharded, dist, oracle):
        assert_results_equal(fused, got)


# ------------------------------------------------------------------ mesh
def test_sharded_engine_on_mesh_matches_single_device():
    """``mesh=`` eight CPU devices against the JAX engine at 8 logical
    shards, through the QueryServer, writes included; each shard's buffers
    live on its own mesh device."""
    rng = np.random.default_rng(29)
    cols = {f"A{i + 1}": rng.integers(-50, 50, 1003).astype(np.int32) for i in range(16)}
    extra = {f"A{i + 1}": rng.integers(-50, 50, 21).astype(np.int32) for i in range(16)}

    def serve(pkg, server):
        t = table(pkg, cols)
        tickets = [
            server.submit(pkg.plan(t).project("A1", "A2")),
            server.submit(pkg.plan(t).filter("A3", "gt", 3).aggregate("A1", "sum")),
            server.submit(pkg.plan(t).groupby("A2", "A1", "sum", num_groups=8)),
            server.submit_insert(t, {k: v.copy() for k, v in extra.items()}),
            server.submit(pkg.plan(t).aggregate("A1", "count")),
        ]
        server.run_tick()
        return [tk.result(timeout=30) for tk in tickets], t

    ref, _ = serve(J, JS.QueryServer(J.RelationalMemoryEngine(revision="xla")))
    je = jax_sharded(8, "xla")
    want, _ = serve(J, JS.QueryServer(je))
    server = TS.QueryServer(mesh=CPU8)
    te = server.engine
    assert te.num_shards == 8 and te.backend == "sharded"
    got, t = serve(T, server)
    for i, (a, b, c) in enumerate(zip(ref, want, got)):
        if isinstance(c, float):
            assert a == b == c, i
        elif c is not None:
            assert_results_equal(a, c, f"query {i}")
            assert_results_equal(b, c, f"query {i}")
    for s, chunks in enumerate(te.rowstore.shard_parts(t)):
        assert all(c.words.device == CPU8[s] for c in chunks)
    assert_stats_equal(je, te)
    snap = server.snapshot()
    assert snap["engine_bytes_collective"] > 0 and snap["engine_collective_ops"] > 0
    assert snap["engine_shards_quarantined"] == 0


def test_mesh_and_device_arguments():
    assert T.ShardedEngine(mesh=CPU8, num_shards=3).num_shards == 3
    with pytest.raises(ValueError, match="exceeds mesh size"):
        T.ShardedEngine(mesh=CPU8[:2], num_shards=3)
    with pytest.raises(ValueError, match="not both"):
        T.ShardedEngine(mesh=CPU8, device="cpu")
    with pytest.raises(TypeError, match="sequence of devices"):
        T.ShardedEngine(mesh=make_mesh((1,), ("data",)))
    with pytest.raises(ValueError, match=">= 1"):
        port_sharded(0)
    with pytest.raises(ValueError, match="unsupported device"):
        T.ShardedEngine(mesh=["meta"])
    # one device type a mesh, checked before any device is resolved
    for mixed in (["cpu", "cuda"], [None, torch.device("cpu")]):
        with pytest.raises(ValueError, match="devices of one type"):
            T.ShardedEngine(mesh=mixed)
    if not torch.cuda.is_available():
        for kw in ({"num_shards": 4}, {"mesh": ["cuda"]}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                T.ShardedEngine(**kw)


# ---------------------------------------------------------- encoded columns
@pytest.mark.parametrize("seed", [4, 9])
def test_sharded_encoded_columns_match_single_device(seed):
    """Compressed execution on the sharded backend: shard-local predicate
    translation, per-code group-by partials combined before the remap, and
    shared-dictionary join keys through the broadcast — equal to the JAX
    engines, with the narrow word budget charged per shard chunk."""
    def run(pkg, engine, probe, build):
        ops = [
            pkg.FilterOp(engine.register(probe, ("K", "V")), "K", "gt", 0),
            pkg.AggregateOp(probe, "F", pred_col="K", pred_op="lt", pred_k=3),
            pkg.GroupByOp(probe, "K", "V", 16),
            pkg.GroupByOp(probe, "S", "V", len(strategies.STRING_POOL)),
            pkg.JoinOp(engine.register(probe, ("V", "K")), "V", "K", build, "B"),
        ]
        return engine.execute_many(ops)

    (probe, build), _, _ = strategies.build_tables(seed)
    ref = run(J, J.RelationalMemoryEngine(), probe, build)
    for shards in (3, 4):
        (probe, build), _, _ = strategies.build_tables(seed)
        je, te = jax_sharded(shards), port_sharded(shards)
        want = run(J, je, probe, build)
        got = run(T, te, port(probe), port(build))
        assert_results_equal(ref, want, f"jax shards={shards}")
        assert_results_equal(ref, got, f"port shards={shards}")
        assert_stats_equal(je, te)
        assert te.stats.bytes_saved_compression > 0


# ---------------------------------------------------------- free operators
def operator_case():
    rng = np.random.default_rng(2)
    n = 1003  # deliberately not divisible by 8: padding must be masked
    cols = {f"A{i + 1}": rng.integers(-100, 100, n).astype(np.int32) for i in range(16)}
    return n, cols


def test_distributed_relational_operators():
    """``dist_project`` / ``dist_aggregate`` / ``dist_groupby``: the JAX
    operators on a 1-device mesh, the port's over 8 CPU shards, both against
    numpy."""
    n, cols = operator_case()
    t = table(J, cols)
    geom = J.TableGeometry.from_schema(t.schema, ["A1", "A5"], row_count=n)
    tgeom = T.TableGeometry.from_schema(table(T, cols).schema, ["A1", "A5"], row_count=n)
    mesh = make_mesh((1,), ("data",))
    jw = JD.pad_rows_to(t.words(), 8)
    tw = TD.pad_rows_to(t.words(), 8)
    assert tw.shape == (1008, 18) and not tw[n:].any()
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))

    want = np.asarray(JD.dist_project(jw, geom, mesh, valid_rows=n))
    got = TD.dist_project(tw, tgeom, CPU8, valid_rows=n).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:n], np.stack([cols["A1"], cols["A5"]], 1))
    assert (got[n:] == 0).all(), "padding rows leaked into the packed output"

    want = np.asarray(JD.dist_aggregate(jw, mesh, agg_word=0, pred_word=2,
                                        pred_op="gt", pred_k=10, valid_rows=n))
    got = TD.dist_aggregate(tw, CPU8, agg_word=0, pred_word=2, pred_op="gt",
                            pred_k=10, valid_rows=n).numpy()
    sel = cols["A3"] > 10
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [cols["A1"][sel].sum(), sel.sum()])

    js, jc = JD.dist_groupby(jw, mesh, group_word=1, agg_word=0, num_groups=16,
                             valid_rows=n)
    ts, tc = TD.dist_groupby(tw, CPU8, group_word=1, agg_word=0, num_groups=16,
                             valid_rows=n)
    g = cols["A2"] % 16
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.bincount(g, weights=cols["A1"], minlength=16))
    np.testing.assert_array_equal(tc.numpy(), np.bincount(g, minlength=16))
    # a predicate on the group-by; valid_rows=None reads every (unpadded) row
    ts, tc = TD.dist_groupby(TD.pad_rows_to(t.words()[:1000], 8), CPU8, 1, 0, 16,
                             pred_word=4, pred_op="lt", pred_k=0)
    m = cols["A5"][:1000] < 0
    np.testing.assert_array_equal(tc.numpy(), np.bincount(g[:1000][m], minlength=16))


def test_dist_join_padding_regression():
    """Padded rows carry key word 0; a legitimate key-0 build row must match
    real probes and never the padding."""
    rng = np.random.default_rng(5)
    n_s, n_r = 1001, 117  # both non-divisible by 8
    s_cols = {f"A{i + 1}": rng.integers(-20, 20, n_s).astype(np.int32) for i in range(16)}
    r_cols = {f"A{i + 1}": rng.integers(-20, 20, n_r).astype(np.int32) for i in range(16)}
    r_cols["A2"] = np.arange(n_r, dtype=np.int32) - 3  # unique keys incl. 0
    s_t, r_t = table(J, s_cols), table(J, r_cols)
    mesh = make_mesh((1,), ("data",))
    geoms = {pkg: (pkg.TableGeometry.from_schema(s_t.schema, ["A1", "A2"], row_count=n_s),
                   pkg.TableGeometry.from_schema(s_t.schema, ["A2", "A3"], row_count=n_r))
             for pkg in (J, T)}
    kw = dict(s_key_word=1, s_val_word=0, r_key_word=0, r_val_word=1,
              s_valid_rows=n_s, r_valid_rows=n_r)
    want = JD.dist_join(JD.pad_rows_to(s_t.words(), 8), JD.pad_rows_to(r_t.words(), 8),
                        mesh, *geoms[J], **kw)
    s_val, r_val, matched = TD.dist_join(
        TD.pad_rows_to(s_t.words(), 8), TD.pad_rows_to(r_t.words(), 8),
        CPU8, *geoms[T], **kw)
    assert_results_equal(want, (s_val, r_val, matched))
    ref_s, ref_r, ref_m = hash_join_ref(
        jnp.asarray(s_cols["A2"]), jnp.asarray(s_cols["A1"]),
        jnp.asarray(r_cols["A2"]), jnp.asarray(r_cols["A3"]))
    assert_results_equal((ref_s, ref_r, ref_m), (s_val[:n_s], r_val[:n_s], matched[:n_s]))
    assert matched[:n_s][torch.from_numpy(s_cols["A2"] == 0)].all()
    assert not matched[n_s:].any(), "padding probed the build side"
    assert not s_val[n_s:].any() and not r_val[n_s:].any()


def test_dist_operators_refuse_unpadded_rows_and_bad_meshes():
    words = TD.pad_rows_to(np.zeros((10, 18), np.int32), 5)
    assert words.shape == (10, 18)
    with pytest.raises(ValueError, match="pad them first"):
        TD.dist_aggregate(words, CPU8[:3], agg_word=0)
    with pytest.raises(TypeError, match="sequence of devices"):
        TD.dist_aggregate(words, make_mesh((1,), ("data",)), agg_word=0)
    with pytest.raises(ValueError, match="at least one device"):
        TD.dist_aggregate(words, [], agg_word=0)
