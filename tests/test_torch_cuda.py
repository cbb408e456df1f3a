"""The CUDA scan kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; without a card each one
skips (the fixture decides, never the import).  Run them on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.

Tolerances: packed blocks, masks and counts bit-equal; sums of int32 columns
within ±1000 exact (every partial stays below 2^24 in float32); sums of
float32 columns within ``1e-5 * sum(|v|)`` (summation order differs).
"""

import ctypes
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import BatchExecutor, RelationalMemoryEngine, RelationalTable  # noqa: E402
from repro_torch.core.schema import Column, TableGeometry, TableSchema  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels.rme_join import bucket_fills  # noqa: E402
from repro_torch.kernels.rme_scan_multi import (  # noqa: E402
    AggregateRequest,
    FilterRequest,
    GroupByRequest,
    ProjectRequest,
)

pytestmark = pytest.mark.cuda

ROW_WORDS = 18  # 16 user words + the two MVCC words
I32 = np.iinfo(np.int32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_words(n, seed=0):
    """Words 0-11 int32 in [-1000, 1000), 12-15 float32, 16-17 MVCC; word 3
    carries the int32 extremes as group keys."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-1000, 1000, (n, ROW_WORDS)).astype(np.int32)
    w[:, 12:16] = rng.normal(0, 100, (n, 4)).astype(np.float32).view(np.int32)
    w[: min(n, 3), 3] = [I32.min, -1, I32.max][: min(n, 3)]
    w[:, 16] = rng.integers(0, 10, n)
    w[:, 17] = np.where(rng.random(n) < 0.3, rng.integers(3, 12, n), I32.max)
    return w


def geom(word_offsets, widths=None, row_words=ROW_WORDS):
    widths = widths or [1] * len(word_offsets)
    abs_b = [4 * o for o in word_offsets]
    rel = [abs_b[0]] + [abs_b[i] - abs_b[i - 1] for i in range(1, len(abs_b))]
    return TableGeometry(4 * row_words, 0, tuple(4 * w for w in widths), tuple(rel))


def assert_sum_close(got, want, absvals):
    got, want = got.double().cpu(), want.double().cpu()
    bound = 1e-5 * absvals.double().cpu() + 1e-6
    assert torch.all((got - want).abs() <= bound), (got, want)


def test_project_matches_plain(dev):
    for n in (1, 3, 1000, 4099):
        words = torch.from_numpy(make_words(n)).to(dev)
        g = geom([0, 4, 8, 12, 13])
        got = K.project(words, g)
        torch.cuda.synchronize()
        assert torch.equal(got, K.project_torch(words, g))


@pytest.mark.parametrize("pred_op", ["gt", "lt", "none"])
@pytest.mark.parametrize("pred", [(2, "int32", 5), (2, "int32", 2.7), (13, "float32", -3.5)])
@pytest.mark.parametrize("mvcc", [False, True])
def test_filter_matches_plain(dev, pred_op, pred, mvcc):
    words = torch.from_numpy(make_words(1000)).to(dev)
    word, dtype, k = pred
    args = dict(pred_word=word, pred_dtype=dtype, pred_op=pred_op, pred_k=k,
                ts=6 if mvcc else 0, ts_word=16 if mvcc else -1)
    g = geom([1, 2, 12])
    packed, mask = K.filter_project(words, g, **args)
    want_p, want_m = K.filter_project_torch(words, g, **args)
    assert torch.equal(packed, want_p) and torch.equal(mask, want_m)
    assert mask.dtype == torch.bool and mask.shape == (1000,)


@pytest.mark.parametrize("agg", [(0, "int32"), (14, "float32")])
@pytest.mark.parametrize("mvcc", [False, True])
def test_aggregate_matches_plain(dev, agg, mvcc):
    words = torch.from_numpy(make_words(5000)).to(dev)
    word, dtype = agg
    args = dict(agg_word=word, agg_dtype=dtype, pred_word=1, pred_op="gt",
                pred_k=-200, ts=6 if mvcc else 0, ts_word=16 if mvcc else -1)
    got, want = K.aggregate(words, **args), K.aggregate_torch(words, **args)
    assert got[1].item() == want[1].item()
    vals = words[:, word].view(torch.float32) if dtype == "float32" else words[:, word].float()
    if dtype == "int32":
        assert got[0].item() == want[0].item()
    else:
        assert_sum_close(got[0], want[0], vals.abs().sum())


@pytest.mark.parametrize("num_groups", [1, 7, 1000, 20000])
def test_groupby_matches_plain(dev, num_groups):
    words = torch.from_numpy(make_words(5000)).to(dev)
    args = dict(group_word=3, agg_word=0, num_groups=num_groups, pred_word=2,
                pred_op="lt", pred_k=500, ts=6, ts_word=16)
    sums, counts = K.groupby_sum(words, **args)
    want_s, want_c = K.groupby_sum_torch(words, **args)
    assert torch.equal(counts, want_c) and torch.equal(sums, want_s)


def mixed_requests():
    g = geom([0, 4, 8, 12])
    return [
        ProjectRequest(g),
        FilterRequest(geom([1, 2]), pred_word=5, pred_op="gt", pred_k=0,
                      ts_word=16, ts=6),
        AggregateRequest(agg_word=13, agg_dtype="float32", pred_word=0,
                         pred_op="lt", pred_k=100),
        GroupByRequest(group_word=3, agg_word=1, num_groups=16, ts_word=16, ts=6),
        ProjectRequest(g),  # a duplicate
    ]


def check_multi(got, want, words):
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            if g[0].dtype == torch.int32:
                assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
            else:  # group-by: int32 sums exact, counts exact
                assert torch.equal(g[1], w[1]) and torch.equal(g[0], w[0])
        elif g.dtype == torch.int32:
            assert torch.equal(g, w)
        else:
            assert g[1].item() == w[1].item()
            assert_sum_close(g[0], w[0], words[:, 13].view(torch.float32).abs().sum())


def test_scan_multi_matches_plain(dev):
    words = torch.from_numpy(make_words(3001)).to(dev)
    reqs = mixed_requests()
    before = _cuda.LAUNCHES["scan_multi"]
    got = K.scan_multi(words, reqs)
    assert _cuda.LAUNCHES["scan_multi"] == before + 1
    check_multi(got, K.scan_multi_torch(words, reqs), words)


def test_scan_multi_unaligned_slice_and_split(dev):
    # a chunk sliced at an odd row is not 16-byte aligned; 20 requests take
    # two launches
    words = torch.from_numpy(make_words(2001)).to(dev)[1:]
    reqs = mixed_requests() * 4
    before = _cuda.LAUNCHES["scan_multi"]
    got = K.scan_multi(words, reqs)
    assert _cuda.LAUNCHES["scan_multi"] == before + 2
    check_multi(got, K.scan_multi_torch(words, reqs), words)


def test_scan_multi_group_histograms_in_global_memory(dev):
    # 20000 groups do not fit the shared-memory budget; 16 groups do
    words = torch.from_numpy(make_words(6000)).to(dev)
    reqs = [GroupByRequest(group_word=3, agg_word=1, num_groups=20000, ts_word=16, ts=6),
            GroupByRequest(group_word=4, agg_word=2, num_groups=16),
            AggregateRequest(agg_word=5, pred_word=6, pred_op="gt", pred_k=0)]
    check_multi(K.scan_multi(words, reqs), K.scan_multi_torch(words, reqs), words)


def sixteen_requests():
    """Sixteen requests, four of each kind, on one launch."""
    reqs = []
    for i in range(4):
        reqs += [
            ProjectRequest(geom([i, 4 + i, 8, 12 + i][: 1 + i])),
            FilterRequest(geom([2 + i, 7, 13][: 3 - i % 2]), pred_word=5 + i,
                          pred_op=("gt", "lt")[i % 2], pred_k=-100 * i,
                          ts_word=16 if i % 2 else -1, ts=6),
            AggregateRequest(agg_word=(0, 13)[i % 2], agg_dtype=("int32", "float32")[i % 2],
                             pred_word=6, pred_op="lt", pred_k=100 * i, ts_word=16, ts=5),
            GroupByRequest(group_word=3, agg_word=(1, 2, 4, 5)[i], num_groups=(1, 16, 7, 1000)[i],
                           ts_word=16 if i else -1, ts=6),
        ]
    return reqs


@pytest.mark.parametrize("n", [1357, 256 * 700 + 3])
@pytest.mark.parametrize("start", [0, 1, 2])
def test_scan_multi_ring_sixteen_requests(dev, n, start):
    """Sixteen requests of all four kinds in one launch of the ring, with a
    last tile shorter than the ring's 256-row tile, on a few tiles a block
    and on more tiles than the grid has blocks, from a 16-byte aligned
    chunk, an odd row (4-byte copies) and an even one."""
    words = torch.from_numpy(make_words(n + start, seed=8)).to(dev)[start:]
    reqs = sixteen_requests()
    before = _cuda.LAUNCHES["scan_multi"]
    got = K.scan_multi(words, reqs)
    assert _cuda.LAUNCHES["scan_multi"] == before + 1
    want = K.scan_multi_torch(words, reqs)
    for r, g, w in zip(reqs, got, want):
        if isinstance(r, (ProjectRequest, FilterRequest)):
            for x, y in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
                assert torch.equal(x, y)
        elif isinstance(r, GroupByRequest):  # int32 sums: exact
            assert torch.equal(g[1], w[1]) and torch.equal(g[0], w[0])
        else:
            assert g[1].item() == w[1].item()
            vals = words[:, r.agg_word].view(torch.float32) if r.agg_dtype == "float32" \
                else words[:, r.agg_word].float()
            assert_sum_close(g[0], w[0], vals.abs().sum())


def test_empty_chunk_launches_nothing(dev):
    words = torch.empty((0, ROW_WORDS), dtype=torch.int32, device=dev)
    before = dict(_cuda.LAUNCHES)
    out = K.scan_multi(words, mixed_requests())
    agg = K.aggregate(words, agg_word=0)
    assert dict(_cuda.LAUNCHES) == before
    assert out[0].shape == (0, 4) and out[1][1].shape == (0,)
    assert agg.tolist() == [0.0, 0.0]
    assert out[3][0].shape == (16,) and out[3][1].sum().item() == 0


def test_engine_on_card_matches_cpu(dev):
    schema = TableSchema.of(*[Column(f"A{i + 1}", "int32") for i in range(12)],
                            *[Column(f"F{i + 1}", "float32") for i in range(4)])
    rng = np.random.default_rng(1)
    n = 5000
    cols = {c.name: (rng.integers(-1000, 1000, n).astype(np.int32)
                     if c.dtype == "int32" else rng.normal(0, 9, n).astype(np.float32))
            for c in schema.columns}
    results, stats = [], []
    for device in ("cuda", "cpu"):
        t = RelationalTable.from_columns(schema, cols)
        eng = RelationalMemoryEngine(device=device)
        out = []
        for step in range(2):
            ts = t.now() if step else None
            b = BatchExecutor(eng)
            b.add_columns(t, ["A1", "A5", "A9", "F1"])
            b.add_columns(t, ["A1", "A5"])
            b.add_filter(t, ["A2", "A3"], "A4", "gt", 0, snapshot_ts=ts)
            b.add_aggregate(t, "A1", "A2", "lt", 100, snapshot_ts=ts)
            b.add_groupby(t, "A12", "A3", 16, snapshot_ts=ts)
            out += b.submit()
            out.append(eng.aggregate_async(t, "A7", snapshot_ts=ts))
            t.append({k: v[:300] for k, v in cols.items()})
            t.delete(np.arange(0, 400, 7))
        results.append(out)
        stats.append(eng.stats)
    for a, b in zip(*results):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x.cpu(), y), (x, y)
    assert stats[0] == stats[1]


# ------------------------------------------------------------ hash join
def join_build(n, seed, dup_rounds=0, skew=0):
    """Build keys/vals/timestamps: unique keys, ``dup_rounds`` extra copies
    of the first quarter (MVCC version pairs), ``skew`` copies of one key
    (a bucket of capacity > skew)."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(np.arange(-n, n, dtype=np.int32))[:n]
    keys[:3] = [I32.min, -1, I32.max]
    extra = [keys[: n // 4]] * dup_rounds + [np.full(skew, keys[n // 2], np.int32)]
    keys = np.concatenate([keys, *extra])
    m = keys.size
    vals = rng.integers(I32.min, I32.max, m, dtype=np.int64).astype(np.int32)
    begin = rng.integers(0, 6, m).astype(np.int32)
    end = np.where(rng.random(m) < 0.3, rng.integers(2, 9, m), I32.max).astype(np.int32)
    return keys, vals, begin, end


def join_probe(n, row_words, key_word, keys, seed):
    rng = np.random.default_rng(seed)
    w = make_words(n, seed) if row_words == ROW_WORDS else \
        rng.integers(-1000, 1000, (n, row_words)).astype(np.int32)
    hit = rng.random(n) < 0.5
    w[:, key_word] = np.where(hit, rng.choice(keys, n),
                              rng.integers(I32.min, I32.max, n, dtype=np.int64))
    return w


JOIN_FORMS = [
    # (row_words, key_word, val_word, ts_word, build_ts)
    (ROW_WORDS, 1, 0, 16, True),
    (ROW_WORDS, 1, 0, -1, False),
    (ROW_WORDS, 5, 9, 16, False),
    (2, 1, 0, -1, False),
    (2, 1, 0, -1, True),
    (3, 2, 0, -1, True),
]


@pytest.mark.parametrize("form", JOIN_FORMS)
@pytest.mark.parametrize("build", [(500, 0, 0), (5, 0, 0), (3000, 2, 0), (800, 0, 700)])
def test_hash_join_matches_plain(dev, form, build):
    """Row-store chunks and packed blocks, with and without the MVCC tests,
    on a tiny build (P = 2), duplicate keys (payload sums wrap) and a skewed
    build whose capacity C passes 700."""
    row_words, key_word, val_word, ts_word, build_ts = form
    side = join_build(*build[:1], seed=build[0], dup_rounds=build[1], skew=build[2])
    parts = K.build_partitions(*side, device=dev)
    if build[2]:
        assert parts.capacity > build[2]
    words = torch.from_numpy(join_probe(4099, row_words, key_word, side[0], 3)).to(dev)
    args = (key_word, val_word, ts_word, 4, build_ts)
    before = _cuda.LAUNCHES["hash_join"]
    got = K.hash_join(words, parts, *args)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["hash_join"] == before + 1
    want = K.hash_join_torch(words, parts, *args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("tasks_a_warp", [2, 3])
def test_hash_join_streaming_form_several_tasks_a_warp(dev, tasks_a_warp):
    """The row store's streaming form on a persistent grid: every warp takes
    two or three 32-row tasks (the row words fetched two tasks ahead, the
    last task part-filled), bit-equal to the plain version."""
    blocks = ctypes.c_int(0)
    assert _cuda.load().rm_join_stream_blocks(ctypes.byref(blocks)) == 0 and blocks.value > 0
    n = (tasks_a_warp - 1) * blocks.value * (_cuda.JOIN_THREADS // 32) * 32 + 1000
    side = join_build(3000, seed=5)
    parts = K.build_partitions(*side, device=dev)
    words = torch.from_numpy(join_probe(n, ROW_WORDS, 1, side[0], 6)).to(dev)
    assert _cuda.join_launch(n, ROW_WORDS, parts.num_buckets, parts.capacity,
                             1, 0, 16, 5, True)[0].stream
    got = K.hash_join(words, parts, 1, 0, 16, 5, True)
    want = K.hash_join_torch(words, parts, 1, 0, 16, 5, True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_hash_join_unaligned_slice_and_empty(dev):
    side = join_build(700, seed=1)
    parts = K.build_partitions(*side, device=dev)
    words = torch.from_numpy(join_probe(3001, ROW_WORDS, 1, side[0], 4)).to(dev)
    for start in (1, 7):  # row slices start 8-byte, not 16-byte, aligned
        got = K.hash_join(words[start:], parts, 1, 0, 16, 5, True)
        want = K.hash_join_torch(words[start:], parts, 1, 0, 16, 5, True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    before = dict(_cuda.LAUNCHES)
    out = K.hash_join(words[:0], parts, 1, 0, 16, 5, True)
    assert dict(_cuda.LAUNCHES) == before
    assert [t.shape for t in out] == [(0,), (0,), (0,)]
    with pytest.raises(ValueError, match="partitions on"):
        K.hash_join(words, K.build_partitions(*side, device="cpu"), 1, 0)


def padded(parts, cap):
    """The same buckets with ``cap`` slots: each extra slot holds its bucket's
    fill key (which never matches) and invisible timestamps."""
    extra = cap - parts.capacity
    fills = torch.from_numpy(bucket_fills(parts.num_buckets)).to(parts.keys.device)
    cols = [fills[:, None].expand(-1, extra), torch.zeros_like(fills)[:, None].expand(-1, extra),
            torch.ones_like(fills)[:, None].expand(-1, extra),
            torch.zeros_like(fills)[:, None].expand(-1, extra)]
    return type(parts)(*(torch.cat([t, c], dim=1).contiguous() for t, c in zip(parts, cols)))


def warp_probe_build(case, dev):
    """C = 1 on P = 2; an odd C; C > 32 from 40 copies of one key whose
    payloads sum past 2^31 (the int32 sum wraps)."""
    rng = np.random.default_rng(11)
    if case == "c1":
        keys = np.array([7], np.int32)
    else:
        keys = rng.permutation(np.arange(-400, 400, dtype=np.int32))[:300]
    vals = rng.integers(I32.min, I32.max, keys.size, dtype=np.int64).astype(np.int32)
    if case == "wide_wrap":
        keys = np.concatenate([keys, np.full(40, keys[5], np.int32)])
        vals = np.concatenate([vals, np.full(40, 1 << 30, np.int32)])
    begin = np.zeros(keys.size, np.int32)
    end = np.where(rng.random(keys.size) < 0.2, 3, I32.max).astype(np.int32)
    parts = K.build_partitions(keys, vals, begin, end, device=dev)
    if case == "odd":
        parts = padded(parts, parts.capacity + 1 - parts.capacity % 2 + 2)
    return keys, parts


@pytest.mark.parametrize("case", ["c1", "odd", "wide_wrap"])
@pytest.mark.parametrize("form", [(ROW_WORDS, 1, 0, 16, True), (ROW_WORDS, 1, 0, -1, False),
                                  (2, 1, 0, -1, True), (40, 33, 2, 38, True),
                                  (5, 1, 0, 3, True)])
def test_hash_join_warp_probe_edges(dev, case, form):
    """The warp-wide probe at the edges of its layout: C = 1 on P = 2, an odd
    C, C > 32 (two slot passes, two fingerprint lines) with a wrapping
    payload sum; 1,037 rows (not a multiple of 32), whole and from odd rows;
    the row store with and without the MVCC tests, a packed block, 40-word
    rows whose key and payload are not adjacent, and 5-word rows, where every
    other row's word pairs are not 8-byte aligned."""
    keys, parts = warp_probe_build(case, dev)
    cap = parts.capacity
    assert {"c1": cap == 1 and parts.num_buckets == 2, "odd": cap % 2 == 1,
            "wide_wrap": cap > 32}[case]
    row_words, key_word, val_word, ts_word, build_ts = form
    w = join_probe(1037, row_words, key_word, keys, 5)
    if ts_word >= 0 and row_words != ROW_WORDS:
        w[:, ts_word] = 0
        w[:, ts_word + 1] = np.where(np.arange(1037) % 3 == 0, 2, I32.max)
    words = torch.from_numpy(w).to(dev)
    args = (key_word, val_word, ts_word, 1, build_ts)
    for start in (0, 1, 3):
        got = K.hash_join(words[start:], parts, *args)
        want = K.hash_join_torch(words[start:], parts, *args)
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), (case, form, start)
        if case == "wide_wrap":  # 40 payloads of 2^30 wrap to 0 in int32
            hot = (words[start:, key_word] == int(keys[5])) & want[2]
            assert hot.any() and bool((want[1][hot] == want[1][hot][0]).all())


def test_partition_builders_default_to_the_card(dev):
    side = join_build(300, seed=4)
    for parts in (K.build_partitions(*side),
                  K.partitions_from_numpy(*(t.cpu().numpy() for t in
                                            K.build_partitions(*side, device="cpu")))):
        want = torch.device("cuda", torch.cuda.current_device())
        assert all(t.device == want for t in parts)


def test_begin_tick_returns_while_its_pass_runs(dev):
    """``begin_tick`` enqueues the tick's fused pass and leaves the express
    sum to ``finish_tick``: on a table whose pass takes over a millisecond
    (2^25 rows, a sum beside a projection of 11 columns) it returns while
    the stream is still busy, and the sum ``finish_tick`` settles equals the
    plain reference exactly (int64 on the card; values in [-100, 100],
    drawn around 0, keep every float32 partial below 2^24 and so exact)."""
    from repro_torch.core import benchmark_schema, plan
    from repro_torch.core.table import TS_INF
    from repro_torch.serve import QueryServer

    n = 1 << 25
    schema = benchmark_schema(64, 4)
    gen = torch.Generator(device=dev).manual_seed(5)
    words = torch.empty((n, schema.row_words + 2), dtype=torch.int32, device=dev)
    words[:, :schema.row_words] = torch.randint(-100, 101, (n, schema.row_words),
                                                generator=gen, device=dev, dtype=torch.int32)
    words[:, schema.row_words] = 1
    words[:, schema.row_words + 1] = TS_INF
    want = int(words[:, 0].long().sum())
    assert abs(want) < 1 << 24
    t = RelationalTable.from_state({
        "columns": [(c.name, c.dtype, c.width, c.codec) for c in schema.columns],
        "words": words.cpu().numpy(), "clock": 1})
    server = QueryServer(RelationalMemoryEngine(device=dev), snapshot_reads=True)
    names = [c.name for c in schema.columns][:11]  # a view's most columns
    for _ in range(2):  # the first tick uploads the table and builds the kernels
        total = server.submit(plan(t).sum(names[0]))
        packed = server.submit(plan(t).project(*names))
        torch.cuda.synchronize(dev)
        tick = server.begin_tick()
        busy = not torch.cuda.current_stream(dev).query()
        pending = not total.done()
        server.finish_tick(tick)
    assert busy and pending and tick.deferred == 1
    assert total.result(timeout=0) == float(want)
    rows, mask = packed.result(timeout=0)
    assert bool(mask.all()) and torch.equal(rows, words[:, :11])
    assert server.stats.express_deferred == 2


def test_query_server_tick_launches_the_probe(dev):
    """A solo join probes the row-store chunks, a join in a written table's
    tick probes the shared pass's packed block; both launch the kernel and
    equal the CPU server's results."""
    from repro_torch.core import plan
    from repro_torch.core import planner
    from repro_torch.serve import QueryServer

    schema = TableSchema.of(*[Column(f"A{i + 1}", "int32") for i in range(16)])
    rng = np.random.default_rng(2)
    s_cols = {c.name: rng.integers(-100, 100, 3000).astype(np.int32) for c in schema.columns}
    s_cols["A2"] = rng.integers(0, 1200, 3000).astype(np.int32)
    r_cols = {c.name: rng.integers(-100, 100, 600).astype(np.int32) for c in schema.columns}
    r_cols["A2"] = np.arange(600, dtype=np.int32)
    outs, launches, builds = [], [], []
    for device in ("cuda", "cpu"):
        planner.clear_join_build_cache()
        s = RelationalTable.from_columns(schema, s_cols)
        r = RelationalTable.from_columns(schema, r_cols)
        server = QueryServer(RelationalMemoryEngine(device=device))
        q = plan(s).join(r, key="A2", left_proj="A1", right_proj="A3")
        got = []
        for tick in range(2):
            _cuda.reset_launches()
            if tick:
                server.submit_delete(s, np.arange(0, 3000, 11))
            # tick 0: the join alone on S; tick 1: beside a read of S
            tks = [server.submit(q), server.submit(plan(s if tick else r).sum("A4"))]
            server.drain()
            got += [tk.result(timeout=60) for tk in tks]
            launches.append(_cuda.LAUNCHES["hash_join"])
        outs.append(got)
        builds.append(server.engine.stats.join_builds)
    assert launches[:2] == [1, 1] and launches[2:] == [0, 0]
    # R is never written: tick 1 reuses tick 0's partitions on both devices
    assert builds == [1, 1]
    for a, b in zip(*outs):
        if isinstance(b, float):
            assert a == b
            continue
        for f in ("s_proj", "r_proj", "matched"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f))


# ------------------------------------------------ revisions, multi-view, select
REVISION_GEOMS = [
    ([0, 4, 8, 12], None),  # the path's A1, A5, A9, A13
    ([1], None),
    ([0, 3, 9], [2, 4, 1]),  # char-like multi-word columns
    (list(range(11)), None),  # the configuration port's 11 columns
]


@pytest.mark.parametrize("revision", ["bsl", "pck"])
@pytest.mark.parametrize("cols", REVISION_GEOMS)
def test_project_revisions_match_plain(dev, revision, cols):
    kernel = f"project_{revision}"
    for n, start in ((1, 0), (3, 0), (1000, 0), (4099, 0), (2001, 1)):
        # start 1: a chunk sliced at an odd row (not 16-byte aligned)
        words = torch.from_numpy(make_words(n + start)).to(dev)[start:]
        g = geom(*cols)
        before = _cuda.LAUNCHES[kernel]
        got = K.project(words, g, revision)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[kernel] == before + 1
        assert torch.equal(got, K.project_torch(words, g)), (revision, cols, n)


@pytest.mark.parametrize("revision", ["bsl", "pck"])
def test_project_revisions_wide_rows(dev, revision):
    # 700-word rows with a 600-word column: PCK's packer tile shrinks to 8
    # rows so it fits shared memory
    rng = np.random.default_rng(5)
    words = torch.from_numpy(rng.integers(-9, 9, (777, 700)).astype(np.int32)).to(dev)
    g = geom([3, 650], [600, 20], row_words=700)
    assert torch.equal(K.project(words, g, revision), K.project_torch(words, g))
    empty = words[:0]
    before = dict(_cuda.LAUNCHES)
    assert K.project(empty, g, revision).shape == (0, 620)
    assert dict(_cuda.LAUNCHES) == before


def test_project_multi_matches_plain_and_splits(dev):
    words = torch.from_numpy(make_words(3001)).to(dev)
    geoms = [geom([0]), geom([1, 2]), geom([0, 4, 8, 12]), geom([5, 9], [3, 2])]
    before = _cuda.LAUNCHES["project_multi"]
    got = K.project_multi(words, geoms)
    assert _cuda.LAUNCHES["project_multi"] == before + 1
    for a, b in zip(got, K.project_multi_torch(words, geoms)):
        assert torch.equal(a, b)
    # 24 views of 30 words: more than MAX_REQ views, so the views split over
    # launches as _cuda.split() groups them
    wide = torch.from_numpy(np.random.default_rng(6).integers(
        -9, 9, (1501, 64)).astype(np.int32)).to(dev)[1:]
    many = [geom([v % 20, 30], [10, 20], row_words=64) for v in range(24)]
    groups = _cuda.split([_cuda.KernelReq(_cuda.PROJECT, tuple(range(30)))] * 24)
    assert len(groups) > 1
    before = _cuda.LAUNCHES["project_multi"]
    got = K.project_multi(wide, many)
    assert _cuda.LAUNCHES["project_multi"] == before + len(groups)
    for a, b in zip(got, K.project_multi_torch(wide, many)):
        assert torch.equal(a, b)


def assert_select_equal(got, want):
    torch.cuda.synchronize()
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    assert got[0].shape == want[0].shape and torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("block_rows", [64, 256, 512, 1000])
@pytest.mark.parametrize("pred", [(2, "int32", "gt", 5), (2, "int32", "lt", -2.7),
                                  (13, "float32", "gt", -3.5), (0, "int32", "none", 0)])
@pytest.mark.parametrize("mvcc", [False, True])
def test_select_compact_matches_plain(dev, block_rows, pred, mvcc):
    word, dtype, op, k = pred
    w = make_words(2999 + 2)
    w[::7, 13] = np.array(np.nan, np.float32).view(np.int32)  # NaN fails gt and lt
    words = torch.from_numpy(w).to(dev)[2:]  # 8-byte, not 16-byte, aligned
    kw = dict(pred_word=word, pred_dtype=dtype, pred_op=op, pred_k=k,
              ts=6 if mvcc else 0, ts_word=16 if mvcc else -1, block_rows=block_rows)
    g = geom([0, 8])
    before = _cuda.LAUNCHES["select_compact"]
    got = K.select_compact(words, g, **kw)
    assert _cuda.LAUNCHES["select_compact"] == before + 1
    want = K.select_compact_torch(words, g, **kw)
    assert_select_equal(got, want)
    assert got[0].shape == (-(-2999 // block_rows), block_rows, 2)
    total = int(want[1].sum())
    assert torch.equal(K.densify(*got, total=total), K.densify(*want, total=total))


def test_select_compact_all_none_and_empty(dev):
    words = torch.from_numpy(make_words(1500)).to(dev)
    g = geom([1, 2, 3])
    for k in (-10**6, 10**6):  # every row kept, then none
        kw = dict(pred_word=0, pred_op="gt", pred_k=k, block_rows=256)
        got = K.select_compact(words, g, **kw)
        assert_select_equal(got, K.select_compact_torch(words, g, **kw))
    before = dict(_cuda.LAUNCHES)
    blocks, counts = K.select_compact(words[:0], g, pred_word=0, block_rows=64)
    assert dict(_cuda.LAUNCHES) == before
    assert blocks.shape == (0, 64, 3) and counts.shape == (0,)


def test_new_kernels_past_2_31_bytes(dev):
    # 30,000,001 rows of 18 words: the last rows lie past 2^31 bytes
    n = 30_000_001
    words = torch.randint(-1000, 1000, (n, ROW_WORDS), dtype=torch.int32, device=dev)
    assert words.numel() * 4 > 2**31
    g = geom([0, 4, 8, 12])
    tail = slice(n - 5000, n)
    for revision in ("bsl", "pck"):
        got = K.project(words, g, revision)
        assert torch.equal(got[tail], K.project_torch(words[tail], g))
        del got
    views = K.project_multi(words, [g, geom([1])])
    assert torch.equal(views[0][tail], K.project_torch(words[tail], g))
    del views
    blocks, counts = K.select_compact(words, g, pred_word=2, pred_op="gt", pred_k=0,
                                      block_rows=512)
    lo = (n - 5000) // 512 * 512
    want = K.select_compact_torch(words[lo:], g, pred_word=2, pred_op="gt", pred_k=0,
                                  block_rows=512)
    assert torch.equal(blocks[lo // 512:], want[0]) and torch.equal(counts[lo // 512:], want[1])
    del blocks, counts, want
    # the probe and the fused scan: tails of the blocked outputs, and an
    # aggregate over rows from the whole store
    side = join_build(3000, seed=2)
    parts = K.build_partitions(*side, device=dev)
    got = K.hash_join(words, parts, 1, 0, 16, 5, True)
    want = K.hash_join_torch(words[tail], parts, 1, 0, 16, 5, True)
    assert all(torch.equal(x[tail], y) for x, y in zip(got, want))
    del got
    reqs = [ProjectRequest(g), FilterRequest(geom([1, 2]), pred_word=5, pred_op="gt", pred_k=0),
            AggregateRequest(agg_word=0, pred_word=3, pred_op="gt", pred_k=990)]
    got = K.scan_multi(words, reqs)
    assert torch.equal(got[0][tail], K.project_torch(words[tail], g))
    want = K.filter_project_torch(words[tail], geom([1, 2]), pred_word=5, pred_op="gt", pred_k=0)
    assert torch.equal(got[1][0][tail], want[0]) and torch.equal(got[1][1][tail], want[1])
    want = K.aggregate_torch(words, agg_word=0, pred_word=3, pred_op="gt", pred_k=990)
    assert got[2][1].item() == want[1].item()
    assert_sum_close(got[2][0], want[0], words[:, 0].abs().float().sum())


@pytest.mark.parametrize("revision", ["bsl", "pck", "mlp"])
def test_engine_revision_launches_its_kernel(dev, revision):
    schema = TableSchema.of(*[Column(f"A{i + 1}", "int32") for i in range(16)])
    rng = np.random.default_rng(4)
    cols = {c.name: rng.integers(-1000, 1000, 3000).astype(np.int32) for c in schema.columns}
    kernel = "project" if revision == "mlp" else f"project_{revision}"
    outs = []
    for device in ("cuda", "cpu"):
        t = RelationalTable.from_columns(schema, cols)
        eng = RelationalMemoryEngine(revision=revision, device=device, cache_bytes=0)
        _cuda.reset_launches()
        b = BatchExecutor(eng)
        b.add_columns(t, ["A1", "A5", "A9", "A13"])
        got = [b.submit()[0]]
        got += list(eng.stream_project(eng.register(t, ["A2", "A3"]), chunk_rows=1000))
        if device == "cuda":
            assert _cuda.LAUNCHES[kernel] == 4, dict(_cuda.LAUNCHES)
        outs.append(got)
        assert eng.breaker.snapshot()["breaker_fallbacks"] == 0
    for a, b in zip(*outs):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("path", ["fused", "solo", "join"])
def test_card_lowering_fault_propagates(dev, monkeypatch, path):
    """On the card the breaker has no fallback: an injected ``lowering``
    fault propagates, no plain version runs, the breaker records nothing,
    and the next dispatch launches the kernel again."""
    from repro_torch.core import AggregateOp, GroupByOp, JoinOp, faults
    from repro_torch.kernels import rme_scan_multi as KR

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(KR, "scan_multi_torch", no_plain)
    monkeypatch.setattr(K, "hash_join_torch", no_plain)
    schema = TableSchema.of(*[Column(f"A{i + 1}", "int32") for i in range(4)])
    rng = np.random.default_rng(5)
    t = RelationalTable.from_columns(
        schema, {c.name: rng.integers(0, 8, 2000).astype(np.int32) for c in schema.columns})
    r = RelationalTable.from_columns(
        schema, {c.name: np.arange(8, dtype=np.int32) for c in schema.columns})
    eng = RelationalMemoryEngine(device=dev, breaker_threshold=1, breaker_cooldown=1)
    if path == "fused":
        ops, kernel = [AggregateOp(t, "A1"), GroupByOp(t, "A2", "A1", num_groups=8)], "scan_multi"
    elif path == "solo":
        ops, kernel = [AggregateOp(t, "A1")], "aggregate"
    else:
        ops, kernel = [JoinOp(eng.register(t, ["A1", "A2"]), "A2", "A1", r, "A3")], "hash_join"
    want = eng.execute_many(ops)
    for _ in range(2):
        plan = faults.FaultPlan().inject("lowering", kind="transient")
        with faults.fault_plan(plan):
            with pytest.raises(faults.TransientFault):
                eng.execute_many(ops)
        assert plan.fired("lowering") == 1
    _cuda.reset_launches()
    got = eng.execute_many(ops)
    assert _cuda.LAUNCHES[kernel] >= 1, dict(_cuda.LAUNCHES)
    assert eng.breaker.snapshot() == {"breaker_trips": 0, "breaker_fallbacks": 0,
                                      "breaker_probes": 0, "breaker_open": 0}
    for a, b in zip(want, got):
        if hasattr(a, "s_proj"):
            a, b = (a.s_proj, a.r_proj, a.matched), (b.s_proj, b.r_proj, b.matched)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


# ------------------------------------------------------- flash attention
FLASH_CASES = [
    # (B, S, H, KH, D, causal, window): tests/test_flash_attention.py's seven
    # cases, then D 256 and a lone short sequence, then the bf16 kernel's
    # tiling (128 query rows a block, 128-key tiles, 64 at D 256)
    (2, 128, 4, 4, 32, True, None),
    (2, 128, 8, 2, 32, True, None),  # GQA group 4
    (1, 256, 4, 1, 64, True, None),  # MQA
    (2, 96, 4, 2, 32, True, None),  # ragged tail (96 % 64 != 0)
    (2, 128, 4, 4, 32, True, 48),  # sliding window
    (2, 128, 4, 4, 32, False, None),  # bidirectional
    (1, 64, 2, 2, 128, True, None),
    (1, 200, 4, 2, 256, True, None),  # the widest head the kernel takes
    (2, 7, 2, 1, 16, False, 3),  # shorter than one tile, windowed both ways
    (2, 130, 4, 2, 64, True, None),  # two query tiles, the second of 2 rows
    (1, 200, 8, 2, 128, True, None),  # S not a multiple of 128
    (1, 100, 4, 2, 32, True, 40),  # below one tile, windowed, causal
    (1, 100, 4, 2, 32, False, 40),  # and bidirectional
    (1, 256, 8, 1, 64, True, None),  # G = 8 (KH 1)
    (1, 384, 4, 2, 128, True, 200),  # a window that splits a 128-key tile
    (1, 384, 4, 2, 128, False, 200),
    (2, 300, 4, 2, 16, True, None),  # D 16 (32-byte swizzle) over three tiles
    (1, 260, 2, 1, 256, False, 100),  # D 256 (64-key tiles), bidirectional window
    (1, 256, 64, 4, 128, True, None),  # G = 16: qwen3-moe-235b's 64 / 4 heads
    (2, 200, 64, 4, 128, True, None),  # and over a ragged second tile
    (2, 1024, 16, 1, 256, True, None),  # recurrentgemma-9b's local layers: MQA, D 256
    (2, 1024, 16, 1, 256, True, 512),  # and a window inside the sequence
    (1, 1975, 64, 8, 128, True, None),  # qwen2-vl-72b's prefill: 64 / 8 heads
    (2, 264, 16, 16, 64, False, None),  # seamless-m4t-medium's encoder: 264 frames
    (1, 1975, 16, 16, 64, True, None),  # and its decoder's prefill
]
# (rtol, atol): float32, the kernel and the plain version sum the same terms
# in another order; bfloat16, one rounding step of the output (2^-7 of its
# value) plus the rounding of p to bf16, which the two take at other running
# maxima (their key tiles differ), on outputs near 0 — chip_smoke.py's limit
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 2e-3)}


def flash_inputs(case, dtype, dev, seed=0):
    b, s, h, kh, d = case[:5]
    g = torch.Generator(device="cpu").manual_seed(seed + sum(case[:5]))
    return [torch.randn((b, s, n, d), generator=g).to(dtype).to(dev) for n in (h, kh, kh)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain(dev, case, dtype):
    from repro_torch.kernels import flash_attention as F

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = flash_inputs(case, dtype, dev)
    causal, window = case[5], case[6]
    _cuda.reset_launches()
    got = F.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    want = F.flash_attention_torch(q, k, v, causal=causal, window=window)
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_flash_kernel_reads_strided_layouts(dev):
    """q, k and v as views of one fused projection (non-contiguous heads and
    rows), as a caller might hand them: the kernel reads through strides."""
    from repro_torch.kernels import flash_attention as F

    b, s, h, kh, d = 2, 130, 8, 2, 64
    qkv = torch.randn((b, s, h + 2 * kh, d), device=dev, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    assert not q.is_contiguous()
    got = F.flash_attention(q, k, v)
    want = F.flash_attention_torch(q.contiguous(), k.contiguous(), v.contiguous())
    rtol, atol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_flash_launch_count_and_refusals(dev):
    from repro_torch.kernels import flash_attention as F

    q, k, v = flash_inputs(FLASH_CASES[1], torch.bfloat16, dev)
    _cuda.reset_launches()
    for _ in range(3):
        F.flash_attention(q, k, v)
    assert _cuda.LAUNCHES["flash_attention"] == 3
    with pytest.raises(ValueError):  # float16 is not instantiated
        F.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # q on the card, k on the host
        F.flash_attention(q, k.cpu(), v)
    assert _cuda.LAUNCHES["flash_attention"] == 3
    # a tensor that requires grad goes to the kernel too (never the plain
    # forward), and its backward launches the backward kernel, not the
    # forward (the sum's broadcast gradient copied for it)
    qg = q.float().requires_grad_()
    out = F.flash_attention(qg, k.float(), v.float())
    assert _cuda.LAUNCHES["flash_attention"] == 4
    out.sum().backward()
    assert _cuda.LAUNCHES["flash_attention"] == 4 and torch.isfinite(qg.grad).all()
    assert _cuda.LAUNCHES["flash_attention_backward"] == 1
    assert _cuda.FLASH_DOUT_COPIES["copies"] == 1


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-27b", "qwen1.5-110b", "internlm2-20b",
                                  "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                                  "mamba2-1.3b", "recurrentgemma-9b"])
def test_smoke_prefill_on_the_card_matches_the_cpu(dev, arch):
    """A smoke decoder's prefill on the card launches the flash kernel once
    per attention layer and the scan kernel once per RG-LRU layer; at
    float32 its logits and every key of its caches (KV caches, recurrent
    states) match the CPU model's within 1e-4 (the kernel scales q in
    float32 where the CPU path scales it in the compute type: the same
    number at float32 compute), then one decode."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import DecoderLM

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    cpu = DecoderLM(cfg, device="cpu", seed=3)
    card = DecoderLM(cfg, device=dev, seed=None)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (2, 40)))
    kinds = [layer.kind for layer in card.layers]
    attention = sum(kind not in ("ssd", "rglru") for kind in kinds)
    _cuda.reset_launches()
    got, got_cache = card.prefill({"tokens": toks}, 48)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == attention
    assert _cuda.LAUNCHES["rglru_scan"] == kinds.count("rglru")
    want, want_cache = cpu.prefill({"tokens": toks}, 48)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for a, b in zip(got_cache, want_cache):
        assert a.keys() == b.keys()
        for name in a:
            torch.testing.assert_close(a[name].cpu(), b[name], rtol=1e-4, atol=1e-4)
    nxt = want.argmax(-1)[:, None]
    got, _ = card.decode_step(got_cache, nxt, 40)
    want, _ = cpu.decode_step(want_cache, nxt, 40)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert _cuda.LAUNCHES["flash_attention"] == attention  # decode: no kernel
    assert _cuda.LAUNCHES["rglru_scan"] == kinds.count("rglru")


# ------------------------------------------- int8 serving: the W8 kernel
# (M, K, N): the decode rows, then K and N that are not multiples of a
# block's columns (128 on the tensor cores, 256 on the CUDA cores), its K
# chunk or the tensor cores' 16-row k step — in bf16 N 528 and 48 take the
# tensor cores, N 1000 and 72 the CUDA cores (N % 16 != 0), as float32
# always does — and one of the serving path's shapes
W8_CASES = [(m, k, n) for m in (1, 8, 64)
            for k, n in ((300, 1000), (129, 72), (1100, 528), (33, 48))] + [(8, 4096, 1024)]


def w8_inputs(m, k, n, dtype, dev, seed=0):
    from repro_torch.models.layers import quantize_weight

    rng = np.random.default_rng(seed + m + k + n)
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    w[:, n // 2] = 0.0  # an all-zero column: its scale is the 1e-12 floor
    rec = quantize_weight(torch.from_numpy(w))
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dtype)
    return x.to(dev), rec.q.to(dev), rec.s.to(dev)


def w8_check(got, x, q, s):
    """``got`` against the exact product of x and the dequantized weight (in
    float64): float32 within 1e-5 of sum(|x| |w|) (the summation order);
    bf16 within half a bf16 step of the value (its one rounding) plus the
    same (the float32 sum it rounds)."""
    from repro_torch.kernels.w8_matmul import dequantize

    w = dequantize(q, s, x.dtype).double()
    exact = x.double() @ w
    scale = x.double().abs() @ w.abs()
    limit = 1e-5 * scale + (2.0 ** -8 * exact.abs() if x.dtype == torch.bfloat16 else 0.0)
    err = (got.double() - exact).abs()
    assert bool((err <= limit + 1e-30).all()), float((err / (limit + 1e-30)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", W8_CASES, ids=lambda c: "-".join(map(str, c)))
def test_w8_kernel_matches_plain(dev, case, dtype):
    from repro_torch.kernels import w8_matmul as W8

    torch.backends.cuda.matmul.allow_tf32 = False
    x, q, s = w8_inputs(*case, dtype, dev)
    _cuda.reset_launches()
    got = W8.w8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["w8_matmul"] == 1
    assert got.dtype == dtype and got.shape == (case[0], case[2]) and got.is_contiguous()
    w8_check(got, x, q, s)
    again = W8.w8_matmul(x, q, s)
    assert torch.equal(got, again)  # split-K sums in a fixed order
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        want = W8.w8_matmul_torch(x, q, s)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0  # two roundings of the output
    limit = rtol * want.float().abs() + 2e-5 * (x.float().abs() @ W8.dequantize(
        q, s, torch.float32).abs())
    assert bool(((got.float() - want.float()).abs() <= limit + 1e-30).all())


def test_w8_launch_count_and_refusals(dev):
    from repro_torch.kernels import w8_matmul as W8

    x, q, s = w8_inputs(8, 300, 1000, torch.bfloat16, dev)
    _cuda.reset_launches()
    for _ in range(3):
        W8.w8_matmul(x, q, s)
    assert _cuda.LAUNCHES["w8_matmul"] == 3
    x65 = torch.zeros((65, 300), dtype=torch.bfloat16, device=dev)
    for args in [(x65, q, s),  # more rows than a decode step
                 (x.half(), q, s),  # float16 is not instantiated
                 (x, q.float(), s), (x, q, s.float()),
                 (x, q.cpu(), s),  # x on the card, q on the host
                 (x[:, ::2], q[::2], s),  # not contiguous
                 (x[:, :299], q, s),  # K does not chain
                 (x, q[:, :999].contiguous(), s[:, :999].contiguous())]:  # N % 8 != 0
        with pytest.raises(ValueError):
            W8.w8_matmul(*args)
    assert _cuda.LAUNCHES["w8_matmul"] == 3


# (M, K, (N, ...)): a group of records that share x — a qwen3-8b layer's
# wq, wk, wv and w_gate, w_up; N not a multiple of the 128-column strip, a
# K of 5 cluster ranks of one stage; one record that takes the CUDA cores
# (N % 16 != 0), so the group is a launch a record
W8_GROUPS = [(8, 4096, (4096, 1024, 1024)), (8, 4096, (12288, 12288)),
             (1, 300, (528, 48, 16)), (64, 300, (528, 48, 16)), (8, 129, (48, 16, 32, 64)),
             (8, 300, (528, 72))]


def w8_group_inputs(m, k, ns, dev, seed=0):
    x = w8_inputs(m, k, 8, torch.bfloat16, dev, seed)[0]
    return x, [w8_inputs(m, k, n, torch.bfloat16, dev, seed + i)[1:] for i, n in enumerate(ns)]


@pytest.mark.parametrize("case", W8_GROUPS, ids=lambda c: "-".join(map(str, c[:2] + c[2])))
def test_w8_group_equals_its_products_alone(dev, case):
    """A group's outputs bit-equal to each product launched alone through
    the same wrapper (the plan depends on K alone), equal on a rerun, and
    each within the kernel's limits of the exact product; one launch for a
    group that takes the tensor cores, one a record otherwise."""
    from repro_torch.kernels import w8_matmul as W8

    m, k, ns = case
    x, records = w8_group_inputs(m, k, ns, dev)
    _cuda.reset_launches()
    got = W8.w8_matmul_group(x, records)
    torch.cuda.synchronize()
    tensor = all(n % 16 == 0 for n in ns)
    assert _cuda.LAUNCHES["w8_matmul"] == (1 if tensor else len(ns))
    assert _cuda.W8_PRODUCTS["launched"] == len(ns)
    assert [tuple(y.shape) for y in got] == [(m, n) for n in ns]
    again = W8.w8_matmul_group(x, records)
    for y, y2, (q, s) in zip(got, again, records):
        assert torch.equal(y, y2)
        assert torch.equal(y, W8.w8_matmul(x, q, s))
        w8_check(y, x, q, s)


def test_w8_group_graph_replay_equals_eager(dev):
    """A group captured in a CUDA graph: the capture launches nothing and
    records one launch of three products; a replay writes what the eager
    launch returned, bit for bit."""
    from repro_torch.kernels import w8_matmul as W8

    x, records = w8_group_inputs(8, 4096, (4096, 1024, 1024), dev, seed=5)
    eager = W8.w8_matmul_group(x, records)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    _cuda.reset_launches()
    with torch.cuda.graph(graph, stream=side):
        out = W8.w8_matmul_group(x, records)
    assert _cuda.LAUNCHES["w8_matmul"] == 0 and _cuda.CAPTURED["w8_matmul"] == 1
    assert _cuda.W8_PRODUCTS == {"launched": 0, "captured": 3}
    for y in out:
        y.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, eager))


def test_library_first_loaded_inside_a_capture(dev, monkeypatch):
    """A process whose first use of the library is a flash launch inside a
    graph capture loads it there without the W8 set-up (an attribute is
    never set inside a capture); the graph replays the eager result, and a
    later W8 launch outside the capture does the set-up once."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import w8_matmul as W8

    q, k, v = flash_inputs(FLASH_CASES[1], torch.bfloat16, dev)
    eager = F.flash_attention(q, k, v)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    monkeypatch.setattr(_cuda, "_LIB", None)  # as a fresh process: not loaded
    monkeypatch.setattr(_cuda, "_W8_READY", set())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = F.flash_attention(q, k, v)
    assert _cuda._LIB is not None and _cuda._W8_READY == set()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x, records = w8_group_inputs(8, 512, (256, 128), dev, seed=7)
    got = W8.w8_matmul_group(x, records)
    assert _cuda._W8_READY == {index}
    for y, (qw, s) in zip(got, records):
        w8_check(y, x, qw, s)


def test_w8_group_refusals(dev):
    """Records that differ in K, device or dtype, an empty group and five
    records are refused before any launch."""
    from repro_torch.kernels import w8_matmul as W8

    x, records = w8_group_inputs(8, 300, (528, 48), dev)
    (q, s), (q2, s2) = records
    other_k = w8_inputs(8, 301, 48, torch.bfloat16, dev)[1:]
    _cuda.reset_launches()
    for group in [[(q, s), other_k],  # K differs
                  [(q, s), (q2.cpu(), s2)],  # a record on the host
                  [(q, s), (q2.float(), s2)],  # q not int8
                  [(q, s), (q2, s2.float())],  # s not bf16
                  [], [(q, s)] * 5]:
        with pytest.raises(ValueError):
            W8.w8_matmul_group(x, group)
    with pytest.raises(ValueError):
        W8.w8_matmul_group(x.float().cpu(), records)  # x on the host, the records on the card
    assert _cuda.LAUNCHES["w8_matmul"] == 0 and _cuda.W8_PRODUCTS["launched"] == 0


def smoke_model(arch, dtype, dev, int8, seed=3):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.layers import quantize_for_serving
    from repro_torch.models.lm import DecoderLM

    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
    cpu = DecoderLM(cfg, device="cpu", seed=seed)
    if int8:
        quantize_for_serving(cpu)
    card = DecoderLM(cfg, device=dev, seed=None)
    if int8:
        quantize_for_serving(card)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


def test_int8_smoke_on_the_card_matches_the_cpu(dev):
    """An int8 smoke decoder at float32 compute: the card's prefill (dequant
    and torch.matmul) and decode steps (the W8 kernel, one launch a weight)
    within 1e-4 of the CPU's plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, card = smoke_model("qwen3-8b", "float32", dev, int8=True)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (2, 40)))
    _cuda.reset_launches()
    got, got_cache = card.prefill({"tokens": toks}, 48)
    want, want_cache = cpu.prefill({"tokens": toks}, 48)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert _cuda.LAUNCHES["w8_matmul"] == 0  # 80 rows: the prefill's products
    for t in range(3):
        nxt = want.argmax(-1)[:, None]
        got, _ = card.decode_step(got_cache, nxt, torch.tensor(40 + t, device=dev))
        want, _ = cpu.decode_step(want_cache, nxt, 40 + t)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert _cuda.LAUNCHES["w8_matmul"] == 3 * 7 * cfg.n_layers


def serve_logged(model, prompts, eager: bool):
    """Serve ``prompts`` over 2 slots (three admissions of 5 requests); the
    token lists and every decode step's logits."""
    from repro_torch.serve import Request, ServeSession

    sess = ServeSession(model, batch_slots=2, max_len=64)
    if eager:
        sess.decode_fn = model.decode_step
    logged, step = [], sess.decode_fn

    def run(*args):
        logits, cache = step(*args)
        logged.append(logits.clone())
        return logits, cache

    sess.decode_fn = run
    reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    for r in reqs:
        sess.submit(r)
    sess.run_to_completion()
    return [r.out for r in reqs], logged, step


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_graph_replay_equals_eager_over_readmissions(dev, int8):
    """The session's graphed decode step against the eager step on the same
    model: equal tokens and bit-equal logits tick by tick, across three
    admissions (the second and third copy their prefill's cache into the
    captured one).  The W8 kernel's wrapper counts the warm-up step before
    the capture only, 4 launches a layer (q, k and v one group; gate and
    up one) for its 7 products: the capture launches nothing, the replays
    launch without the wrapper, and the prompts are long enough, 2 × 33
    rows and more, that no prefill's products take the kernel.  The capture
    records as many launches and products as the warm-up launched, and the
    graph replays once a tick."""
    from repro_torch.serve.engine import GraphedDecodeStep

    cfg, _, card = smoke_model("qwen3-8b", "bfloat16", dev, int8)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, 33 + 2 * i).astype(np.int32) for i in range(5)]
    eager_tokens, eager_logits, _ = serve_logged(card, prompts, eager=True)
    _cuda.reset_launches()
    tokens, logits, step = serve_logged(card, prompts, eager=False)
    assert isinstance(step, GraphedDecodeStep) and step.graph is not None
    assert tokens == eager_tokens
    assert len(logits) == len(eager_logits) > 6
    for a, b in zip(logits, eager_logits):
        assert torch.equal(a, b)
    assert _cuda.LAUNCHES["w8_matmul"] == (4 * cfg.n_layers if int8 else 0)
    assert _cuda.W8_PRODUCTS["launched"] == (7 * cfg.n_layers if int8 else 0)
    assert step.captured["w8_matmul"] == _cuda.LAUNCHES["w8_matmul"]
    assert step.captured_w8_products == _cuda.W8_PRODUCTS["launched"]
    assert step.captured["flash_attention"] == 0
    assert step.replays == len(logits)


def test_decode_step_raises_after_the_weights_change(dev):
    """A step captured before ``quantize_for_serving`` holds the freed bf16
    weights' addresses: its next call raises; a new step serves."""
    from repro_torch.models.layers import quantize_for_serving
    from repro_torch.serve.engine import make_decode_step

    cfg, _, card = smoke_model("qwen3-8b", "bfloat16", dev, int8=False)
    step = make_decode_step(card)
    toks = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    cache = card.init_cache(2, 32)
    step(cache, toks, 3)
    step(cache, toks, 4)  # the same weights: a replay
    assert step.replays == 2
    quantize_for_serving(card)
    with pytest.raises(RuntimeError, match="weights changed"):
        step(cache, toks, 5)
    logits, _ = make_decode_step(card)(cache, toks, 5)
    assert bool(torch.isfinite(logits).all())


def test_decode_step_cache_of_other_shapes_raises(dev):
    from repro_torch.serve.engine import make_decode_step

    cfg, _, card = smoke_model("qwen3-8b", "bfloat16", dev, int8=False)
    step = make_decode_step(card)
    toks = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    step(card.init_cache(2, 32), toks, 3)
    with pytest.raises(ValueError):
        step(card.init_cache(2, 48), toks, 4)


# ------------------------------------------------- the MoE expert FFN
# (E, cap, d, f): caps 1-16 across the kernel's three row counts (4, 8, 16),
# d and f multiples of 8 but not of a block's strip (256 columns in bf16,
# 128 in float32), K past one 512-row staging chunk; and 16 experts at
# qwen3-moe-235b's widths
MOE_CASES = [(6, 1, 64, 96), (6, 3, 200, 72), (5, 4, 264, 520), (5, 5, 136, 40),
             (4, 8, 1032, 24), (4, 9, 48, 200), (3, 16, 520, 264), (16, 4, 4096, 1536)]
MOE_COUNTS = ("zero", "one", "cap", "mixed")
MOE_SUM_RTOL, SILU_SLOPE = 1e-5, 1.1  # chip_smoke.py's limits


def moe_inputs(case, counts, dtype, dev, seed=0):
    e, cap, d, f = case
    g = torch.Generator(device="cpu").manual_seed(seed + sum(case))
    buf = torch.randn((e, cap, d), generator=g)  # rows past a count hold values too
    ws = [(torch.randn((e, a, b), generator=g) * a ** -0.5) for a, b in ((d, f), (d, f), (f, d))]
    count = {"zero": [0] * e, "one": [1] * e, "cap": [cap] * e,
             "mixed": [(i * 7) % (cap + 1) for i in range(e)]}[counts]
    return ([t.to(dtype).to(dev) for t in (buf, *ws)],
            torch.tensor(count, dtype=torch.int64, device=dev))


def moe_check(h, out, buf, count, wg, wu, wd):
    """Both stages against the exact products of the kept rows (float64):
    each product within ``1e-5 * sum(|x| |w|)`` (its float32 sum) plus half
    a step of the dtype (its rounding), the gate/up bound carried through
    silu (slope at most 1.1) and the product, each rounded once more — the
    W8 kernel's limit on each product, as chip_smoke.py holds it."""
    hs = 2.0 ** -8 if buf.dtype == torch.bfloat16 else 0.0
    rows = torch.arange(buf.shape[1], device=buf.device)
    keep = (rows[None, :] < count[:, None])[..., None]
    x = buf.double() * keep
    wg, wu, wd = wg.double(), wu.double(), wd.double()
    g, u = torch.bmm(x, wg), torch.bmm(x, wu)
    eg = MOE_SUM_RTOL * torch.bmm(x.abs(), wg.abs()) + hs * g.abs()
    eu = MOE_SUM_RTOL * torch.bmm(x.abs(), wu.abs()) + hs * u.abs()
    silu = g * torch.sigmoid(g)
    es = SILU_SLOPE * eg + hs * (silu.abs() + SILU_SLOPE * eg)
    h_limit = es * (u.abs() + eu) + silu.abs() * eu + hs * (silu.abs() + es) * (u.abs() + eu)
    assert bool(((h.double() - silu * u).abs() <= h_limit).all())
    o_exact = torch.bmm(h.double(), wd)
    o_limit = MOE_SUM_RTOL * torch.bmm(h.double().abs(), wd.abs()) + hs * o_exact.abs()
    assert bool(((out.double() - o_exact).abs() <= o_limit).all())
    assert not h[~keep[..., 0]].any() and not out[~keep[..., 0]].any()
    return h_limit, o_limit


@pytest.mark.parametrize("counts", MOE_COUNTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_kernel_matches_plain(dev, case, dtype, counts):
    """The two stages against the exact products and the plain version on
    the same inputs (each limit twice: both round), rows past each count
    zero, two launches, equal on a rerun."""
    from repro_torch.kernels import moe_ffn as MF

    torch.backends.cuda.matmul.allow_tf32 = False
    (buf, wg, wu, wd), count = moe_inputs(case, counts, dtype, dev)
    _cuda.reset_launches()
    h = MF.moe_gate_up(buf, count, wg, wu)
    out = MF.moe_down(h, count, wd)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["moe_ffn"] == 2
    assert out.dtype == dtype and out.shape == buf.shape[:2] + (wd.shape[2],)
    h_limit, o_limit = moe_check(h, out, buf, count, wg, wu, wd)
    assert torch.equal(MF.moe_ffn(buf, count, wg, wu, wd), out)  # a fixed order
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        h_plain = MF.moe_gate_up_torch(buf, count, wg, wu)
        out_plain = MF.moe_down_torch(h, count, wd)  # the down stage on the kernel's h
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    assert bool(((h - h_plain).double().abs() <= 2 * h_limit).all())
    assert bool(((out - out_plain).double().abs() <= 2 * o_limit).all())


def test_moe_launch_count_and_refusals(dev):
    from repro_torch.kernels import moe_ffn as MF

    (buf, wg, wu, wd), count = moe_inputs(MOE_CASES[1], "mixed", torch.bfloat16, dev)
    _cuda.reset_launches()
    for _ in range(3):
        MF.moe_ffn(buf, count, wg, wu, wd)
    assert _cuda.LAUNCHES["moe_ffn"] == 6
    e, cap, d = buf.shape
    big = torch.zeros((e, 17, d), dtype=buf.dtype, device=dev)
    for args in [(big, count, wg, wu),  # more rows an expert than the kernel takes
                 (buf.half(), count, wg.half(), wu.half()),  # float16 is not instantiated
                 (buf, count, wg.float(), wu),  # mixed types
                 (buf, count, wg.cpu(), wu),  # a weight on the host
                 (buf, count.int(), wg, wu),  # int32 counts
                 (buf, count[:-1], wg, wu),  # a count short
                 (buf[:, :, ::2], count, wg[:, ::2], wu[:, ::2]),  # not contiguous
                 (buf[:, :, :-4].contiguous(), count, wg[:, :-4].contiguous(),
                  wu[:, :-4].contiguous()),  # K % 8 != 0
                 (buf, count, wg, wu[:, :, :-8].contiguous())]:  # N differs
        with pytest.raises(ValueError):
            MF.moe_gate_up(*args)
    assert _cuda.LAUNCHES["moe_ffn"] == 6


def test_moe_kernel_graph_replay_equals_eager(dev):
    """The two stages captured in a CUDA graph launch nothing and record
    two launches; a replay writes what the eager launches returned."""
    from repro_torch.kernels import moe_ffn as MF

    (buf, wg, wu, wd), count = moe_inputs(MOE_CASES[-1], "mixed", torch.bfloat16, dev)
    eager = MF.moe_ffn(buf, count, wg, wu, wd)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    _cuda.reset_launches()
    with torch.cuda.graph(graph, stream=side):
        out = MF.moe_ffn(buf, count, wg, wu, wd)
    assert _cuda.LAUNCHES["moe_ffn"] == 0 and _cuda.CAPTURED["moe_ffn"] == 2
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"])
def test_moe_graph_replay_equals_eager_over_readmissions(dev, arch, monkeypatch):
    """An MoE smoke's graphed decode step against the eager step: equal
    tokens and bit-equal logits tick by tick across three admissions (a
    capture with the routing's sorts and searches inside it).  The MoE
    kernel's wrapper launches twice a layer in the warm-up step, which the
    capture records, and in each prefill whose capacity is at most 16 rows
    an expert (top-1's, not top-2's, at these prompts); its plain version
    never runs."""
    from repro_torch.kernels import moe_ffn as MF
    from repro_torch.models.layers import MOE_DECODE_ROWS, moe_capacity
    from repro_torch.models.lm import moe_spec
    from repro_torch.serve.engine import GraphedDecodeStep

    cfg, _, card = smoke_model(arch, "bfloat16", dev, int8=False)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, 33 + 2 * i).astype(np.int32) for i in range(5)]
    eager_tokens, eager_logits, _ = serve_logged(card, prompts, eager=True)
    plain = []
    real = MF.moe_ffn_torch
    monkeypatch.setattr(MF, "moe_ffn_torch", lambda *a: plain.append(1) or real(*a))
    _cuda.reset_launches()
    tokens, logits, step = serve_logged(card, prompts, eager=False)
    assert isinstance(step, GraphedDecodeStep) and step.graph is not None
    assert tokens == eager_tokens
    assert len(logits) == len(eager_logits) > 6
    for a, b in zip(logits, eager_logits):
        assert torch.equal(a, b)
    admissions = [max(len(p) for p in prompts[i:i + 2]) for i in range(0, len(prompts), 2)]
    small = sum(moe_capacity(moe_spec(cfg), 2 * s) <= MOE_DECODE_ROWS for s in admissions)
    assert small == (3 if cfg.top_k == 1 else 0)
    assert _cuda.LAUNCHES["moe_ffn"] == 2 * cfg.n_layers * (1 + small)
    assert step.captured["moe_ffn"] == 2 * cfg.n_layers
    assert not plain


def test_moe_decode_step_raises_after_an_expert_weight_changes(dev):
    """The captured step holds the MoE weights' addresses too."""
    from repro_torch.serve.engine import make_decode_step

    cfg, _, card = smoke_model("qwen3-moe-235b-a22b", "bfloat16", dev, int8=False)
    step = make_decode_step(card)
    toks = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    cache = card.init_cache(2, 32)
    step(cache, toks, 3)
    moe = card.layers[1].moe
    moe.expert_down = torch.nn.Parameter(moe.expert_down.detach().clone(), requires_grad=False)
    with pytest.raises(RuntimeError, match="weights changed"):
        step(cache, toks, 4)


# --------------------------------------------------- the RG-LRU scan
# (B, S, W): one step; W not a multiple of a block's 32 lanes; S not a
# multiple of the ring's 32-step stages; recurrentgemma-9b's prefill; S one
# past a stage with a ragged last block; train_rg's microbatch; W not a
# multiple of 4 (the cp.async form)
RGLRU_CASES = [(2, 1, 64), (2, 37, 100), (3, 300, 4096), (8, 2048, 4096), (1, 33, 4100),
               (2, 2048, 4096), (2, 70, 66)]


def rglru_inputs(b, s, w, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed + b + s + w)
    a = torch.rand((b, s, w), generator=g)
    x = torch.randn((b, s, w), generator=g)
    return a.to(dev), x.to(dev)


@pytest.mark.parametrize("case", RGLRU_CASES, ids=lambda c: "x".join(map(str, c)))
def test_rglru_scan_matches_plain(dev, case):
    """Bit-equal to the plain version's sequential float32 loop, one launch."""
    from repro_torch.kernels import rglru_scan as RS

    a, x = rglru_inputs(*case, dev)
    _cuda.reset_launches()
    got = RS.rglru_scan(a, x)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["rglru_scan"] == 1
    assert got.dtype == torch.float32 and got.shape == a.shape and got.is_contiguous()
    assert torch.equal(got, RS.rglru_scan_torch(a, x))


def test_rglru_scan_blocks_a_row_and_a_ragged_group(dev):
    """Several blocks a batch row and a last block whose lanes straddle the
    ragged W edge, beside a width of one warp and one below it: bit-equal
    as before, in one launch each."""
    from repro_torch.kernels import rglru_scan as RS

    for shape in ((4, 50, 1000), (3, 40, 32), (2, 65, 12)):
        a, x = rglru_inputs(*shape, dev)
        plan = _cuda.rglru_scan_plan(a, x)
        assert plan.blocks == shape[0] * -(-shape[2] // 32) and plan.form == "tma"
        _cuda.reset_launches()
        assert torch.equal(RS.rglru_scan(a, x), RS.rglru_scan_torch(a, x))
        assert _cuda.LAUNCHES["rglru_scan"] == 1


def off_by_a_float(t):
    """A contiguous copy of ``t`` whose base is 4 bytes past a 16-byte
    boundary: the TMA form cannot read it."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 and out.is_contiguous()
    return out


@pytest.mark.parametrize("shape,shifted", [
    ((2, 2048, 4096), "a"), ((2, 2048, 4096), "x"), ((2, 2048, 4096), "both"),
    ((8, 2048, 4096), "both"), ((2, 100, 300), "x")], ids=lambda c: "x".join(map(str, c))
    if isinstance(c, tuple) else c)
def test_rglru_scan_cp_async_form_matches_plain(dev, shape, shifted):
    """Inputs whose base is off 16 bytes (W a multiple of 4), at train_rg's
    microbatch, the hybrid prefill and a small shape: the plan takes the
    cp.async form, one launch, bit-equal to the plain loop."""
    from repro_torch.kernels import rglru_scan as RS

    a, x = rglru_inputs(*shape, dev)
    want = RS.rglru_scan_torch(a, x)
    if shifted in ("a", "both"):
        a = off_by_a_float(a)
    if shifted in ("x", "both"):
        x = off_by_a_float(x)
    assert _cuda.rglru_scan_plan(a, x).form == "async"
    _cuda.reset_launches()
    assert torch.equal(RS.rglru_scan(a, x), want)
    assert _cuda.LAUNCHES["rglru_scan"] == 1


def test_rglru_scan_launcher_refuses_the_tma_form_for_an_unaligned_base(dev):
    """The C launcher checks the plan's form against the inputs: the TMA
    form with a base off 16 bytes is refused (nothing launched), the
    cp.async form of the same inputs runs."""
    a, x = rglru_inputs(2, 100, 300, dev)
    x = off_by_a_float(x)
    h = torch.empty_like(a)
    lib = _cuda.load()
    plan = _cuda.rglru_forward_plan(2, 100, 300, aligned=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for form, want in (("tma", False), ("async", True)):
        params = _cuda._RglruParams(a=a.data_ptr(), x=x.data_ptr(), h=h.data_ptr(), batch=2,
                                    seq=100, width=300, blocks=plan.blocks, smem=plan.smem,
                                    form=_cuda.RGLRU_FWD_FORMS[form])
        assert (lib.rm_rglru_scan(ctypes.byref(params), stream) == 0) == want, form
    torch.cuda.synchronize()


def test_rglru_scan_launch_count_and_refusals(dev):
    from repro_torch.kernels import rglru_scan as RS

    a, x = rglru_inputs(2, 16, 64, dev)
    _cuda.reset_launches()
    for _ in range(3):
        RS.rglru_scan(a, x)
    assert _cuda.LAUNCHES["rglru_scan"] == 3
    with pytest.raises(ValueError, match="float32"):
        RS.rglru_scan(a.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        RS.rglru_scan(a.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        RS.rglru_scan(a, x.cpu())
    with pytest.raises(ValueError, match="one shape"):
        RS.rglru_scan(a, x[:, :8].contiguous())
    assert _cuda.LAUNCHES["rglru_scan"] == 3


def test_rglru_scan_graph_replay_equals_eager(dev):
    from repro_torch.kernels import rglru_scan as RS

    a, x = rglru_inputs(2, 100, 300, dev)
    eager = RS.rglru_scan(a, x)
    RS.rglru_scan(a, x)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = RS.rglru_scan(a, x)
    assert _cuda.LAUNCHES["rglru_scan"] == 0 and _cuda.CAPTURED["rglru_scan"] == 1
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_recurrent_graph_replay_equals_eager_over_readmissions(dev, arch):
    """A recurrent smoke's graphed decode step against the eager step: equal
    tokens and bit-equal logits tick by tick across three admissions (the
    second and third copy their prefill's states into the captured ones,
    and the capture's warm-up puts the states back before the first
    replay).  The scan kernel launches once per RG-LRU layer in each
    prefill and never in a decode step."""
    from repro_torch.serve.engine import GraphedDecodeStep

    cfg, _, card = smoke_model(arch, "bfloat16", dev, int8=False)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, 33 + 2 * i).astype(np.int32) for i in range(5)]
    eager_tokens, eager_logits, _ = serve_logged(card, prompts, eager=True)
    _cuda.reset_launches()
    tokens, logits, step = serve_logged(card, prompts, eager=False)
    assert isinstance(step, GraphedDecodeStep) and step.graph is not None
    assert tokens == eager_tokens
    assert len(logits) == len(eager_logits) > 6
    for a, b in zip(logits, eager_logits):
        assert torch.equal(a, b)
    rglru = sum(layer.kind == "rglru" for layer in card.layers)
    assert _cuda.LAUNCHES["rglru_scan"] == 3 * rglru
    assert step.captured["rglru_scan"] == 0 and step.replays == len(logits)


def input_family_model(arch, dev, seed=3):
    """A bf16 smoke of one of the two families ``ServeSession`` does not
    serve, on the card with the CPU model's weights, and three admissions of
    2 slots (prompts of 12, 20 and 16 positions; the VLM's embeddings and
    M-RoPE ids of 4 text tokens, a 2 x 2 grid, then text; the
    encoder-decoder's 8 frames, 64 // 8: its init_cache's cross length)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="bfloat16")
    cpu = build_model(cfg, device="cpu", seed=seed)
    card = build_model(cfg, device=dev, seed=None)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(9)
    admissions = []
    for s in (12, 20, 16):
        if cfg.embed_inputs:
            batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, s))).to(dev),
                     "enc_embeds": torch.from_numpy(
                         rng.normal(0, 0.5, (2, 8, cfg.d_model)).astype(np.float32)).to(dev)}
            inputs = None
        else:
            pos = np.zeros((3, s), np.int64)
            pos[:, :4] = np.arange(4)
            pos[:, 4:8] = 4
            pos[1, 4:8] += [0, 0, 1, 1]
            pos[2, 4:8] += [0, 1, 0, 1]
            pos[:, 8:] = 6 + np.arange(s - 8)
            batch = {"embeds": torch.from_numpy(
                         rng.normal(0, 0.5, (2, s, cfg.d_model)).astype(np.float32)).to(dev),
                     "positions": torch.from_numpy(np.broadcast_to(pos, (2, 3, s)).copy()).to(dev)}
            inputs = [torch.from_numpy(rng.normal(0, 0.5, (2, 1, cfg.d_model)).astype(
                np.float32)).to(dev) for _ in range(5)]
        admissions.append((batch, inputs))
    return cfg, card, admissions


def drive_logged(model, admissions, eager: bool):
    """Each admission prefilled, then 5 decode steps (the greedy token fed
    back, or the admission's embeddings) through ``make_decode_step`` or the
    eager step: the tokens, every step's logits, and the step."""
    from repro_torch.serve.engine import make_decode_step

    step = model.decode_step if eager else make_decode_step(model)
    logged, tokens = [], []
    for batch, inputs in admissions:
        s = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[1]
        logits, cache = model.prefill(batch, 64)
        out = [logits.argmax(-1)]
        for t in range(5):
            x = out[-1][:, None] if inputs is None else inputs[t]
            logits, cache = step(cache, x, s + t)
            logged.append(logits.clone())
            out.append(logits.argmax(-1))
        tokens.append(torch.stack(out, 1).cpu())
    return tokens, logged, step


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "seamless-m4t-medium"])
def test_input_family_graph_replay_equals_eager_over_readmissions(dev, arch):
    """The VLM backbone's and the encoder-decoder's graphed decode step (over
    (B, 1, D) embeddings, and over the flat cache with its cross K/V)
    against the eager step: equal tokens and bit-equal logits step by step
    across three admissions (the second and third copy their prefill's
    cache, cross K/V included, into the captured one).  The flash kernel
    launches once per attention layer (the encoder's too) and prefill, never
    in a step."""
    from repro_torch.serve.engine import GraphedDecodeStep

    cfg, card, admissions = input_family_model(arch, dev)
    eager_tokens, eager_logits, _ = drive_logged(card, admissions, eager=True)
    _cuda.reset_launches()
    tokens, logits, step = drive_logged(card, admissions, eager=False)
    assert isinstance(step, GraphedDecodeStep) and step.graph is not None
    assert all(torch.equal(a, b) for a, b in zip(tokens, eager_tokens))
    assert len(logits) == len(eager_logits) == 15
    for a, b in zip(logits, eager_logits):
        assert torch.equal(a, b)
    attention = cfg.n_layers + cfg.n_enc_layers
    assert _cuda.LAUNCHES["flash_attention"] == 3 * attention
    assert step.captured["flash_attention"] == 0 and step.replays == len(logits)


# ------------------------------------------------------- sharded backend
def sharded_tables(n=5000, seed=3):
    """A 5,000-row fact table (int32 payloads below 2^24: re-associated
    float32 sums stay exact) and a 64-row dimension with key ``A2``."""
    from repro_torch.core import benchmark_schema

    rng = np.random.default_rng(seed)
    schema = benchmark_schema(64, 4)
    cols = {c.name: rng.integers(-1000, 1000, n).astype(np.int32) for c in schema.columns}
    cols["A2"] = rng.integers(0, 128, n).astype(np.int32)
    dim = {c.name: rng.integers(-1000, 1000, 64).astype(np.int32) for c in schema.columns}
    dim["A2"] = np.arange(64, dtype=np.int32)
    return (RelationalTable.from_columns(schema, cols),
            RelationalTable.from_columns(schema, dim))


def sharded_ops(eng, t, r, ts=None):
    from repro_torch.core import AggregateOp, FilterOp, GroupByOp, JoinOp, ProjectOp

    return [ProjectOp(eng.register(t, ["A1", "A5", "A9"])),
            FilterOp(eng.register(t, ["A2", "A3"]), "A4", "gt", 0, ts),
            AggregateOp(t, "A6", "A7", "lt", 100, ts),
            GroupByOp(t, "A16", "A8", 16, snapshot_ts=ts),
            JoinOp(eng.register(t, ["A1", "A2"]), "A2", "A1", r, "A3", snapshot_ts=ts)]


def assert_all_equal(want, got):
    for a, b in zip(want, got):
        if hasattr(a, "s_proj"):
            a, b = (a.s_proj, a.r_proj, a.matched), (b.s_proj, b.r_proj, b.matched)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x.cpu(), y.cpu())


def test_scan_shard_matches_plain_per_chunk(dev):
    from repro_torch.kernels import rme_scan_multi as KR

    w = torch.from_numpy(make_words(7001)).to(dev)
    chunks = [w[:3000], w[3000:3001], w[3001:]]
    reqs = (ProjectRequest(geom([0, 4, 8])),
            FilterRequest(geom([1, 2]), pred_word=3, pred_op="gt", pred_k=0,
                          ts_word=16, ts=5),
            AggregateRequest(agg_word=5, pred_word=6, pred_op="lt", pred_k=100),
            GroupByRequest(group_word=3, agg_word=7, num_groups=16))
    _cuda.reset_launches()
    got = KR.scan_shard(chunks, reqs)
    assert _cuda.LAUNCHES["scan_multi"] == 3
    assert len(got) == 3 and all(len(outs) == 4 for outs in got)
    for chunk, outs in zip(chunks, got):
        assert_all_equal(KR.scan_multi_torch(chunk, reqs), outs)


def test_broadcast_partitions_onto_the_card(dev):
    from repro_torch.kernels.rme_join import broadcast_partitions

    keys = np.arange(300, dtype=np.int32)
    parts = K.build_partitions(keys, keys * 3, device="cpu")
    same, moved = broadcast_partitions(parts, [None, dev])
    assert same is parts
    assert all(t.device.type == "cuda" for t in moved)
    for a, b in zip(parts, moved):
        assert torch.equal(a, b.cpu())
    # already on the card: the replica is the same tensors, no copy
    again = broadcast_partitions(moved, [dev])[0]
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(moved, again))


def test_sharded_engine_on_the_card_matches_the_cpu(dev):
    """4 logical shards on the card against the CPU sharded engine and the
    card's single-device engine, with writes and a snapshot; every stats
    field equal between the two sharded engines."""
    import dataclasses

    from repro_torch.core import ShardedEngine, planner

    out = {}
    for name, mk in (("card", lambda: ShardedEngine(num_shards=4)),
                     ("cpu", lambda: ShardedEngine(num_shards=4, device="cpu")),
                     ("single", lambda: RelationalMemoryEngine())):
        planner.clear_join_build_cache()
        eng = mk()
        t, r = sharded_tables()
        first = eng.execute_many(sharded_ops(eng, t, r))
        t.append({c.name: np.arange(77, dtype=np.int32) for c in t.schema.columns})
        t.delete(np.arange(0, 5000, 13))
        second = eng.execute_many(sharded_ops(eng, t, r, t.now()))
        solo = eng.execute_many(sharded_ops(eng, t, r)[-1:])  # the solo join probe
        out[name] = (first + second + solo, eng)
    assert_all_equal(out["cpu"][0], out["card"][0])
    assert_all_equal(out["cpu"][0], out["single"][0])
    assert (dataclasses.asdict(out["card"][1].stats)
            == dataclasses.asdict(out["cpu"][1].stats))
    assert out["card"][1].breaker.snapshot()["breaker_fallbacks"] == 0


def test_sharded_failover_launches_the_kernel(dev, monkeypatch):
    """A permanent ``shard_pass`` fault on shard 1: the shard's chunks re-run
    on the root device through the fused scan kernel — never its plain
    version — and the results stay equal."""
    from repro_torch.core import AggregateOp, GroupByOp, ShardedEngine, faults
    from repro_torch.kernels import rme_scan_multi as KR

    t, _ = sharded_tables()
    eng = ShardedEngine(num_shards=4)
    ops = lambda: [AggregateOp(t, "A6"), GroupByOp(t, "A16", "A8", 16)]  # noqa: E731
    want = eng.execute_many(ops())

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(KR, "scan_multi_torch", no_plain)
    _cuda.reset_launches()
    plan = faults.FaultPlan().inject("shard_pass", kind="permanent", times=None, shard=1)
    with faults.fault_plan(plan):
        got = eng.execute_many(ops())
    chunks = [len(c) for c in eng.rowstore.shard_parts(t)]
    assert _cuda.LAUNCHES["scan_multi"] == sum(chunks)  # shard 1's by failover
    assert eng.stats.failovers == 1
    assert eng.stats.bytes_failover == sum(
        c.words.numel() * 4 for c in eng.rowstore.shard_parts(t)[1])
    assert_all_equal(want, got)


def test_sharded_real_kernel_error_propagates(dev):
    """A malformed request fails inside the kernel wrapper: the error
    propagates, nothing is retried or failed over."""
    from repro_torch.core import ShardedEngine

    t, _ = sharded_tables()
    eng = ShardedEngine(num_shards=4)
    bad = (AggregateRequest(agg_word=40), AggregateRequest(agg_word=1))
    with pytest.raises(ValueError, match="outside the 18-word row"):
        eng._serve_scan(t, bad)
    assert (eng.stats.retries, eng.stats.failovers, eng.stats.bytes_failover) == (0, 0, 0)
    assert eng.shard_health() == ["healthy"] * 4


@pytest.mark.parametrize("mesh", [["cpu", "cuda"], ["cuda", "cpu"], [None, "cpu"]])
def test_sharded_mesh_of_mixed_devices_raises(dev, mesh):
    """A mesh never mixes the card and the host: a card shard can then
    neither fail over to a host root nor take the breaker's plain route."""
    from repro_torch.core import ShardedEngine
    from repro_torch.core.distributed import dist_aggregate
    from repro_torch.serve import QueryServer

    for build in (lambda: ShardedEngine(mesh=mesh), lambda: QueryServer(mesh=mesh),
                  lambda: dist_aggregate(torch.zeros((4, 18), dtype=torch.int32), mesh,
                                         agg_word=0)):
        with pytest.raises(ValueError, match="devices of one type"):
            build()
    assert ShardedEngine(mesh=[dev, dev]).device.type == "cuda"


# last in the file: a capture that fails leaves no work behind it
def test_failing_capture_raises(dev, monkeypatch):
    """A step that reads a device value back to the host cannot be
    captured: the graphed step raises, and never falls back to eager."""
    from repro_torch.serve.engine import make_decode_step

    cfg, _, card = smoke_model("qwen3-8b", "bfloat16", dev, int8=False)
    decode = card.decode_step

    def syncing(cache, tokens, pos):
        logits, cache = decode(cache, tokens, pos)
        logits.sum().item()  # a device-to-host read: not capturable
        return logits, cache

    monkeypatch.setattr(card, "decode_step", syncing)
    step = make_decode_step(card)
    with pytest.raises(RuntimeError):
        step(card.init_cache(2, 32), torch.zeros((2, 1), dtype=torch.int32, device=dev), 3)
    assert step.graph is None
    torch.cuda.synchronize()
    assert float((torch.ones(4, device=dev) * 2).sum()) == 8.0


# ------------------------------------------------- wide rows (ROADMAP fault 3.2)
WIDE_SEQ = (2048, 4096)  # training records: 4,101- and 8,197-word rows


def record_words(seq, n, dev, seed=0):
    """``n`` stored rows of ``data.record_schema(seq)``: doc_id, split,
    weight, the tokens and labels words, then the two MVCC words."""
    rng = np.random.default_rng(seed + seq)
    w = rng.integers(I32.min, I32.max, (n, 3 + 2 * seq + 2), dtype=np.int64).astype(np.int32)
    w[:, :2] = rng.integers(-1000, 1000, (n, 2))  # int32 sums stay exact in float32
    w[:, 2] = rng.normal(0, 10, n).astype(np.float32).view(np.int32)
    w[:, -2] = rng.integers(0, 10, n)
    w[:, -1] = np.where(rng.random(n) < 0.3, rng.integers(3, 12, n), I32.max)
    return torch.from_numpy(w).to(dev)


def record_geom(seq, cols=("tokens", "labels")):
    from repro_torch.data import record_schema

    return TableGeometry.from_schema(record_schema(seq), list(cols), row_count=0)


WIDE_NAMES = {"mlp": "project", "pck": "project_pck", "bsl": "project_bsl"}


def assert_wide_projection(words, g, revision):
    """One launch of ``revision``, bit-equal to the plain version."""
    _cuda.reset_launches()
    got = K.project(words, g, revision)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[WIDE_NAMES[revision]] == 1, dict(_cuda.LAUNCHES)
    assert got.shape == (words.shape[0], g.out_words_per_row)
    assert torch.equal(got, K.project_torch(words, g))


@pytest.mark.parametrize("revision", ["mlp", "pck", "bsl"])
@pytest.mark.parametrize("seq", WIDE_SEQ)
def test_wide_projection_matches_plain(dev, seq, revision):
    """A training record's ``(tokens, labels)`` view — 4,096 or 8,192
    packed words of 4,101- or 8,197-word rows, far past 512 words and past
    what a staged tile holds — bit-equal to the plain version in one launch
    of each revision: from an aligned and an odd row, and at 1, 3, a staged
    tile's rows (4) less and more one, 300 and 4,096 rows; the span kernel
    (mlp) also for ``(weight, tokens, labels)`` (three columns, one range)
    and ``(doc_id, weight, labels)`` (three ranges with gaps)."""
    words = record_words(seq, 4096, dev)
    g = record_geom(seq)
    tile = _cuda.tile_rows(words.shape[1])
    for chunk in (words[:300], words[1:300], words[:1], words[5:8], words[:tile - 1],
                  words[3:tile + 4], words):
        assert_wide_projection(chunk, g, revision)
    if revision == "mlp":
        for cols in (("weight", "tokens", "labels"), ("doc_id", "weight", "labels")):
            assert_wide_projection(words[1:], record_geom(seq, cols), revision)


# wide-row layouts: (storage words past 2,048, (word offset, width) per column)
WIDE_LAYOUTS = [
    (r, cols) for r in range(4) for cols in (
        ((r + 1, 2000),),  # Q 1
        ((r, 3), (r + 5, 2043)),  # Q 2 with a gap
        ((1, 1), (3, 700), (704 + r, 5), (712, 1000), (1713 + r, 333)),  # Q 5 with gaps
    )
]


@pytest.mark.parametrize("extra,cols", WIDE_LAYOUTS)
def test_wide_projection_layouts(dev, extra, cols):
    """The span kernel (mlp) at rows of 2,049 + ``extra`` words — every
    width mod 4, all of them read in place — for column offsets of every
    value mod 4, one, two and five columns with gaps, bit-equal to the plain
    version in one launch: from an aligned row and from rows 1 and 3 (a row
    store starting at each word of a 16-byte block), at 1, 3, 5 and 4,096
    rows; BSL and PCK the same at 4,096 rows, and BSL also at 1, 257, 300
    and 4,095 rows from rows 0 to 3."""
    row_words = _cuda.DIRECT_ROW_WORDS + 1 + extra
    rng = np.random.default_rng(extra)
    words = torch.from_numpy(rng.integers(I32.min, I32.max, (4099, row_words),
                                          dtype=np.int64).astype(np.int32)).to(dev)
    g = geom([o for o, _ in cols], [w for _, w in cols], row_words)
    for start in (0, 1, 2, 3):
        for n in (1, 3, 5, 4096):
            assert_wide_projection(words[start:start + n], g, "mlp")
    for revision in ("pck", "bsl"):
        assert_wide_projection(words[:4096], g, revision)
    # BSL's wide form: row counts that are not a multiple of its 256-row
    # tile, from rows that start at every word of a 16-byte block
    for start, n in ((1, 300), (2, 257), (3, 4095), (0, 1)):
        assert_wide_projection(words[start:start + n], g, "bsl")


@pytest.mark.parametrize("extra,cols", WIDE_LAYOUTS)
def test_pck_wide_form_layouts(dev, extra, cols):
    """PCK's wide form (packed ranges gathered into a packer with 16-byte
    loads, stored by bulk copies, or word by word where the packed width is
    not a multiple of 4) at the layouts above, bit-equal to the plain
    version in one launch: from rows 0 to 3 (a row store starting at each
    word of a 16-byte block), at row counts that are not a multiple of its
    tile, and at a grid smaller than its items (4,095 rows)."""
    row_words = _cuda.DIRECT_ROW_WORDS + 1 + extra
    rng = np.random.default_rng(100 + extra)
    words = torch.from_numpy(rng.integers(I32.min, I32.max, (4099, row_words),
                                          dtype=np.int64).astype(np.int32)).to(dev)
    g = geom([o for o, _ in cols], [w for _, w in cols], row_words)
    for start, n in ((0, 1), (1, 5), (2, 257), (3, 4095), (0, 4096)):
        assert_wide_projection(words[start:start + n], g, "pck")


@pytest.mark.parametrize("seq", WIDE_SEQ)
def test_wide_rows_through_every_scan_kernel(dev, seq):
    """Wide rows through the filter, aggregate and group-by kernels, the
    fused scan (a projection, a filter of the tokens, an aggregate and a
    group-by in one launch: more than 512 packed words), ``project_multi``
    and ``select_compact`` (2,048+ packed words): each bit-equal to its
    plain version (sums of float32 within 1e-5 of their magnitude), one
    launch each."""
    words = record_words(seq, 517, dev, seed=1)
    ts_word = words.shape[1] - 2
    both, toks = record_geom(seq), record_geom(seq, ("tokens",))
    pred = dict(pred_word=0, pred_dtype="int32", pred_op="gt", pred_k=-300,
                ts_word=ts_word, ts=6)
    _cuda.reset_launches()
    packed, mask = K.filter_project(words, toks, **pred)
    want_p, want_m = K.filter_project_torch(words, toks, **pred)
    assert torch.equal(packed, want_p) and torch.equal(mask, want_m)
    agg = dict(agg_word=2, agg_dtype="float32", **pred)
    got, want = K.aggregate(words, **agg), K.aggregate_torch(words, **agg)
    assert got[1].item() == want[1].item()
    assert_sum_close(got[0], want[0], words[:, 2].view(torch.float32).abs().sum())
    gb = dict(group_word=0, agg_word=1, num_groups=7, ts_word=ts_word, ts=6)
    sums, counts = K.groupby_sum(words, **gb)
    want_s, want_c = K.groupby_sum_torch(words, **gb)
    assert torch.equal(counts, want_c) and torch.equal(sums, want_s)
    reqs = [ProjectRequest(both), FilterRequest(toks, **pred),
            AggregateRequest(agg_word=2, agg_dtype="float32", pred_word=0, pred_op="lt",
                             pred_k=100),
            GroupByRequest(group_word=0, agg_word=1, num_groups=16, ts_word=ts_word, ts=6)]
    got = K.scan_multi(words, reqs)
    want = K.scan_multi_torch(words, reqs)
    for g, w in zip(got[:2], want[:2]):
        for a, b in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            assert torch.equal(a, b)
    assert got[2][1].item() == want[2][1].item()
    assert_sum_close(got[2][0], want[2][0], words[:, 2].view(torch.float32).abs().sum())
    assert torch.equal(got[3][0], want[3][0]) and torch.equal(got[3][1], want[3][1])
    views = K.project_multi(words, [toks, both])
    for a, b in zip(views, K.project_multi_torch(words, [toks, both])):
        assert torch.equal(a, b)
    sel = dict(pred_word=0, pred_op="gt", pred_k=0, ts_word=ts_word, ts=6, block_rows=128)
    assert_select_equal(K.select_compact(words, toks, **sel),
                        K.select_compact_torch(words, toks, **sel))
    for name in ("filter_project", "aggregate", "groupby_sum", "scan_multi",
                 "project_multi", "select_compact"):
        assert _cuda.LAUNCHES[name] == 1, (name, dict(_cuda.LAUNCHES))


@pytest.mark.parametrize("seq", WIDE_SEQ)
def test_record_store_batches_on_the_card(dev, seq):
    """The data pipeline on the card: each batch's view packed by the
    projection kernel (twice a batch, as the reference's calls: 256 samples'
    view is more than the 2 MB reorg cache keeps), its rows gathered on the
    card, equal to a CPU store's batches, the engines' counters equal."""
    import dataclasses

    from repro_torch.data import RecordStore, TrainPipeline, synthetic_corpus

    tok, lab = synthetic_corpus(256, seq, 151936, seed=1)
    stores = [RecordStore(seq_len=seq, device=d) for d in (dev, "cpu")]
    for st in stores:
        st.ingest(tok, lab)
    _cuda.reset_launches()
    its = [TrainPipeline(st, batch_size=8, seed=0).batches(start_step=5) for st in stores]
    for _ in range(3):
        card, host = next(its[0]), next(its[1])
        assert card["tokens"].device.type == "cuda"
        assert torch.equal(card["tokens"].cpu(), host["tokens"])
        assert torch.equal(card["labels"].cpu(), host["labels"])
    assert _cuda.LAUNCHES["project"] == 6
    assert dataclasses.asdict(stores[0].engine.stats) == dataclasses.asdict(stores[1].engine.stats)


# --------------------------------------------------- the gradients (train/)
FLASH_GRAD_CASES = [
    # (B, S, H, KH, D, causal, window)
    (2, 256, 8, 2, 64, True, None),  # GQA group 4
    (1, 200, 16, 1, 128, True, None),  # group 16, a ragged tile
    (2, 256, 32, 8, 128, True, 100),  # qwen3-8b's heads, windowed
    (1, 192, 4, 1, 256, False, None),  # D 256, bidirectional
    (1, 130, 64, 4, 128, False, 48),  # group 16, bidirectional window
    (2, 1024, 16, 1, 256, True, 700),  # D 256, MQA group 16, a window inside S
    (1, 333, 4, 2, 256, True, None),  # D 256, S not a multiple of 64
    (2, 300, 8, 1, 256, False, 100),  # D 256, bidirectional window, ragged S
    (2, 256, 8, 2, 32, True, None),  # D 32: bf16 heads padded to 64 for the one-pass form
    (1, 150, 4, 4, 16, False, 40),  # D 16, bidirectional window, ragged S
]


# the backward kernel's gradients, as shares of each gradient's largest
# magnitude (chip_smoke.py's FLASH_GRAD_* limits, with their reasons): bf16
# at most twice as far from the float32 gradients as the plain bf16
# recompute and within 2^-6 of it; float32 within 1e-5 of it; against the
# kernel's plain version on the same output and lse, in bf16 two steps of
# bf16 at the gradient's largest value (float32 sums that differ by far less
# than a step, each rounded once to bf16, which can put an element one step
# of its own from the other's), in float32 1e-5 of the largest value
FLASH_GRAD_PLAIN_STEPS = 2


def bf16_step(x: float) -> float:
    """One step of bf16 (8 significant bits) at ``x`` > 0."""
    return math.ldexp(1.0, math.frexp(x)[1] - 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", FLASH_GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_matches_plain_autograd(dev, case, dtype, monkeypatch):
    """``FlashAttention``: the kernel's forward (one launch, within the
    forward's limit of the plain version) and one launch of the backward
    kernel, with no plain recompute; dq, dk and dv from the same ``dout``
    within the limits above of the plain recompute, the float32 gradients
    and the kernel's plain version; two backward calls bit-equal; the
    forward's output bit-equal with the lse stored and without, the lse
    within 1e-5 of the plain one."""
    from repro_torch.kernels import flash_attention as F

    causal, window = case[5:]
    base = flash_inputs(case, dtype, dev)
    leaves = [t.clone().requires_grad_() for t in base]
    _cuda.reset_launches()
    out = F.flash_attention(*leaves, causal=causal, window=window, block_k=64)
    dout = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev).to(dtype)

    def refuse(*_, **__):
        raise AssertionError("the card's backward ran a plain version")

    with monkeypatch.context() as m:
        for name in ("flash_attention_torch", "flash_attention_backward_torch", "_online_step"):
            m.setattr(F, name, refuse)
        grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == 1
    assert _cuda.LAUNCHES["flash_attention_backward"] == 1
    plain = [t.clone().requires_grad_() for t in base]
    want = F.flash_attention_torch(*plain, causal=causal, window=window, block_k=64)
    want_grads = torch.autograd.grad(want, plain, dout)
    rtol, atol = FLASH_TOL[dtype]
    err = (out.float() - want.float()).abs()
    assert torch.all(err <= atol + rtol * want.float().abs()), float(err.max())
    wide = [t.detach().float().requires_grad_() for t in base]
    exact = torch.autograd.grad(F.flash_attention_torch(*wide, causal=causal, window=window,
                                                        block_k=64), wide, dout.float())
    o, lse = _cuda.run_flash(*base, causal, window, lse=True)
    assert torch.equal(o, out) and torch.equal(o, _cuda.run_flash(*base, causal, window))
    _, want_lse = F.flash_attention_torch(*base, causal=causal, window=window, block_k=64,
                                          return_lse=True)
    assert float((lse - want_lse).abs().max()) <= 1e-5
    args = (*base, o, lse, dout, causal, window)
    again = _cuda.run_flash_backward(*args)
    own = F.flash_attention_backward_torch(*args, block_k=64)
    for g, a, w, x, pl in zip(grads, again, want_grads, exact, own):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        scale = float(w.float().abs().max())
        vs_recompute = float((g.float() - w.float()).abs().max()) / scale
        vs_plain = float((g.float() - pl.float()).abs().max())
        if dtype == torch.bfloat16:
            assert vs_plain <= FLASH_GRAD_PLAIN_STEPS * bf16_step(float(pl.float().abs().max()))
            assert (g.float() - x).abs().max() <= 2 * (w.float() - x).abs().max()
            assert vs_recompute <= 2.0 ** -6
        else:
            assert vs_plain <= 1e-5 * scale
            assert vs_recompute <= 1e-5


# A fresh process: the flash forward and the int8-weight matmul each on a new
# host thread, then the flash backward in autograd's worker thread for the card,
# whose first CUDA work it is.  Tensors come from the caching allocator, so no
# call of the thread's own has bound a context before a launcher encodes its
# tensor maps (the encoder binds it).
FRESH_THREADS = """
import sys, threading
import torch
from repro_torch.kernels import _cuda, flash_attention as F, w8_matmul as W8
from repro_torch.models.layers import quantize_weight

d = int(sys.argv[1])
_cuda.load()
g = torch.Generator().manual_seed(d)
q, k, v = (torch.randn((1, 160, n, d), generator=g).to(torch.bfloat16).cuda().requires_grad_()
           for n in (4, 2, 2))
rec = quantize_weight(torch.randn((256, 192), generator=g) * 0.05)
wq, ws = rec.q.cuda(), rec.s.cuda()
x = torch.randn((8, 256), generator=g).to(torch.bfloat16).cuda()
assert _cuda.w8_form(x.dtype, 256, 192, wq.data_ptr(), ws.data_ptr()) == "tensor"
done = {}

def on_a_new_thread(name, fn):
    def run():
        try:
            done[name] = fn()
        except Exception as e:
            done[name] = e
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if isinstance(done[name], Exception):
        raise done[name]
    return done[name]

_cuda.reset_launches()
o = on_a_new_thread("flash", lambda: F.flash_attention(q, k, v, causal=True, window=None,
                                                       block_k=64))
y = on_a_new_thread("w8", lambda: W8.w8_matmul(x, wq, ws))
grads = torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
torch.cuda.synchronize()
assert all(bool(t.isfinite().all()) for t in (o, y, *grads))
launches = {n: _cuda.LAUNCHES[n] for n in ("flash_attention", "flash_attention_backward",
                                            "w8_matmul")}
assert launches == dict.fromkeys(launches, 1), launches
print("ok")
"""


@pytest.mark.parametrize("head_dim", [64, 256])
def test_tma_launchers_run_on_a_thread_without_a_context(dev, head_dim):
    """The flash forward, the int8-weight matmul and the flash backward
    (the one-pass form at D 64, the D 256 form) each encode tensor maps on a
    thread whose CUDA work so far touched only cached tensors, the first
    backward of a process in autograd's worker thread among them: every
    launch runs."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(src), *filter(None, [os.environ.get("PYTHONPATH")])])}
    r = subprocess.run([sys.executable, "-c", FRESH_THREADS, str(head_dim)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-4000:]


def test_flash_backward_d256_two_calls_bit_equal(dev):
    """The D 256 form at recurrentgemma-9b's training shape (B 2, S 2,048,
    16 / 1 heads, causal, window 2,048): its key tiles cut into chunks
    whose float32 partials the last block of a tile sums, and a tile the
    plan leaves whole, each written straight — two calls bit-equal, and
    both within two steps of bf16 of the plain version."""
    from repro_torch.kernels import flash_attention as F

    case = (2, 2048, 16, 1, 256, True, 2048)
    b, s, h, kh = case[:4]
    items = _cuda.flash_bwd_key_items(s, h // kh, True, s)
    chunk = _cuda.flash_bwd_kv_plan(s, h // kh, True, s, b * kh, _cuda._sms(dev.index or 0))[0]
    assert chunk < max(items) and chunk >= min(items)  # cut tiles and whole ones
    base = flash_inputs(case, torch.bfloat16, dev)
    o, lse = _cuda.run_flash(*base, True, s, lse=True)
    dout = torch.randn(o.shape, generator=torch.Generator(device=dev).manual_seed(5),
                       device=dev).bfloat16()
    _cuda.reset_launches()
    one = _cuda.run_flash_backward(*base, o, lse, dout, True, s)
    two = _cuda.run_flash_backward(*base, o, lse, dout, True, s)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention_backward"] == 2
    plain = F.flash_attention_backward_torch(*base, o, lse, dout, True, s, block_k=1024)
    for a, c, pl in zip(one, two, plain):
        assert torch.equal(a, c)
        assert torch.isfinite(a.float()).all()
        err = float((a.float() - pl.float()).abs().max())
        assert err <= FLASH_GRAD_PLAIN_STEPS * bf16_step(float(pl.float().abs().max()))


@pytest.mark.parametrize("case", [
    # (B, S, H, KH, D, causal, window)
    (2, 2048, 32, 8, 128, True, None),  # the qwen3-8b training layer
    (2, 2048, 32, 8, 128, True, 1024),  # its windowed line
    (2, 2048, 32, 8, 128, False, None),  # bidirectional
    (1, 333, 16, 1, 128, True, None),  # MQA group 16, ragged S
    (2, 300, 8, 2, 64, False, 100),  # D 64, GQA group 4, bidirectional window, ragged S
    (1, 1000, 16, 4, 64, True, 700),  # D 64, a window inside S
], ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_one_pass_two_calls_bit_equal(dev, case):
    """The one-pass form (bf16, D 64 and 128): dQ's partials are summed in
    float32 scratch in key-block order behind a count a query tile, so two
    calls give bit-equal dq, dk and dv, each within two steps of bf16 of the
    plain version."""
    from repro_torch.kernels import flash_attention as F

    b, s, h, kh, d, causal, window = case
    assert _cuda.flash_backward_form(torch.bfloat16, d) == "one_pass"
    base = flash_inputs(case, torch.bfloat16, dev)
    o, lse = _cuda.run_flash(*base, causal, window, lse=True)
    dout = torch.randn(o.shape, generator=torch.Generator(device=dev).manual_seed(7),
                       device=dev).bfloat16()
    _cuda.reset_launches()
    one = _cuda.run_flash_backward(*base, o, lse, dout, causal, window)
    two = _cuda.run_flash_backward(*base, o, lse, dout, causal, window)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention_backward"] == 2
    plain = F.flash_attention_backward_torch(*base, o, lse, dout, causal, window, block_k=1024)
    for a, c, pl in zip(one, two, plain):
        assert torch.equal(a, c)
        assert torch.isfinite(a.float()).all()
        err = float((a.float() - pl.float()).abs().max())
        assert err <= FLASH_GRAD_PLAIN_STEPS * bf16_step(float(pl.float().abs().max()))


@pytest.mark.parametrize("layout", ["strided", "offset"])
def test_flash_backward_takes_a_dout_tma_cannot_read(dev, layout):
    """A ``dout`` whose head stride is not a multiple of 16 bytes, or whose
    base is not 16-byte aligned, is copied once (counted) and gives the
    gradients of a contiguous one, bit for bit."""
    case = (1, 130, 8, 2, 64, True, None)
    base = flash_inputs(case, torch.bfloat16, dev)
    o, lse = _cuda.run_flash(*base, True, None, lse=True)
    dout = torch.randn(o.shape, generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev).bfloat16()
    if layout == "strided":
        odd = torch.zeros((*o.shape[:3], 65), dtype=torch.bfloat16, device=dev)[..., :64]
    else:
        odd = torch.zeros(o.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(o.shape)
    odd.copy_(dout)
    _cuda.reset_launches()
    got = _cuda.run_flash_backward(*base, o, lse, odd, True, None)
    assert _cuda.FLASH_DOUT_COPIES["copies"] == 1
    want = _cuda.run_flash_backward(*base, o, lse, dout, True, None)
    assert _cuda.FLASH_DOUT_COPIES["copies"] == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# the gradient's cases beside RGLRU_CASES' first three: W not a multiple of
# a block's 32 lanes, with S one past a stage (33) and S ragged over
# several stages; W below a block's lanes; train_rg's microbatch
RGLRU_BACKWARD_CASES = RGLRU_CASES[:3] + [(1, 33, 4100), (3, 65, 36), (2, 2048, 4096)]


@pytest.mark.parametrize("case", RGLRU_BACKWARD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_rglru_scan_backward_matches_plain(dev, case):
    """The scan's gradient: one launch of the forward kernel and one of the
    gradient's kernel, da and dx bit-equal to the plain reverse loop on the
    card."""
    from repro_torch.kernels import rglru_scan as RS

    a, x = rglru_inputs(*case, dev)
    a.requires_grad_()
    x.requires_grad_()
    _cuda.reset_launches()
    h = RS.rglru_scan(a, x)
    dh = torch.randn(h.shape, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    da, dx = torch.autograd.grad(h, (a, x), dh)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["rglru_scan"] == 1 and _cuda.LAUNCHES["rglru_scan_backward"] == 1
    want_da, want_dx = RS.rglru_scan_backward_torch(a.detach(), h.detach(), dh)
    assert torch.equal(dx, want_dx) and torch.equal(da, want_da)


def test_rglru_scan_backward_graph_replay_equals_eager(dev):
    from repro_torch.kernels import rglru_scan as RS

    a, x = rglru_inputs(2, 100, 300, dev)
    h = RS.rglru_scan(a, x)
    dh = torch.randn(h.shape, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    eager = _cuda.run_rglru_scan_backward(a, h, dh)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _cuda.run_rglru_scan_backward(a, h, dh)
    assert (_cuda.LAUNCHES["rglru_scan_backward"] == 0
            and _cuda.CAPTURED["rglru_scan_backward"] == 1)
    for t in out:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(out, eager))


def test_rglru_scan_backward_refusals(dev):
    """What the gradient's kernel does not take raises before a launch: bf16,
    a non-contiguous input, tensors on two devices, shapes that differ, W
    not a multiple of 4 (TMA's 16-byte row stride) and a base not 16-byte
    aligned."""
    a, x = rglru_inputs(2, 16, 64, dev)
    h = x.clone()
    _cuda.reset_launches()
    with pytest.raises(ValueError, match="float32"):
        _cuda.run_rglru_scan_backward(a.bfloat16(), h.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.run_rglru_scan_backward(a, h, x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        _cuda.run_rglru_scan_backward(a, h, x.cpu())
    with pytest.raises(ValueError, match="one shape"):
        _cuda.run_rglru_scan_backward(a, h, x[:, :8].contiguous())
    odd = rglru_inputs(2, 16, 66, dev)[0]
    with pytest.raises(ValueError, match="multiple of 4"):
        _cuda.run_rglru_scan_backward(odd, odd, odd)
    shifted = torch.zeros(a.numel() + 1, device=dev)[1:].view(a.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _cuda.run_rglru_scan_backward(a, h, shifted)
    assert _cuda.LAUNCHES["rglru_scan_backward"] == 0


@pytest.mark.parametrize("arch", ["qwen3-8b", "recurrentgemma-9b", "qwen3-moe-235b-a22b",
                                  "seamless-m4t-medium"])
def test_train_step_on_the_card_matches_the_cpu(dev, arch):
    """One float32 train step of a smoke config from the same weights and
    batch, card against CPU: losses within 1e-5, ``grad_norm`` within 1e-4
    relative, the flash kernel launched twice per attention layer (the
    forward and the checkpointed group's recompute), its backward kernel
    once, never the MoE kernel."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import init_train_state

    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)}
    if cfg.is_encdec:
        batch["enc_embeds"] = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    host = build_model(cfg, device="cpu", seed=0, param_dtype="float32")
    card = build_model(cfg, device=dev, seed=None, param_dtype="float32")
    card.load_state_dict(host.state_dict())
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=4)
    out = {}
    for name, model, d in (("cpu", host, "cpu"), ("card", card, dev)):
        _cuda.reset_launches()
        step = make_train_step(model, opt, grad_accum=2)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        _, metrics = step(init_train_state(model), b)
        out[name] = {k: float(v) for k, v in metrics.items()}
        if name == "card":
            # a checkpointed layer's forward runs twice; the tail's once
            unchecked = (range(cfg.n_units * len(cfg.block_pattern), cfg.n_layers)
                         if not cfg.is_encdec else range(0))
            runs = sum((1 if i in unchecked else 2)
                       for i, layer in enumerate(model.layers)
                       if getattr(layer, "kind", "attn") in ("attn", "local", "moe"))
            runs += 2 * len(getattr(model, "enc_layers", []))
            assert _cuda.LAUNCHES["flash_attention"] == 2 * runs  # two microbatches
            # one gradient a layer and microbatch, from the last of its forwards
            attn = sum(getattr(layer, "kind", "attn") in ("attn", "local", "moe")
                       for layer in model.layers) + len(getattr(model, "enc_layers", []))
            assert _cuda.LAUNCHES["flash_attention_backward"] == 2 * attn
            assert _cuda.LAUNCHES["moe_ffn"] == 0
    assert abs(out["card"]["loss"] - out["cpu"]["loss"]) <= 1e-5
    assert abs(out["card"]["grad_norm"] - out["cpu"]["grad_norm"]) <= 1e-4 * out["cpu"]["grad_norm"]
