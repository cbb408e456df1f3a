"""The CUDA scan kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; without a card each one
skips (the fixture decides, never the import).  Run them on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.

Tolerances: packed blocks, masks and counts bit-equal; sums of int32 columns
within ±1000 exact (every partial stays below 2^24 in float32); sums of
float32 columns within ``1e-5 * sum(|v|)`` (summation order differs).
"""

import ctypes

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
    # 24 views of 30 words: more than MAX_REQ views and MAX_MAP words, so
    # the views split over launches as _cuda.split() groups them
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
    with pytest.raises(NotImplementedError):
        F.flash_attention(q.float().requires_grad_(), k.float(), v.float())
    assert _cuda.LAUNCHES["flash_attention"] == 3


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-27b", "qwen1.5-110b", "internlm2-20b"])
def test_smoke_prefill_on_the_card_matches_the_cpu(dev, arch):
    """A smoke decoder's prefill on the card launches the kernel once per
    layer; at float32 its logits and caches match the CPU model's within
    1e-4 (the kernel scales q in float32 where the CPU path scales it in the
    compute type: the same number at float32 compute), then one decode."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import DecoderLM

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    cpu = DecoderLM(cfg, device="cpu", seed=3)
    card = DecoderLM(cfg, device=dev, seed=None)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (2, 40)))
    _cuda.reset_launches()
    got, got_cache = card.prefill({"tokens": toks}, 48)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == cfg.n_layers
    want, want_cache = cpu.prefill({"tokens": toks}, 48)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for a, b in zip(got_cache, want_cache):
        torch.testing.assert_close(a["k"].cpu(), b["k"], rtol=1e-4, atol=1e-4)
    nxt = want.argmax(-1)[:, None]
    got, _ = card.decode_step(got_cache, nxt, 40)
    want, _ = cpu.decode_step(want_cache, nxt, 40)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert _cuda.LAUNCHES["flash_attention"] == cfg.n_layers  # decode: no kernel


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
    the capture only, 7 launches a layer: the capture launches nothing, the
    replays launch without the wrapper, and the prompts are long enough,
    2 × 33 rows and more, that no prefill's products take the kernel.  The
    capture records as many products as the warm-up launched, and the graph
    replays once a tick."""
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
    assert _cuda.LAUNCHES["w8_matmul"] == (7 * cfg.n_layers if int8 else 0)
    assert step.captured["w8_matmul"] == _cuda.LAUNCHES["w8_matmul"]
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
