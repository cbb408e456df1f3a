"""The CUDA scan kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; without a card each one
skips (the fixture decides, never the import).  Run them on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.

Tolerances: packed blocks, masks and counts bit-equal; sums of int32 columns
within ±1000 exact (every partial stays below 2^24 in float32); sums of
float32 columns within ``1e-5 * sum(|v|)`` (summation order differs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import BatchExecutor, RelationalMemoryEngine, RelationalTable  # noqa: E402
from repro_torch.core.schema import Column, TableGeometry, TableSchema  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
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
