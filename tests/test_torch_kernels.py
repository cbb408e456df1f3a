"""Kernel parity: the port's CPU kernels against the JAX package's, on CPU.

The same seeded numpy words go through each JAX kernel (Pallas, in interpret
mode, as the JAX tests run it) and through the port's function of the same
contract, which on a CPU tensor runs its plain PyTorch version.  The CUDA
kernels themselves are held against those plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: packed blocks, masks and counts bit-equal; sums over int32
columns within ±1000 exact (every partial stays below 2^24 in float32); sums
over float32 columns ``rtol=1e-5`` (summation order differs).
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import schema as jschema  # noqa: E402
from repro.core.table import RelationalTable as JTable  # noqa: E402
from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import rme_scan_multi as JR  # noqa: E402
from repro_torch.core import schema as tschema  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import rme_scan_multi as TR  # noqa: E402

I32 = np.iinfo(np.int32)
N = 777  # deliberately not a multiple of the 256-row tile

# (name, dtype, width): multi-word char columns and float32 beside int32
MIXED = [("k", "int32", None), ("name", "char", 12), ("f", "float32", None),
         ("g", "int32", None), ("x", "float32", None), ("tag", "char", 8),
         ("v", "int32", None)]


def bench_cols():
    return [(f"A{i + 1}", "int32", None) for i in range(16)]


def make_words(spec, n=N, seed=0):
    """Storage words (user columns + MVCC) of a JAX table over ``spec``:
    ints in [-1000, 1000), float32 normals, random chars; int32 extremes in
    the first rows of every int column (group keys included); a third of
    the rows deleted so the MVCC words vary."""
    rng = np.random.default_rng(seed)
    schema = jschema.TableSchema.of(*[jschema.Column(*c) for c in spec])
    cols = {}
    for name, dtype, width in spec:
        if dtype == "int32":
            v = rng.integers(-1000, 1000, n).astype(np.int32)
            v[:3] = [I32.min, -1, I32.max]
        elif dtype == "float32":
            v = rng.normal(0, 50, n).astype(np.float32)
        else:
            v = rng.integers(65, 91, (n, width)).astype(np.uint8).view(
                np.dtype((np.bytes_, width))).reshape(n)
        cols[name] = v
    t = JTable.from_columns(schema, cols)
    t.append({k: v[:40] for k, v in cols.items()})
    t.delete(rng.choice(t.row_count, t.row_count // 3, replace=False))
    return schema, t.words().copy(), t.now()


def geoms(schema, names):
    """The same geometry in both packages."""
    jg = jschema.TableGeometry.from_schema(schema, names, row_count=0)
    tg = tschema.TableGeometry(jg.row_bytes, jg.row_count, jg.col_widths,
                               jg.col_rel_offsets)
    return jg, tg


def to_np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def assert_sums(got, want, dtype):
    got, want = to_np(got), to_np(want)
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module")
def bench():
    return make_words(bench_cols())


@pytest.fixture(scope="module")
def mixed():
    return make_words(MIXED, seed=1)


def tame(words, *int_words):
    """Zero the int32 extremes in the summed columns, so int32 sums stay
    within ±1000 per row and exact in float32."""
    words = words.copy()
    for w in int_words:
        words[np.abs(words[:, w].astype(np.int64)) > 1000, w] = 0
    return words


def views(data, mvcc):
    """(numpy words, ts_word, ts): storage words with the MVCC words, or the
    user words alone."""
    schema, words, now = data
    if mvcc:
        return words, schema.row_words, now - 2
    return np.ascontiguousarray(words[:, : schema.row_words]), -1, 0


# --------------------------------------------------------------- helpers
def test_group_ids_floored_modulo_matches_jax():
    keys = np.array([I32.min, -1, I32.max, 0, 7, -7, -8, 123456], np.int32)
    for g in (1, 7, 1000):
        np.testing.assert_array_equal(
            tcommon.group_ids(torch.from_numpy(keys), g).numpy(),
            np.asarray(jcommon.group_ids(jnp.asarray(keys), g)))


@pytest.mark.parametrize("k,dtype", [(2.7, "int32"), (-2.7, "int32"), (5, "int32"),
                                     (2.7, "float32"), (-1, "float32"),
                                     (I32.max, "int32"), (I32.min, "int32")])
def test_pred_k_bits_matches_jax(k, dtype):
    assert tcommon.pred_k_bits(k, dtype) == int(jcommon.pred_k_bits(k, dtype))


# ------------------------------------------------------- single-op kernels
@pytest.mark.parametrize("which", ["bench", "mixed"])
def test_project_matches_jax(which, bench, mixed):
    data = bench if which == "bench" else mixed
    schema = data[0]
    names = (["A1", "A5", "A9", "A13"] if which == "bench"
             else ["name", "f", "tag", "v"])
    jg, tg = geoms(schema, names)
    words = data[1]
    want = JK.project(jnp.asarray(words), jg, interpret=True)
    got = TK.project(torch.from_numpy(words), tg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pred_op", ["gt", "lt", "none"])
@pytest.mark.parametrize("mvcc", [False, True])
@pytest.mark.parametrize("pred", [("g", 5), ("f", -3.25), ("v", 2.7)])
def test_filter_matches_jax(mixed, pred_op, mvcc, pred):
    schema = mixed[0]
    words, ts_word, ts = views(mixed, mvcc)
    col, k = pred
    args = dict(pred_word=schema.word_offset(col),
                pred_dtype=schema.column(col).dtype, pred_op=pred_op, pred_k=k,
                ts=ts, ts_word=ts_word)
    jg, tg = geoms(schema, ["k", "name", "x"])
    jp, jm = JK.filter_project(jnp.asarray(words), jg, interpret=True, **args)
    tp, tm = TK.filter_project(torch.from_numpy(words), tg, **args)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("agg", ["v", "f"])
@pytest.mark.parametrize("mvcc", [False, True])
@pytest.mark.parametrize("pred_op", ["gt", "lt", "none"])
def test_aggregate_matches_jax(mixed, agg, mvcc, pred_op):
    schema = mixed[0]
    words, ts_word, ts = views(mixed, mvcc)
    words = tame(words, schema.word_offset("v"))
    dtype = schema.column(agg).dtype
    args = dict(agg_word=schema.word_offset(agg), agg_dtype=dtype,
                pred_word=schema.word_offset("k"), pred_op=pred_op,
                pred_k=-100, ts=ts, ts_word=ts_word)
    want = np.asarray(JK.aggregate(jnp.asarray(words), interpret=True, **args))
    got = TK.aggregate(torch.from_numpy(words), **args)
    assert got.dtype == torch.float32 and got.shape == (2,)
    assert got[1].item() == want[1]
    assert_sums(got[0], want[0], dtype)


@pytest.mark.parametrize("num_groups", [1, 7, 1000])
@pytest.mark.parametrize("mvcc", [False, True])
def test_groupby_matches_jax(bench, num_groups, mvcc):
    schema = bench[0]
    words, ts_word, ts = views(bench, mvcc)
    # group on A1 (carries INT32_MIN, -1, INT32_MAX); sum A2
    words = tame(words, 1)
    args = dict(group_word=0, agg_word=1, num_groups=num_groups,
                pred_word=2, pred_op="gt", pred_k=-500, ts=ts, ts_word=ts_word)
    js, jc = JK.groupby_sum(jnp.asarray(words), interpret=True, **args)
    ts_, tc = TK.groupby_sum(torch.from_numpy(words), **args)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js))


# ----------------------------------------------------------- fused scan
def fused_requests(pkg, schema, tg_or_jg, ts_word, ts):
    """A mixed R=4 batch plus a duplicate, in one package's request types."""
    return [
        pkg.ProjectRequest(tg_or_jg[0]),
        pkg.FilterRequest(tg_or_jg[1], pred_word=schema.word_offset("g"),
                          pred_op="lt", pred_k=10, ts_word=ts_word, ts=ts),
        pkg.AggregateRequest(agg_word=schema.word_offset("f"),
                             agg_dtype="float32",
                             pred_word=schema.word_offset("x"),
                             pred_dtype="float32", pred_op="gt", pred_k=0.5,
                             ts_word=ts_word, ts=ts),
        pkg.GroupByRequest(group_word=schema.word_offset("g"),
                           agg_word=schema.word_offset("v"), num_groups=7,
                           ts_word=ts_word, ts=ts),
        pkg.ProjectRequest(tg_or_jg[0]),
    ]


@pytest.mark.parametrize("mvcc", [False, True])
def test_scan_multi_matches_jax(mixed, mvcc):
    schema = mixed[0]
    words, ts_word, ts = views(mixed, mvcc)
    words = tame(words, schema.word_offset("v"))
    (jg1, tg1), (jg2, tg2) = geoms(schema, ["k", "name", "v"]), geoms(schema, ["tag", "x"])
    jreqs = fused_requests(JR, schema, (jg1, jg2), ts_word, ts)
    treqs = fused_requests(TR, schema, (tg1, tg2), ts_word, ts)
    want = JK.scan_multi(jnp.asarray(words), jreqs, interpret=True)
    got = TK.scan_multi(torch.from_numpy(words), treqs)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1][0]))
    np.testing.assert_array_equal(got[1][1].numpy(), np.asarray(want[1][1]))
    assert got[2][1].item() == np.asarray(want[2])[1]
    assert_sums(got[2][0], np.asarray(want[2])[0], "float32")
    np.testing.assert_array_equal(got[3][1].numpy(), np.asarray(want[3][1]))
    np.testing.assert_array_equal(got[3][0].numpy(), np.asarray(want[3][0]))


def test_request_accounting_matches_jax(mixed):
    schema = mixed[0]
    (jg1, tg1), (jg2, tg2) = geoms(schema, ["k", "name", "v"]), geoms(schema, ["tag", "x"])
    jreqs = fused_requests(JR, schema, (jg1, jg2), schema.row_words, 5)
    treqs = fused_requests(TR, schema, (tg1, tg2), schema.row_words, 5)
    row_bytes = (schema.row_words + 2) * 4
    for jr, tr in zip(jreqs, treqs):
        assert JR.request_intervals(jr) == TR.request_intervals(tr)
        assert JR.reduced_result_bytes(jr) == TR.reduced_result_bytes(tr)
        assert (JR.scan_vmem_footprint_bytes([jr], schema.row_words + 2)
                == TR.scan_vmem_footprint_bytes([tr], schema.row_words + 2))
    ju = JR.union_geometry(jreqs, row_bytes, 999)
    tu = TR.union_geometry(treqs, row_bytes, 999)
    assert dataclasses_tuple(ju) == dataclasses_tuple(tu)


def dataclasses_tuple(g):
    return (g.row_bytes, g.row_count, g.col_widths, g.col_rel_offsets, g.frame,
            g.max_columns)


def test_combine_chunk_outputs_matches_jax(mixed):
    schema = mixed[0]
    words = tame(mixed[1], schema.word_offset("v"))
    (jg1, tg1), (jg2, tg2) = geoms(schema, ["k", "name", "v"]), geoms(schema, ["tag", "x"])
    jreqs = fused_requests(JR, schema, (jg1, jg2), schema.row_words, mixed[2])
    treqs = fused_requests(TR, schema, (tg1, tg2), schema.row_words, mixed[2])
    cuts = [0, 300, 301, len(words)]  # chunks of 300, 1 and the rest
    jparts = [JR.scan_multi_xla(jnp.asarray(words[a:b]), tuple(jreqs))
              for a, b in zip(cuts, cuts[1:])]
    tparts = [TR.scan_multi_torch(torch.from_numpy(words[a:b]), treqs)
              for a, b in zip(cuts, cuts[1:])]
    for r, (jr, tr) in enumerate(zip(jreqs, treqs)):
        want = JR.combine_chunk_outputs(jr, [p[r] for p in jparts])
        got = TR.combine_chunk_outputs(tr, [p[r] for p in tparts])
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if g.dtype == torch.float32 and isinstance(jr, JR.AggregateRequest):
                assert_sums(g, w, "float32")
            else:
                np.testing.assert_array_equal(to_np(g), np.asarray(w))


# ------------------------------------------------------ CUDA launch plans
def test_launch_plan_layout():
    """The launch planning the CUDA path runs, checked without a card."""
    proj = _cuda.KernelReq(_cuda.PROJECT, (0, 4, 8, 12))
    agg = _cuda.KernelReq(_cuda.AGGREGATE, agg_word=1, pred_op="gt", pred_word=2)
    small = _cuda.KernelReq(_cuda.GROUPBY, agg_word=1, group_word=3, num_groups=16)
    big = _cuda.KernelReq(_cuda.GROUPBY, agg_word=1, group_word=3, num_groups=20000)
    pl = _cuda.plan([proj, agg, small, big, agg], row_words=18)
    assert pl.tile_rows == 256 and pl.map == [0, 4, 8, 12]
    assert pl.red_off == [-1, 0, 2, 34, 40034] and pl.part_w == 40036
    assert pl.slot == [-1, 0, -1, -1, 1] and pl.n_slots == 2
    # the 16-group histogram fits shared memory, the 20000-group one does not
    assert pl.hist_off[2] >= pl.slot_smem + 2 * 2 * _cuda.THREADS
    assert pl.hist_off[3] == -1
    assert pl.smem_bytes <= _cuda.SMEM_MAX and pl.map_smem % 4 == 0
    # wide rows stage fewer rows per tile, always a multiple of 4
    assert _cuda.tile_rows(18) == 256 and _cuda.tile_rows(300) == 16
    assert _cuda.tile_rows(5000) == 4
    # more requests than one launch carries split into launches
    assert [len(g) for g in _cuda.split([proj] * 20)] == [16, 4]
    with pytest.raises(ValueError, match="outside"):
        _cuda.plan([_cuda.KernelReq(_cuda.PROJECT, (18,))], row_words=18)


def path_kernel_requests():
    """The five requests the engine's mixed batch lowers to (the fused scan
    of the server's tick C and of chip_smoke.py's kernel line)."""
    words = lambda *ws: tuple(ws)  # noqa: E731
    return [
        _cuda.KernelReq(_cuda.PROJECT, words(0, 4, 8, 12)),
        _cuda.KernelReq(_cuda.FILTER, words(1, 2), pred_word=3, pred_op="gt",
                        ts_word=16, ts=1),
        _cuda.KernelReq(_cuda.AGGREGATE, agg_word=6, pred_word=5, pred_op="lt",
                        k_bits=100, ts_word=16, ts=1),
        _cuda.KernelReq(_cuda.GROUPBY, agg_word=7, group_word=15, num_groups=16,
                        ts_word=16, ts=1),
        _cuda.KernelReq(_cuda.AGGREGATE, agg_word=9, pred_word=8, pred_op="gt",
                        k_bits=-500, ts_word=16, ts=1),
    ]


@pytest.mark.parametrize("which", ["path", "sixteen"])
def test_scan_ring_layout_fits(which):
    """scan_multi's ring of tiles: every tile 16-byte aligned and whole, the
    map, slots and histograms after the ring, all within SMEM_MAX — for the
    path's five requests and for 16 requests at 18-word rows."""
    reqs = path_kernel_requests()
    if which == "sixteen":
        reqs = (reqs * 4)[:16]
    stages = _cuda.SCAN_RING
    pl = _cuda.plan(reqs, 18, stages)
    tile_words = pl.tile_rows * 18
    assert stages == 2 and pl.tile_stride >= tile_words
    assert pl.tile_stride % 4 == 0 and pl.map_smem == stages * pl.tile_stride
    assert pl.slot_smem >= pl.map_smem + len(pl.map) and pl.slot_smem % 4 == 0
    hists = [h for h in pl.hist_off if h >= 0]
    assert hists and min(hists) >= pl.slot_smem + 2 * pl.n_slots * _cuda.THREADS
    assert pl.smem_bytes <= _cuda.SMEM_MAX
    # the parameter block carries the plan; pointers and N are left for the
    # launch
    (group, planned, params), = _cuda.launch_groups(reqs, 18, stages)
    assert group == list(range(len(reqs))) and planned == pl
    assert (params.tile_stride, params.map_smem, params.slot_smem) == \
        (pl.tile_stride, pl.map_smem, pl.slot_smem)
    assert (params.n_req, params.part_w, params.n) == (len(reqs), pl.part_w, 0)
    assert list(params.map[: len(pl.map)]) == pl.map
    assert [params.req[j].hist_off for j in group] == pl.hist_off
    assert [params.req[j].kind for j in group] == [r.kind for r in reqs]
    assert not any(params.req[j].out or params.req[j].mask for j in group)
    # the single-request kernels keep one tile
    one = _cuda.plan(reqs[:1], 18)
    assert one.map_smem == one.tile_stride
    # rows so wide that the ring would pass SMEM_MAX are refused
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.plan(reqs, 7200, _cuda.SCAN_RING)


@pytest.mark.parametrize("n,row_words,buckets,cap,stream", [
    (33_554_432, 18, 65_536, 18, 1),  # the server's row-store probe
    (33_554_432, 2, 65_536, 18, 0),  # the packed {A1, A2} block
    (1037, 40, 2, 1, 1),  # C = 1 on P = 2
    (1037, 8, 2, 1, 0),  # 32-byte rows: still the dense form
    (1 << 29, 32, 1 << 20, 47, 1),  # the grid's cap, C > 32: two fingerprint lines
])
def test_join_launch_geometry(n, row_words, buckets, cap, stream):
    """The probe's parameter block and grid, computed as rm_join.cu expects,
    without loading the library: the Fibonacci shift, 32 8-bit fingerprints
    per 32 slots, a block of 8 warps per 256 rows, and the streaming form
    for rows wider than a 32-byte sector."""
    params, n_blocks = _cuda.join_launch(n, row_words, buckets, cap, 1, 0, 16, 7, True)
    assert ctypes.sizeof(params) == 128  # sizeof(JoinParams) on x86-64
    assert (params.n, params.row_words, params.cap) == (n, row_words, cap)
    assert (params.key_word, params.val_word, params.ts_word, params.ts,
            params.build_ts) == (1, 0, 16, 7, 1)
    assert 1 << (32 - params.shift) == buckets
    assert params.fp_stride % 32 == 0 and 0 <= params.fp_stride - cap < 32
    assert params.stream == stream
    assert _cuda.JOIN_THREADS % 32 == 0
    assert n_blocks == min(-(-n // _cuda.JOIN_THREADS), _cuda.MAX_GRID_BLOCKS)
    assert params.words is params.fps is params.recs is None  # filled at launch


@pytest.mark.parametrize("m,k,n,form", [
    (8, 4096, 4096, "tensor"), (8, 4096, 1024, "tensor"), (8, 4096, 12288, "tensor"),
    (8, 12288, 4096, "tensor"), (1, 129, 72, "cuda_cores"), (64, 1100, 528, "tensor"),
    (8, 300, 1000, "cuda_cores"), (3, 20000, 64, "tensor"),
])
def test_w8_launch_geometry(m, k, n, form):
    """The W8 kernel's form and grid, as rm_w8.cu expects them, without the
    library: chunks of K that are multiples of 128 rows, at most 1,024 (the
    staged x), covering K in ``splits`` blocks; three to four blocks an SM on
    a 132-SM card where K allows; the ctypes block the C struct's size."""
    dtype = torch.bfloat16
    assert _cuda.w8_form(dtype, n, 0, 0) == form
    assert _cuda.w8_form(torch.float32, n, 0, 0) != "tensor"
    assert _cuda.w8_form(torch.bfloat16, n, 8, 0) != "tensor"  # q not 16-byte aligned
    strips, splits, m_tiles, chunk = _cuda.w8_launch(m, k, n, 132, form)
    strip = 128 if form == "tensor" else 256
    assert strips == -(-n // strip) and m_tiles == -(-m // 8)
    assert chunk % 128 == 0 and 128 <= chunk <= 1024
    assert splits == -(-k // chunk) and (splits - 1) * chunk < k
    blocks = strips * splits * m_tiles
    assert blocks >= 3 * 132 or chunk == 128  # the 128-row floor on chunks
    assert ctypes.sizeof(_cuda._W8Params) == 72  # sizeof(W8Params) on x86-64


def test_cuda_path_refuses_cpu_and_unported_revisions():
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.check_words(torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="plain PyTorch versions"):
        TK.check_revision("xla")
    for revision in TK.REVISIONS:
        TK.check_revision(revision)
