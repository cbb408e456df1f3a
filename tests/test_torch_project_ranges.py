"""The wide-row projection's launch plan and copy schedule, checked without a card.

Rows wider than ``_cuda.DIRECT_ROW_WORDS`` are projected by
``rm_project_spans_kernel`` (``csrc/rm_spans.cu``), whose launch carries the
enabled columns as ``(src, dst, width)`` word ranges planned once per layout
(``_cuda.span_plan``).  Here:

* the plan, expanded word by word, is the geometry's word map — the port's
  ``geometry_words`` and the JAX package's ``column_slices`` alike — for
  random geometries (hypothesis, and seeded cases that need no hypothesis);
* :func:`schedule`, a numpy model of the kernel's copy (items, lanes,
  aligned source blocks, the shuffle from the next lane, the realignment,
  16-byte stores with word-by-word heads and tails), writes every output
  word exactly once from the right source word and loads no block outside
  the spans' cover — so nothing before the row store's first 16-byte block
  or past its last;
* the plan is cached on the layout (the row width and column ranges) and
  the storage width: a geometry that differs only in its row count (an
  append) finds the same plan.

Everything is exact: word indices and addresses, no tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.schema import TableGeometry as JGeometry  # noqa: E402
from repro.kernels.common import column_slices as jcolumn_slices  # noqa: E402
from repro_torch.core.schema import MAX_ENABLED_COLUMNS, TableGeometry  # noqa: E402
from repro_torch.data import RecordStore, synthetic_corpus  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import rme_project as R  # noqa: E402
from repro_torch.kernels.common import column_slices, geometry_words  # noqa: E402

MAX_WIDTH = 8192  # words: a training record's tokens and labels at S 4,096


def make_geometry(lead, widths, gaps, tail):
    """A geometry of ``len(widths)`` columns: the first at word ``lead``,
    ``gaps[j]`` words before column ``j + 1``, ``tail`` words after the last."""
    offsets, at = [], lead
    for j, w in enumerate(widths):
        offsets.append(at)
        at += w + (gaps[j] if j < len(gaps) else 0)
    row_words = offsets[-1] + widths[-1] + tail
    rel = [4 * offsets[0]] + [4 * (b - a) for a, b in zip(offsets, offsets[1:])]
    return TableGeometry(4 * row_words, 7, tuple(4 * w for w in widths), tuple(rel))


@st.composite
def geometries(draw):
    q = draw(st.integers(1, MAX_ENABLED_COLUMNS))
    width = st.one_of(st.integers(1, 9), st.integers(1, 64), st.integers(1, MAX_WIDTH))
    widths = draw(st.lists(width, min_size=q, max_size=q))
    gaps = draw(st.lists(st.integers(0, 7), min_size=q - 1, max_size=q - 1))
    return make_geometry(draw(st.integers(0, 7)), widths, gaps, draw(st.integers(0, 3)))


def expand(pl):
    """The plan's ranges, word by word: the source word of each packed word."""
    out = [None] * pl.out_w
    for src, dst, w in pl.spans:
        out[dst:dst + w] = range(src, src + w)
    return out


# seeded cases: (lead, widths, gaps, tail, extra storage words)
CASES = [
    (3, [2048, 2048], [0], 2, 0),  # a training record's (tokens, labels) at S 2,048
    (3, [4096, 4096], [0], 0, 2),  # at S 4,096, the two MVCC words beside
    (2, [1, 2048, 2048], [0, 0], 0, 2),  # (weight, tokens, labels): one range
    (0, [1], [], 0, 0),  # one word
    (1, [MAX_WIDTH], [], 3, 5),
    (5, [3, 1, 7, 2, 9, 4, 1, 1, 6, 2, 5], [1, 0, 2, 3, 0, 7, 1, 0, 2, 1], 1, 3),  # Q at the cap
    (2, [5, 4100, 3], [2, 1], 0, 1),
]


def case_geometry(case):
    lead, widths, gaps, tail, extra = case
    g = make_geometry(lead, widths, gaps, tail)
    return g, g.row_words + extra


def check_plan(g, row_words):
    pl = R.span_plan(g, row_words)
    assert expand(pl) == geometry_words(g)
    jg = JGeometry(g.row_bytes, g.row_count, g.col_widths, g.col_rel_offsets)
    assert tuple(map(tuple, jcolumn_slices(jg))) == column_slices(g)
    # the ranges are as few as the layout allows: none continues the one before
    assert 1 <= len(pl.spans) <= g.q
    for (s0, d0, w0), (s1, d1, _) in zip(pl.spans, pl.spans[1:]):
        assert d1 == d0 + w0 and s1 != s0 + w0
    check_blocks(pl, row_words, g.out_words_per_row)
    # a configuration port's columns are one launch
    assert len(pl.params) == 1
    return pl


def check_blocks(pl, row_words, out_w):
    """Every span gets items enough for its widest cover, MAX_SPANS spans a
    launch, and each launch's parameter block carries its part of the plan
    with the pointers and the row count left unset."""
    m, u = _cuda.MAX_SPANS, _cuda.SPAN_VECS
    assert len(pl.params) == len(pl.chunks) == -(-len(pl.spans) // m)
    for i, p in enumerate(pl.params):
        spans, first = pl.spans[i * m:(i + 1) * m], pl.first[i * m:(i + 1) * m]
        assert (p.row_words, p.out_w, p.n_spans, p.chunks) == (
            row_words, out_w, len(spans), pl.chunks[i])
        assert p.words is None and p.out is None and p.n == 0 and first[0] == 0
        for j, (src, dst, w) in enumerate(spans):
            assert (p.src[j], p.dst[j], p.width[j], p.first[j]) == (src, dst, w, first[j])
            items = (first[j + 1] if j + 1 < len(spans) else p.chunks) - first[j]
            n_vecs = _cuda.span_vectors(dst, w, out_w)
            assert items * 32 * u >= n_vecs > (items - 1) * 32 * u


@pytest.mark.parametrize("case", CASES)
def test_span_plan_expands_to_the_word_map(case):
    check_plan(*case_geometry(case))


@settings(max_examples=120, deadline=None, derandomize=True)
@given(g=geometries(), extra=st.integers(0, 5))
@example(g=make_geometry(3, [2048, 2048], [0], 2), extra=0)
def test_span_plan_expands_to_the_word_map_property(g, extra):
    """Random geometries: Q from 1 to the cap, gaps between columns, widths
    from 1 to 8,192 words, every source offset and row width mod 4, storage
    rows up to 5 words wider than the geometry."""
    check_plan(g, g.row_words + extra)


def test_span_plan_refuses_what_the_kernel_cannot_copy():
    with pytest.raises(ValueError, match="outside"):
        _cuda.span_plan(((10, 0, 4),), 12, 4)
    with pytest.raises(ValueError, match="unwritten"):
        _cuda.span_plan(((0, 0, 4), (6, 5, 2)), 12, 7)
    with pytest.raises(ValueError, match="overlap"):
        _cuda.span_plan(((0, 0, 4), (6, 3, 2)), 12, 5)
    with pytest.raises(ValueError, match="pack 4 words"):
        _cuda.span_plan(((0, 0, 4),), 12, 8)
    # ranges given out of packed order are planned in packed order
    pl = _cuda.span_plan(((8, 4, 2), (0, 0, 4)), 12, 6)
    assert pl.spans == ((0, 0, 4), (8, 4, 2))


# ---------------------------------------------------------- the kernel's copy
def schedule(pl, n, base):
    """Model ``rm_project_spans_kernel`` over ``n`` rows of a row store whose
    first word lies at word address ``base``, launch by launch from the
    parameter blocks the launches carry, step for step as the kernel
    computes it; returns ``(dst_words, src_words, loaded_blocks)``: the
    output word and source word address of every word stored, and the word
    address of every 16-byte block loaded.  Raises AssertionError where a
    stored word would come from a block no lane loaded."""
    dst_words, src_words, loaded = [], [], []
    for p in pl.params:
        u, chunks = _cuda.SPAN_VECS, p.chunks
        first = np.array(p.first[:p.n_spans], dtype=np.int64)
        src, dst, width = (np.array(x[:p.n_spans], dtype=np.int64)
                           for x in (p.src, p.dst, p.width))
        items = np.arange(n * chunks, dtype=np.int64)
        row, c = items // chunks, items % chunks
        k = np.zeros_like(items)  # the kernel's search: the last span whose first item <= c
        step = _cuda.MAX_SPANS // 2
        while step:
            cand = k + step
            ok = cand < p.n_spans
            ok[ok] = first[cand[ok]] <= c[ok]
            k = np.where(ok, cand, k)
            step //= 2
        d0 = row * p.out_w + dst[k]
        d1 = d0 + width[k]
        s0 = base + row * p.row_words + src[k]
        s1 = s0 + width[k]
        delta = s0 - d0
        shift = delta & 3
        lane = np.arange(32, dtype=np.int64)
        j = np.arange(u, dtype=np.int64)
        vd0 = (((d0 >> 2) + (c - first[k]) * 32 * u)[:, None] + lane) << 2  # (items, 32)
        a0 = vd0 + (delta - shift)[:, None]
        vd = vd0[:, None, :] + 128 * j[None, :, None]  # (items, u, 32)
        a = a0[:, None, :] + 128 * j[None, :, None]
        col = lambda x: x[:, None, None]  # noqa: E731
        lo_loaded = (a + 4 > col(s0)) & (a < col(s1))
        tail = a0[:, 31] + 128 * (u - 1) + 4
        tail_loaded = (shift != 0) & (tail + 4 > s0) & (tail < s1)
        # the block above each lane's: the next lane's; lane 31's, lane 0's
        # next vector, or its own tail load after the last
        hi = np.concatenate([a[:, :, 1:], np.empty_like(a[:, :, :1])], axis=2)
        hi_loaded = np.concatenate([lo_loaded[:, :, 1:], np.empty_like(lo_loaded[:, :, :1])],
                                   axis=2)
        hi[:, :-1, 31], hi_loaded[:, :-1, 31] = a[:, 1:, 0], lo_loaded[:, 1:, 0]
        hi[:, -1, 31], hi_loaded[:, -1, 31] = tail, tail_loaded
        assert np.all(hi == a + 4)
        for q in range(4):
            word = vd + q
            stored = (word >= col(d0)) & (word < col(d1))
            from_hi = col(shift) + q >= 4
            block = np.where(from_hi, hi, a)
            assert np.all(np.where(from_hi, hi_loaded, lo_loaded)[stored]), \
                "a word from an unloaded block"
            dst_words.append(word[stored])
            src_words.append((block + (col(shift) + q) % 4)[stored])
        loaded += [a[lo_loaded], tail[tail_loaded]]
    return np.concatenate(dst_words), np.concatenate(src_words), np.concatenate(loaded)


def check_schedule(slices, row_words, out_w, n, base):
    pl = _cuda.span_plan(slices, row_words, out_w)
    dst_words, src_words, loaded = schedule(pl, n, base)
    # every output word written exactly once
    assert np.array_equal(np.bincount(dst_words, minlength=n * out_w), np.ones(n * out_w))
    # ... from the right word of the right row
    gw = np.array(expand(pl), dtype=np.int64)
    assert gw.tolist() == [w for s, _, n_w in sorted(slices, key=lambda sl: sl[1])
                           for w in range(s, s + n_w)]
    want = base + dst_words // out_w * row_words + gw[dst_words % out_w]
    assert np.array_equal(src_words, want)
    # every block loaded holds a word some span copies, so none lies before
    # the row store's first block or past its last (the last row's clamp)
    assert np.all(loaded % 4 == 0)
    assert loaded.min() >= base // 4 * 4
    assert loaded.max() <= (base + n * row_words - 1) // 4 * 4
    enabled = np.zeros(row_words, dtype=bool)
    enabled[gw] = True
    rel = loaded[:, None] + np.arange(4) - base
    inside = (rel >= 0) & (rel < n * row_words)
    holds = np.zeros(rel.shape, dtype=bool)
    holds[inside] = enabled[rel[inside] % row_words]
    assert holds.any(axis=1).all()


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("case", CASES[:3] + CASES[5:])
def test_copy_schedule_writes_each_word_once(case, base, n):
    """The training records and mixed layouts, from a row store starting at
    each word of a 16-byte block: 1, 2 and 5 rows."""
    g, row_words = case_geometry(case)
    check_schedule(column_slices(g), row_words, g.out_words_per_row, n, base)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(g=geometries(), extra=st.integers(0, 5), n=st.integers(1, 4), base=st.integers(0, 7))
def test_copy_schedule_writes_each_word_once_property(g, extra, n, base):
    check_schedule(column_slices(g), g.row_words + extra, g.out_words_per_row, n, base)


@pytest.mark.parametrize("n_spans", [_cuda.MAX_SPANS, _cuda.MAX_SPANS + 1, 37])
def test_more_ranges_than_a_launch_carries(n_spans):
    """A union of more separate ranges than one parameter block holds (a
    geometry past the configuration port's cap) is cut into launches of
    MAX_SPANS ranges, each planned from item 0 of its row; together they
    write every word once, from the right source word."""
    widths = [1 + 97 * j % 300 for j in range(n_spans)]
    slices, src, dst = [], 1, 0
    for w in widths:
        slices.append((src, dst, w))
        src, dst = src + w + 1 + dst % 3, dst + w
    row_words = src + 2
    pl = _cuda.span_plan(tuple(slices), row_words, dst)
    assert len(pl.spans) == n_spans
    check_blocks(pl, row_words, dst)
    for base, n in ((0, 3), (3, 2)):
        check_schedule(tuple(slices), row_words, dst, n, base)


def test_span_plan_cached_across_an_append():
    """A record store's view before and after an append: a new row count,
    the same plan object, found in the cache; the key holds the layout and
    the storage width only (no row count, snapshot time or predicate
    constant)."""
    store = RecordStore(seq_len=64, device="cpu")
    store.ingest(*synthetic_corpus(5, 64, 1000, seed=1))
    before = store.project(("tokens", "labels"), store.table.now()).geometry
    row_words = store.engine.device_words(store.table).shape[1]
    pl = R.span_plan(before, row_words)
    hits = R._layout_plan.cache_info().hits
    store.ingest(*synthetic_corpus(3, 64, 1000, seed=2))
    after = store.project(("tokens", "labels"), store.table.now()).geometry
    assert after.row_count != before.row_count and after.layout_key() == before.layout_key()
    assert R.span_plan(after, row_words) is pl
    assert R._layout_plan.cache_info().hits == hits + 1
    assert pl.spans == ((3, 0, 128),) and pl.row_words == row_words == 64 * 2 + 5
