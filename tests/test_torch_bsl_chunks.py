"""BSL's wide-row chunk plan, checked without a card.

Rows wider than ``_cuda.DIRECT_ROW_WORDS`` take BSL's wide form
(``rm_project_bsl_wide_kernel``, ``csrc/rm_project.cu``): each column's word
range is cut into chunks (``_cuda.bsl_plan``, ``_cuda.bsl_chunk``), a block a
(row tile, chunk), a warp a (row, chunk) copied as one item of
``SPAN_VECS`` 16-byte vectors a lane.  Here, for odd column widths and
offsets, packed widths that are and are not a multiple of 4, and the
training record's rows of 4,101 / 8,197 words:

* every enabled word is in exactly one chunk, chunks in order and never
  empty, as many a column as the plan counts;
* every cut after a column's first lies on a 16-byte boundary of the
  packed row (of every row, where the packed width is a multiple of 4),
  and no chunk touches more than one item's vectors in any row;
* a numpy model of the wide launch (tiles of ``BSL_ROWS`` rows, chunks,
  rows) writes the plain projection, word for word, for row counts that are
  not a multiple of the tile;
* rows of at most ``DIRECT_ROW_WORDS`` keep today's grid: one block a
  column and tile, no chunks.

Everything is exact: word indices, no tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import TableGeometry  # noqa: E402
from repro_torch.data import RecordStore, synthetic_corpus  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels.common import column_slices  # noqa: E402

ITEM_VECS = 32 * _cuda.SPAN_VECS


def layouts():
    """(row_words, slices, out_w) cases: odd widths and offsets, gaps, packed
    widths of every value mod 4, one to five columns, past 2,048 words."""
    cases = []
    for r in range(4):
        for cols in (((r + 1, 2000),), ((r, 3), (r + 5, 2043)),
                     ((1, 1), (3, 700), (704 + r, 5), (712, 1000), (1713 + r, 333)),
                     ((r, 4097),), ((2, 1), (7 + r, 2047), (2100, 2))):
            row_words = max(o + w for o, w in cols) + 1 + r
            slices, dst = [], 0
            for o, w in cols:
                slices.append((o, dst, w))
                dst += w
            cases.append((max(row_words, _cuda.DIRECT_ROW_WORDS + 1 + r), tuple(slices), dst))
    return cases


def record_layout(seq):
    """A training record store's stored row width and its ``(tokens,
    labels)`` view's slices and packed width."""
    store = RecordStore(seq_len=seq, device="cpu")
    store.ingest(*synthetic_corpus(2, seq, 512, seed=1))
    g = store.project(("tokens", "labels")).geometry
    row_words = store.engine.device_words(store.table).shape[1]
    return row_words, tuple(column_slices(g)), g.out_words_per_row


@pytest.mark.parametrize("row_words,slices,out_w",
                         layouts() + [record_layout(2048), record_layout(4096)])
def test_chunks_cover_every_word_once(row_words, slices, out_w):
    chunk, counts = _cuda.bsl_plan(slices, row_words, out_w)
    assert chunk % 4 == 0 and chunk <= 4 * ITEM_VECS
    assert len(counts) == len(slices)
    for j, ((src, dst, w), count) in enumerate(zip(slices, counts)):
        end = 0
        for k in range(count):
            lo, hi = _cuda.bsl_chunk(dst, w, out_w, chunk, k)
            assert lo == end < hi <= w, (j, k, lo, hi)
            if k and out_w % 4 == 0:
                assert (dst + lo) % 4 == 0, (j, k)  # a 16-byte boundary of every row
            for row in range(4):  # every alignment of a row's start
                d0, d1 = row * out_w + dst + lo, row * out_w + dst + hi
                assert (d1 - 1) // 4 - d0 // 4 + 1 <= ITEM_VECS, (j, k, row)
            end = hi
        assert end == w


def test_record_rows_chunks():
    """The ``(tokens, labels)`` view of a training record: 4,101- and
    8,197-word rows, two columns of 2,048 / 4,096 words; 256-word chunks
    (the packed width is a multiple of 4), 8 / 16 a column and the labels'
    first cut one word in (they start a word past a 16-byte boundary)."""
    for seq, per_col in ((2048, 8), (4096, 16)):
        row_words, slices, out_w = record_layout(seq)
        assert row_words == {2048: 4101, 4096: 8197}[seq]
        chunk, counts = _cuda.bsl_plan(slices, row_words, out_w)
        assert chunk == 4 * ITEM_VECS == 256
        assert [s[2] for s in slices] == [seq, seq]
        assert counts == tuple(-(-(dst % 4 + seq) // chunk) for _, dst, _ in slices)
        assert counts == (per_col, per_col)


def model_wide(words, slices, out_w):
    """The wide launch in numpy: block (tile, chunk), warp (row, chunk)."""
    n, row_words = words.shape
    chunk, counts = _cuda.bsl_plan(slices, row_words, out_w)
    first, total = np.cumsum((0,) + counts)[:-1], sum(counts)
    out = np.full((n, out_w), -1, dtype=np.int64)
    for block in range(-(-n // _cuda.BSL_ROWS) * total):
        tile, c = divmod(block, total)
        j = max(i for i in range(len(slices)) if first[i] <= c)
        src, dst, w = slices[j]
        lo, hi = _cuda.bsl_chunk(dst, w, out_w, chunk, c - first[j])
        for row in range(tile * _cuda.BSL_ROWS, min(n, (tile + 1) * _cuda.BSL_ROWS)):
            assert (out[row, dst + lo:dst + hi] == -1).all()  # written once
            out[row, dst + lo:dst + hi] = words[row, src + lo:src + hi]
    return out


@pytest.mark.parametrize("n", [1, 255, 257, 300])
@pytest.mark.parametrize("case", [0, 5, 7, 13, 19], ids=str)
def test_model_of_the_wide_launch_is_the_plain_projection(case, n):
    row_words, slices, out_w = layouts()[case]
    rng = np.random.default_rng(case)
    words = rng.integers(-2**31, 2**31, (n, row_words), dtype=np.int64).astype(np.int32)
    g = TableGeometry(4 * row_words, n, tuple(4 * w for _, _, w in slices),
                      tuple(4 * (s - (slices[i - 1][0] if i else 0))
                            for i, (s, _, _) in enumerate(slices)))
    assert tuple(column_slices(g)) == slices
    want = K.project_torch(torch.from_numpy(words), g).numpy()
    assert np.array_equal(model_wide(words, slices, out_w), want)


def test_narrow_rows_keep_todays_grid():
    slices = ((0, 0, 1), (4, 1, 1), (8, 2, 1), (12, 3, 1))
    for row_words in (16, 512, _cuda.DIRECT_ROW_WORDS):
        assert _cuda.bsl_plan(slices, row_words, 4) == (0, (1, 1, 1, 1))
    assert _cuda.bsl_plan(((0, 0, 5),), _cuda.DIRECT_ROW_WORDS + 1, 5)[0] == 4 * ITEM_VECS - 4
