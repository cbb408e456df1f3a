"""PCK's wide-row plan, checked without a card.

Rows wider than ``_cuda.DIRECT_ROW_WORDS`` take PCK's wide form
(``rm_project_pck_wide_kernel``, ``csrc/rm_project.cu``): the work is
(row tile, packed range) items (``_cuda.pck_plan``), each gathered column by
column into a packer in shared memory with ``rm_copy.cuh``'s 16-byte
vectors, a warp an item of a (column piece, row), then stored a packed row
range at a time.  Here, for odd column widths and offsets, packed widths of
every value mod 4, and the training record's rows of 4,101 / 8,197 words:

* the plan's ranges are multiples of 4 words that tile the packed row, its
  two packers fit shared memory several times over, and its items outnumber
  the card's SMs at the record store's size;
* a numpy model of the launch — items, pieces, the warps' units and their
  16-byte packer vectors, the stores — writes every packed word once, from
  its source word, for row counts that are not a multiple of the tile, and
  equals the plain projection;
* rows of at most ``DIRECT_ROW_WORDS`` keep ``pck_packer``'s plan (no
  ranges).

Everything is exact: word indices, no tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import TableGeometry  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels.common import column_slices  # noqa: E402

from test_torch_bsl_chunks import layouts, record_layout  # noqa: E402

ITEM_VECS = 32 * _cuda.SPAN_VECS
WARPS = _cuda.THREADS // 32


def range_pieces(slices, w0, width):
    """The pieces of packed words ``[w0, w0 + width)`` in the order the wide
    kernel gathers them, one a column that crosses them: ``(column, lo,
    hi)``, packed words ``[lo, hi)`` of the column at ``slices[column]``."""
    pieces = []
    for j, (_, dst, w) in enumerate(slices):
        lo, hi = max(dst, w0), min(dst + w, w0 + width)
        if lo < hi:
            pieces.append((j, lo, hi))
    return pieces


def wide_params(row_words, slices, out_w):
    return _cuda.column_params("project_pck", tuple(slices), row_words, out_w)


@pytest.mark.parametrize("row_words,slices,out_w",
                         layouts() + [record_layout(2048), record_layout(4096)])
def test_plan_ranges_tile_the_packed_row(row_words, slices, out_w):
    rows, range_w, ranges = _cuda.pck_plan(out_w)
    assert range_w % 4 == 0 and 0 < range_w <= _cuda.PCK_RANGE_WORDS
    assert (ranges - 1) * range_w < out_w <= ranges * range_w
    assert 1 <= rows <= _cuda.THREADS and 4 * rows * range_w <= _cuda.PCK_PACKER_BYTES
    assert 4 * _cuda.PCK_PACKERS * rows * range_w * 4 <= _cuda.SMEM_MAX  # 4 blocks an SM
    params = wide_params(row_words, slices, out_w)
    assert (params.tile_rows, params.range_w, params.chunks) == (rows, range_w, ranges)
    covered = np.zeros(out_w, dtype=int)
    for k in range(ranges):
        w0 = k * range_w
        width = min(range_w, out_w - w0)
        for j, lo, hi in range_pieces(slices, w0, width):
            assert w0 <= lo < hi <= w0 + width
            covered[lo:hi] += 1
    assert (covered == 1).all()  # the slices tile the packed row


def test_record_rows_plan():
    """The ``(tokens, labels)`` view of a training record (4,096 / 8,192
    packed words): ranges of 1,024 words (4 KB a row), 4 rows a tile (a
    16 KB packer), 4 / 8 ranges a tile, one column a range; at the record
    store's 4,096 rows the items far outnumber 132 SMs."""
    for seq, ranges in ((2048, 4), (4096, 8)):
        row_words, slices, out_w = record_layout(seq)
        assert _cuda.pck_plan(out_w) == (4, 1024, ranges)
        for k in range(ranges):
            assert len(range_pieces(slices, 1024 * k, 1024)) == 1
        assert -(-4096 // 4) * ranges >= 8 * 132


def span_items(d0, d1):
    """``rm_copy::items``: a warp item's 16-byte vectors touching [d0, d1)."""
    return ((d1 - 1) // 4 - d0 // 4) // ITEM_VECS + 1


def model_wide(words, slices, out_w, grid):
    """The wide launch in numpy: block b walks items b, b + grid, ...; an
    item's pieces are dealt to the warps in units (item c, row r), each unit
    writing the packer's 16-byte vectors that hold its piece's words."""
    n, row_words = words.shape
    rows_t, range_w, ranges = _cuda.pck_plan(out_w)
    n_items = -(-n // rows_t) * ranges
    out = np.full((n, out_w), -1, dtype=np.int64)
    for block in range(grid):
        for item in range(block, n_items, grid):
            tile, k = divmod(item, ranges)
            w0 = k * range_w
            width = min(range_w, out_w - w0)
            row0 = tile * rows_t
            rows = min(rows_t, n - row0)
            packer = np.full((rows_t, range_w), -1, dtype=np.int64)
            dealt = 0
            for j, lo, hi in range_pieces(slices, w0, width):
                src, dst, _ = slices[j]
                d0, d1 = lo - w0, hi - w0
                units = span_items(d0, d1) * rows
                warps = set()
                for u in range(units):
                    warps.add((dealt + u) % WARPS)
                    r, c = u % rows, u // rows
                    v0 = d0 // 4 + c * ITEM_VECS  # the unit's first vector in row r
                    for vd in range(4 * v0, 4 * (v0 + ITEM_VECS)):
                        if d0 <= vd < d1:
                            assert packer[r, vd] == -1  # written once
                            packer[r, vd] = words[row0 + r, src + lo - dst + vd - d0]
                assert len(warps) == min(WARPS, units)  # dealt in turn
                dealt += units
            for r in range(rows):
                assert (packer[r, :width] != -1).all()  # the range fully gathered
                assert (out[row0 + r, w0:w0 + width] == -1).all()  # stored once
                out[row0 + r, w0:w0 + width] = packer[r, :width]
    return out


@pytest.mark.parametrize("n,grid", [(1, 3), (3, 132), (5, 7), (9, 2), (13, 1000)])
@pytest.mark.parametrize("case", [0, 1, 2, 5, 7, 13, 19], ids=str)
def test_model_of_the_wide_launch_is_the_plain_projection(case, n, grid):
    row_words, slices, out_w = layouts()[case]
    rng = np.random.default_rng(case)
    words = rng.integers(-2**31, 2**31, (n, row_words), dtype=np.int64).astype(np.int32)
    g = TableGeometry(4 * row_words, n, tuple(4 * w for _, _, w in slices),
                      tuple(4 * (s - (slices[i - 1][0] if i else 0))
                            for i, (s, _, _) in enumerate(slices)))
    assert tuple(column_slices(g)) == slices
    want = K.project_torch(torch.from_numpy(words), g).numpy()
    got = model_wide(words, slices, out_w, grid)
    assert (got != -1).all() and np.array_equal(got, want)


def test_narrow_rows_keep_the_packer_plan():
    slices = ((0, 0, 1), (4, 1, 600), (700, 601, 3))
    for row_words in (704, 1024, _cuda.DIRECT_ROW_WORDS):
        params = wide_params(row_words, slices, 604)
        assert params.chunks == 0
        assert (params.tile_rows, params.range_w) == _cuda.pck_packer(604)
    params = wide_params(_cuda.DIRECT_ROW_WORDS + 1, slices, 604)
    assert (params.tile_rows, params.range_w, params.chunks) == _cuda.pck_plan(604) \
        == (6, 604, 1)
