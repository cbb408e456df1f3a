"""The least time of a row-store scan on the card: the 32-byte sectors that
hold the enabled words of every row, read once, plus every output written
once, at the card's memory rate — or its float32 rate for the predicate and
sum work, whichever is longer.

A request is read by its fields alone (duck typing over the port's
``ProjectRequest`` / ``FilterRequest`` / ``AggregateRequest`` /
``GroupByRequest``): ``geom`` (enabled byte offsets and widths), ``pred_op``
/ ``pred_word``, ``ts_word`` (the two MVCC words), ``agg_word``,
``group_word`` and ``num_groups``.
"""

from __future__ import annotations

import math

from . import peaks

SECTOR = 32
WORD = 4
OPS_PER_ROW = 5  # predicate, MVCC tests and the sum: a few operations a row


def sector_bytes(words: set[int], rows: int, row_bytes: int) -> int:
    """Bytes of the distinct 32-byte sectors holding ``words`` of every row
    (the buffer starts sector-aligned).  The pattern repeats every
    ``SECTOR / gcd(row_bytes, SECTOR)`` rows, each period sector-aligned."""
    period = SECTOR // math.gcd(row_bytes, SECTOR)

    def count(n: int) -> int:
        return len({(r * row_bytes + WORD * w) // SECTOR for r in range(n) for w in words})

    full, rem = divmod(rows, period)
    return (full * count(period) + count(rem)) * SECTOR


def _is_blocked(req) -> bool:
    return hasattr(req, "geom")


def request_words(req) -> set[int]:
    """The row words one request enables: its projected columns, the
    aggregate and group words, the predicate word and the two MVCC words."""
    words: set[int] = set()
    if _is_blocked(req):
        for off, width in zip(req.geom.abs_offsets, req.geom.col_widths):
            words.update(range(off // WORD, (off + width) // WORD))
    if hasattr(req, "agg_word"):
        words.add(req.agg_word)
    if hasattr(req, "group_word"):
        words.add(req.group_word)
    if hasattr(req, "pred_word"):  # every kind but the plain projection
        if req.pred_op != "none":
            words.add(req.pred_word)
        if req.ts_word >= 0:
            words.update((req.ts_word, req.ts_word + 1))
    return words


def output_bytes(req, rows: int) -> int:
    """Bytes one request writes: the packed block (and a byte a row of
    validity mask for a filter), or the float32 ``[sum, count]`` pairs."""
    if _is_blocked(req):
        per_row = sum(req.geom.col_widths)
        return rows * (per_row + (1 if hasattr(req, "pred_word") else 0))
    if hasattr(req, "group_word"):
        return req.num_groups * 2 * 4
    return 2 * 4


def pass_bound_s(reqs, rows: int, row_bytes: int) -> tuple[float, int]:
    """``(seconds, bytes)``: the least time of one pass serving ``reqs`` over
    ``rows`` rows of ``row_bytes`` bytes, and the bytes it must move."""
    read = set().union(*(request_words(r) for r in reqs))
    moved = sector_bytes(read, rows, row_bytes) + sum(output_bytes(r, rows) for r in reqs)
    t_bytes = moved / peaks.HBM_BYTES_PER_S
    t_ops = rows * OPS_PER_ROW * len(reqs) / peaks.FP32_FLOPS
    return max(t_bytes, t_ops), moved
