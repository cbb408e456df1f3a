"""Requestor descriptor generation — the paper's Eq. (1)–(6) (the port's
copy of ``repro.core.descriptor``; numpy only).

The Requestor walks the table geometry and, for every (row ``i``, enabled
column ``j``), emits a descriptor telling a Fetch Unit which bus-aligned
burst to read from main memory and where the extracted bytes land in the
Reorganization Buffer:

    P_{i,j}      = R*i + sum_{k<=j} O_{A_k}                    (1)
    R^addr_{i,j} = (P_{i,j} // B_w) * B_w                      (2)
    R^burst_{i,j}= ceil(((P_{i,j} % B_w) + C_{A_j}) / B_w)     (3)
    W^addr_{i,j} = i * sum_k C_{A_k} + sum_{k<j} C_{A_k}       (4)
    E^s_{i,j}    = P_{i,j} % B_w                               (5)
    E^e_{i,j}    = (P_{i,j} + C_{A_j}) % B_w                   (6)

Eq. (4) appears in the paper with ``(i-1)`` because rows there are
1-indexed; here ``i`` is 0-based.  ``B_w`` is the platform bus width (16 B on
the ZCU102).  The engine's PMU charges exactly the beats of Eq. (3)
(:func:`bytes_moved`, a closed form); :func:`descriptors` and the software
Fetch-Unit model :func:`fetch_model` are the per-descriptor specification
that closed form is held to, byte for byte.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .schema import TableGeometry

BUS_WIDTH = 16  # B_w of the paper's platform; configurable per call.


@dataclasses.dataclass(frozen=True)
class Descriptor:
    """One Fetch-Unit work item (row i, enabled column j)."""

    i: int
    j: int
    r_addr: int  # main-memory burst start (bus aligned)
    r_burst: int  # number of bus beats
    w_addr: int  # byte position in the reorganization buffer
    e_start: int  # leading bytes to discard
    e_end: int  # trailing *valid* byte bound within the last beat (paper Eq. 6)


def descriptors(
    geom: TableGeometry, bus_width: int = BUS_WIDTH, rows: range | None = None
) -> list[Descriptor]:
    """Generate descriptors exactly as the Requestor would (row-major order)."""
    abs_offs = geom.abs_offsets
    out_off = []
    acc = 0
    for w in geom.col_widths:
        out_off.append(acc)
        acc += w
    out_row = geom.out_bytes_per_row
    descs = []
    for i in rows if rows is not None else range(geom.row_count):
        for j in range(geom.q):
            p = geom.row_bytes * i + abs_offs[j]  # Eq. (1)
            r_addr = (p // bus_width) * bus_width  # Eq. (2)
            r_burst = -(-((p % bus_width) + geom.col_widths[j]) // bus_width)  # Eq. (3)
            w_addr = i * out_row + out_off[j]  # Eq. (4), 0-based
            e_s = p % bus_width  # Eq. (5)
            e_e = (p + geom.col_widths[j]) % bus_width  # Eq. (6)
            descs.append(Descriptor(i, j, r_addr, r_burst, w_addr, e_s, e_e))
    return descs


def descriptor_arrays(
    geom: TableGeometry, bus_width: int = BUS_WIDTH
) -> dict[str, np.ndarray]:
    """Vectorized Eq. (1)-(6) over the whole (N, Q) grid; used by benches/tests."""
    i = np.arange(geom.row_count, dtype=np.int64)[:, None]
    offs = np.asarray(geom.abs_offsets, dtype=np.int64)[None, :]
    widths = np.asarray(geom.col_widths, dtype=np.int64)[None, :]
    out_off = np.asarray(
        [sum(geom.col_widths[:j]) for j in range(geom.q)], dtype=np.int64
    )[None, :]
    p = geom.row_bytes * i + offs
    return {
        "P": p,
        "r_addr": (p // bus_width) * bus_width,
        "r_burst": -(-((p % bus_width) + widths) // bus_width),
        "w_addr": i * geom.out_bytes_per_row + out_off,
        "e_start": p % bus_width,
        "e_end": (p + widths) % bus_width,
    }


def fetch_model(
    memory: np.ndarray, geom: TableGeometry, bus_width: int = BUS_WIDTH
) -> tuple[np.ndarray, int]:
    """Software model of the Requestor + Fetch Units + Reorganization Buffer.

    ``memory`` is the raw row-major table as a flat ``uint8`` array of at least
    ``R*N`` bytes.  Returns ``(reorg_buffer, beats)`` where ``reorg_buffer`` is
    the packed projection (``N * sum(C)`` bytes) and ``beats`` counts the total
    bus beats issued — the paper's data-movement metric (a fetch unit never
    reads more than the bus-aligned span covering its column chunk).
    """
    if memory.dtype != np.uint8:
        memory = memory.view(np.uint8)
    out = np.zeros(geom.row_count * geom.out_bytes_per_row, dtype=np.uint8)
    beats = 0
    for d in descriptors(geom, bus_width):
        burst = memory[d.r_addr : d.r_addr + d.r_burst * bus_width]
        width = geom.col_widths[d.j]
        chunk = burst[d.e_start : d.e_start + width]  # Column Extractor
        out[d.w_addr : d.w_addr + width] = chunk  # Writer
        beats += d.r_burst
    return out, beats


def bytes_moved(geom: TableGeometry, bus_width: int = BUS_WIDTH) -> dict[str, int]:
    """Exact data-movement accounting for the three access paths of §6.

    - ``row_wise``: a direct scan of the row store pulls every row in full
      cache lines (the paper's 'direct row-wise access').
    - ``columnar``: a perfect column store moves only the projected bytes.
    - ``rme``: bus-beat-accurate bytes the RME pulls from DRAM (Eq. 3 bursts).

    The burst count of Eq. (3) depends on the row index only through
    ``P mod B_w``, which is periodic in ``i`` with period
    ``B_w / gcd(R, B_w)`` — so the (N, Q) descriptor sweep collapses to one
    period per column.  This keeps the hot engine paths (every cold
    materialization and every co-planned batch charges bus beats) O(Q · B_w)
    instead of O(N · Q); ``descriptor_arrays`` remains the brute-force oracle
    the tests check this closed form against.
    """
    n = geom.row_count
    period = bus_width // math.gcd(geom.row_bytes, bus_width)
    beats = 0
    full, rem = divmod(n, period)
    for off, width in zip(geom.abs_offsets, geom.col_widths):
        bursts = [
            -(-(((geom.row_bytes * i + off) % bus_width) + width) // bus_width)
            for i in range(period)
        ]
        beats += full * sum(bursts) + sum(bursts[:rem])
    cache_line = 64
    n_lines = -(-geom.row_bytes * n // cache_line)
    return {
        "row_wise": n_lines * cache_line,
        "columnar": n * geom.out_bytes_per_row,
        "rme": beats * bus_width,
    }
