"""Bus-beat accounting of the Requestor — the paper's Eq. (1)–(3) (the
port's copy of ``repro.core.descriptor``'s ``bytes_moved``).

The Requestor walks the table geometry and, for every (row ``i``, enabled
column ``j``), has a Fetch Unit read the bus-aligned burst that holds the
column chunk:

    P_{i,j}      = R*i + sum_{k<=j} O_{A_k}                    (1)
    R^addr_{i,j} = (P_{i,j} // B_w) * B_w                      (2)
    R^burst_{i,j}= ceil(((P_{i,j} % B_w) + C_{A_j}) / B_w)     (3)

``B_w`` is the platform bus width (16 B on the ZCU102).  The engine's PMU
charges exactly these beats; the reference package keeps the per-descriptor
model and the software fetch model that its tests hold this closed form to.
"""

from __future__ import annotations

import math

from .schema import TableGeometry

BUS_WIDTH = 16  # B_w of the paper's platform; configurable per call.


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
    instead of O(N · Q).
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
