"""Batch executor — coalesce heterogeneous scan ops, scan each table once;
the port of ``repro.core.executor``.

The paper's RME amortizes its one expensive DRAM pass across everything the
Fetch Units can extract from it; a query batch that touches one table several
times — whether as projections, predicated filters, fused aggregates, or
group-bys — should pay for that pass once, not once per op.
:class:`BatchExecutor` is the host-side queue that makes this shape easy to
hit: callers queue work (``add()``/``add_columns()`` for projection views,
``add_filter()``/``add_aggregate()``/``add_groupby()`` for the offload
operators, or ``add_op()`` for a pre-built scan op), then ``submit()``
coalesces everything per table and dispatches
:meth:`RelationalMemoryEngine.execute_many`, which runs the heterogeneous
one-pass kernel (``rm_scan_multi_kernel`` on the card) — one row-store stream per table, every
op's output emitted from it, bus-beat bytes charged to the shared scan
exactly once via the union geometry.

Results come back in submission order, each matching its op's single-op
contract (packed blocks, ``(packed, mask)`` pairs, ``[sum, count]`` pairs,
``(sums, counts)`` vectors), and every projection lands in the reorganization
cache, so post-batch accesses through the normal ``view.packed()`` path are
hot.

Write-path semantics: a batch always observes the table state at
``submit()`` time — the engine syncs each table's device copy first,
shipping only the write delta (appended rows as tail chunks, patched
timestamp words from the patch log), and a multi-chunk table is streamed one
fused pass per chunk with partials combined.  Ops that carry a
``snapshot_ts`` (filters, aggregates, group-bys) evaluate the MVCC
visibility test in-scan, so a pinned snapshot returns byte-identical results
no matter how many writes landed since; ops without one see every physical
row (all versions) — pass a snapshot when the table takes updates/deletes.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .ephemeral import EphemeralView
from .requests import AggregateOp, FilterOp, GroupByOp, ProjectOp, ScanOp
from .table import RelationalTable


class BatchExecutor:
    """Queue of pending scan ops, flushed as one shared scan per table."""

    def __init__(self, engine):
        self.engine = engine
        self._pending: list[ScanOp] = []

    def _check_engine(self, view: EphemeralView) -> None:
        if view.engine is not self.engine:
            raise ValueError("view was registered with a different engine")

    def add_op(self, op: ScanOp) -> ScanOp:
        """Queue a pre-built scan op for the next ``submit()``."""
        if isinstance(op, (ProjectOp, FilterOp)):
            self._check_engine(op.view)
        self._pending.append(op)
        return op

    def add(self, view: EphemeralView) -> EphemeralView:
        """Queue an already-registered view (projection) for ``submit()``."""
        self._check_engine(view)
        self._pending.append(ProjectOp(view))
        return view

    def add_columns(
        self,
        table: RelationalTable,
        columns: Sequence[str],
        snapshot_ts: int | None = None,
        frame: int = 0,
    ) -> EphemeralView:
        """Register a view (configuration-port write) and queue it."""
        return self.add(
            self.engine.register(table, columns, snapshot_ts=snapshot_ts, frame=frame)
        )

    def add_filter(
        self,
        table: RelationalTable,
        columns: Sequence[str],
        pred_col: str,
        pred_op: str = "gt",
        pred_k=0,
        snapshot_ts: int | None = None,
    ) -> FilterOp:
        """Queue a fused selection+projection over ``columns``."""
        view = self.engine.register(table, columns, snapshot_ts=snapshot_ts)
        op = FilterOp(view, pred_col, pred_op, pred_k, snapshot_ts)
        self._pending.append(op)
        return op

    def add_aggregate(
        self,
        table: RelationalTable,
        agg_col: str,
        pred_col: str | None = None,
        pred_op: str = "none",
        pred_k=0,
        snapshot_ts: int | None = None,
    ) -> AggregateOp:
        """Queue a fused ``SELECT SUM(agg), COUNT(*) WHERE pred``."""
        op = AggregateOp(table, agg_col, pred_col, pred_op, pred_k, snapshot_ts)
        self._pending.append(op)
        return op

    def add_groupby(
        self,
        table: RelationalTable,
        group_col: str,
        agg_col: str,
        num_groups: int,
        pred_col: str | None = None,
        pred_op: str = "none",
        pred_k=0,
        snapshot_ts: int | None = None,
    ) -> GroupByOp:
        """Queue a fused group-by partial over a static group domain."""
        op = GroupByOp(table, group_col, agg_col, num_groups,
                       pred_col, pred_op, pred_k, snapshot_ts)
        self._pending.append(op)
        return op

    def submit(self) -> list:
        """Flush the queue: one shared scan per distinct table, results in order.

        The queue is cleared only after the batch succeeds — a failing op
        leaves everything pending so the caller can inspect or retry.
        """
        if not self._pending:
            return []
        results = self.engine.execute_many(self._pending)
        self._pending = []
        return results

    def __len__(self) -> int:
        return len(self._pending)


def materialize_batch(engine, views: Sequence[EphemeralView]) -> list[torch.Tensor]:
    """One-shot convenience: coalesce ``views`` per table and materialize them."""
    return engine.materialize_many(views)


def execute_batch(engine, ops: Sequence[ScanOp]) -> list:
    """One-shot convenience: coalesce heterogeneous ``ops`` and execute them."""
    return engine.execute_many(ops)
