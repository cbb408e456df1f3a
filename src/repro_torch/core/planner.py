"""Execution-strategy selection + the logical-plan compiler (paper §4, §8) —
the port of ``repro.core.planner``.

Per-query costing (paper §4): the planner costs each access path in *bytes
through the hierarchy* and picks the cheapest:

  row   : N · R                      (full rows)
  rme   : Σ_j beats(j) · B_w         (bus-beat-exact Eq.(3) bursts)
  hot   : N · Σ C_j                  (reorganization-cache hit: packed bytes
                                      only, checked against live cache state)
  fused : O(1)                       (aggregations the engine answers with a
                                      scalar — Q0/Q3-shaped queries)

On top of the cost model sits :func:`compile_plan`: it lowers a logical plan
(:mod:`repro_torch.core.plan`) to a :class:`PhysicalQuery` routed to the best
physical path — engine scan ops (projections, fused filters, fused
aggregates, group-by partials, device hash joins), or a host-side baseline
(``"row"`` / ``"col"``).  A compiled query splits into *scan ops* (batchable
across queries: the :class:`~repro_torch.serve.query_server.QueryServer`
hands a whole tick's ops to one ``execute_many`` call), a *launch* step that
enqueues device work without host syncs, and a *finalize* step that is the
only point allowed to block.

The join build cache lives here too: the host sort-probe's sorted
``{key, payload}`` index and the device route's hash partitions, keyed by
(table uid, version, key col, payload col, path, device) so any OLTP
mutation of the build side invalidates.  The device is part of the key (the
reference's key has none): the cache is module-global, and a process that
runs a card engine and a CPU engine must never hand one's tensors to the
other.  The "col" path is never cached.  FIFO-bounded by bytes, and a dead
build table's entries are dropped by a weakref finalizer.
"""

from __future__ import annotations

import dataclasses
import warnings
import weakref
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.kernels.common import group_ids
from repro_torch.kernels.rme_join import estimated_partition_bytes

from .descriptor import bytes_moved
from .engine import RelationalMemoryEngine
from .ephemeral import EphemeralView
from .optimizer import optimize_trace, pred_class
from .plan import (
    PlanBuilder,
    PlanError,
    PlanNode,
    Predicate,
    QueryShape,
    decompose,
    describe,
)
from .requests import (
    AggregateOp,
    FilterOp,
    GroupByOp,
    JoinOp,
    JoinResult,
    MultiJoinResult,
    ProjectOp,
    ScanOp,
)
from .schema import MAX_ENABLED_COLUMNS, TableGeometry, merge_geometries
from .table import RelationalTable


@dataclasses.dataclass(frozen=True)
class Plan:
    path: str  # "fused" | "hot" | "rme" | "row"
    est_bytes: int
    alternatives: dict[str, int]

    def __str__(self) -> str:
        alts = ", ".join(f"{k}={v:,}" for k, v in self.alternatives.items())
        return f"Plan({self.path}, est {self.est_bytes:,} B; {alts})"


def plan_query(
    engine: RelationalMemoryEngine,
    table: RelationalTable,
    columns: Sequence[str],
    aggregate_only: bool = False,
) -> Plan:
    """Choose the access path for a query touching ``columns``."""
    if len(columns) > MAX_ENABLED_COLUMNS:
        # beyond the configuration port's Q cap the engine cannot express the
        # view — and at that projectivity full rows are the right answer
        n_bytes = table.row_count * table.schema.row_bytes
        return Plan(path="row", est_bytes=n_bytes, alternatives={"row": n_bytes})
    geom = TableGeometry.from_schema(table.schema, columns, table.row_count)
    moved = bytes_moved(geom)
    costs = {
        "row": moved["row_wise"],
        "rme": moved["rme"],
        "hot": moved["columnar"],
    }
    # hot only if the reorg cache holds an entry covering every current row
    # (peek_project probes without side effects)
    if engine.peek_project(table, geom) is None:
        costs.pop("hot")
    if aggregate_only and len(columns) <= 2:
        costs["fused"] = 8  # the engine returns [sum, count]
    # equal-cost ties resolve toward the engine
    pref = ("fused", "hot", "rme", "row")
    path = min(costs, key=lambda p: (costs[p], pref.index(p)))
    return Plan(path=path, est_bytes=costs[path], alternatives=costs)


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Co-planned query batch over one table (scan-sharing credit applied).

    ``shared`` is True when serving every rme-path view from one
    multi-output scan moves fewer bytes than materializing each
    independently.
    """

    shared: bool
    est_bytes: int  # cost of the chosen strategy
    shared_bytes: int  # union-scan cost: one pass serves all rme views
    independent_bytes: int  # sum of the per-view plans
    per_view: tuple[Plan, ...]

    def __str__(self) -> str:
        return (
            f"BatchPlan({'shared' if self.shared else 'independent'},"
            f" est {self.est_bytes:,} B; shared={self.shared_bytes:,},"
            f" independent={self.independent_bytes:,}, views={len(self.per_view)})"
        )


def plan_batch(
    engine: RelationalMemoryEngine,
    table: RelationalTable,
    groups: Sequence[Sequence[str]],
) -> BatchPlan:
    """Co-plan several column-group queries over ``table``: every view the
    RME can express (≤ Q-cap columns, not already hot) is priced as part of
    **one** pass whose bus-beat bytes follow the union geometry."""
    plans = tuple(plan_query(engine, table, list(g)) for g in groups)
    independent = sum(p.est_bytes for p in plans)
    shareable = [
        p.path in ("rme", "row") and len(g) <= MAX_ENABLED_COLUMNS
        for g, p in zip(groups, plans)
    ]
    shared_geoms = [
        TableGeometry.from_schema(table.schema, list(g), table.row_count)
        for g, ok in zip(groups, shareable)
        if ok
    ]
    unshared = sum(p.est_bytes for p, ok in zip(plans, shareable) if not ok)
    if len(shared_geoms) >= 2:
        union = merge_geometries(shared_geoms)
        shared_bytes = bytes_moved(union)["rme"] + unshared
    else:
        shared_bytes = independent
    shared = shared_bytes < independent
    return BatchPlan(
        shared=shared,
        est_bytes=min(shared_bytes, independent),
        shared_bytes=shared_bytes,
        independent_bytes=independent,
        per_view=plans,
    )


def execute_sum(
    engine: RelationalMemoryEngine,
    table: RelationalTable,
    agg_col: str,
    pred_col: str | None = None,
    pred_op: str = "none",
    pred_k=0,
) -> tuple[float, Plan]:
    """Plan + execute a Q0/Q3-shaped query through the chosen path."""
    cols = [agg_col] + ([pred_col] if pred_col else [])
    plan = plan_query(engine, table, cols, aggregate_only=True)
    # encoded columns must ride the fused path: the packed-view reduction
    # below reads raw words, which for a codec column are code words
    if plan.path == "fused" or any(c in table.codecs for c in cols):
        s, _ = engine.aggregate(table, agg_col, pred_col, pred_op, pred_k)
        return s, plan
    view = engine.register(table, tuple(cols))
    packed = view.packed()
    off_a, _ = view.column_words(agg_col)
    vals = packed[:, off_a].to(torch.float32)
    if pred_col is not None and pred_op != "none":
        off_p, _ = view.column_words(pred_col)
        mask = _pred_mask(packed[:, off_p], pred_op, pred_k)
        vals = torch.where(mask, vals, _zero(vals))
    return float(torch.sum(vals)), plan


# ------------------------------------------------- host-side access paths
def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=like.dtype, device=like.device)


def _decode_i32(x: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == "float32":
        return x.view(torch.float32)
    return x


def _pred_mask(vals: torch.Tensor, op: str, k) -> torch.Tensor:
    """The single fused predicate, evaluated outside the kernels (gt/lt
    only — the same ops the kernels implement)."""
    return vals > k if op == "gt" else vals < k


def _col_from_rows(table: RelationalTable, name: str,
                   device: torch.device) -> torch.Tensor:
    """Direct row-wise column read: ships every row word, slices one column."""
    col = table.schema.column(name)
    codec = table.codecs.get(name)
    if codec is not None:
        if col.dtype == "str":
            raise PlanError(
                f"string column {name!r} has no host-baseline spelling — "
                "strings execute on their codes through the rme path"
            )
        # host baselines reason in value space: decode the stored codes
        raw = table.words()[:, table.schema.word_offset(name)]
        return torch.as_tensor(codec.decode_np(raw, np.arange(table.row_count)),
                               device=device)
    words = torch.from_numpy(table.words()).to(device)  # the whole row store moves
    off = table.schema.word_offset(name)
    return _decode_i32(words[:, off], col.dtype)


def _host_col(
    table: RelationalTable,
    colstore: Mapping[str, np.ndarray] | None,
    name: str,
    path: str,
    device: torch.device,
) -> torch.Tensor:
    """One decoded column through a baseline path (``"row"`` or ``"col"``)."""
    if path == "row":
        return _col_from_rows(table, name, device)
    if path == "col":
        if colstore is None:
            raise ValueError(f"path 'col' needs a colstore for {name!r}")
        return torch.as_tensor(np.asarray(colstore[name]), device=device)
    raise ValueError(path)


def _host_words(
    table: RelationalTable,
    colstore: Mapping[str, np.ndarray] | None,
    name: str,
    path: str,
    device: torch.device,
) -> torch.Tensor:
    """One column as raw (N, words) int32 — bit-exact with the packed layout."""
    col = table.schema.column(name)
    if path == "row":
        words = torch.from_numpy(table.words()).to(device)
        off = table.schema.word_offset(name)
        return words[:, off : off + col.words]
    arr = np.asarray(colstore[name])
    if arr.dtype.kind in ("U", "O"):
        raise PlanError(
            f"string column {name!r} has no raw-words host spelling — "
            "strings pack as dictionary codes on the rme path only"
        )
    if arr.dtype.kind == "S":  # char columns travel as raw words
        arr = np.ascontiguousarray(arr).view(np.uint8).reshape(
            table.row_count, -1
        ).view(np.int32)
    raw = np.ascontiguousarray(arr).reshape(table.row_count, -1).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(raw)).to(device)


# ------------------------------------------------- q5 build-side index cache
# One cache, two entry kinds, keyed by (uid, version, key, payload, path,
# device): the host sort-probe route stores its sorted {key, payload} index
# under its data path, and the device hash route stores its bucket
# partition tensors (kernels.rme_join.JoinPartitions) under
# path=DEVICE_JOIN_PATH.  Both kinds share the byte bound, the FIFO
# eviction, the version-drop rule and the weakref lifetime, and both are
# dropped by clear_join_build_cache() / RelationalMemoryEngine.reset().
DEVICE_JOIN_PATH = "rme-hash"

_BUILD_INDEX_CACHE: dict[tuple, tuple[torch.Tensor, ...]] = {}
_BUILD_INDEX_CAPACITY = 64 << 20
_build_index_bytes = 0  # incremental occupancy (kept exact by every mutation)
_BUILD_INDEX_FINALIZED: set[int] = set()
JOIN_BUILD_STATS = {"hits": 0, "misses": 0}


def _entry_bytes(entry: tuple[torch.Tensor, ...]) -> int:
    return sum(a.numel() * a.element_size() for a in entry)


def _cache_key(r_table: RelationalTable, key: str, r_proj: str, path: str,
               device: torch.device) -> tuple:
    return (r_table.uid, r_table.version, key, r_proj, path, str(device))


def _pop_build_entry(k: tuple) -> None:
    global _build_index_bytes
    entry = _BUILD_INDEX_CACHE.pop(k, None)
    if entry is not None:
        _build_index_bytes -= _entry_bytes(entry)


def clear_join_build_cache() -> None:
    global _build_index_bytes
    _BUILD_INDEX_CACHE.clear()
    _build_index_bytes = 0
    _KEY_UNIQUE_CACHE.clear()
    JOIN_BUILD_STATS["hits"] = 0
    JOIN_BUILD_STATS["misses"] = 0


def _drop_build_entries(uid: int, keep_version=None) -> None:
    """Drop a table's cached indexes (all of them, or all but one version)."""
    if keep_version is None:
        _BUILD_INDEX_FINALIZED.discard(uid)
    for k in [k for k in _BUILD_INDEX_CACHE
              if k[0] == uid and k[1] != keep_version]:
        _pop_build_entry(k)


def _peek_build_entry(r_table: RelationalTable, key: str, r_proj: str,
                      path: str, device: torch.device):
    """Stat-free cache probe for route costing: the route chooser asks "is
    the sorted index / partition set warm?" for every route without
    touching ``JOIN_BUILD_STATS``."""
    return _BUILD_INDEX_CACHE.get(_cache_key(r_table, key, r_proj, path, device))


def _probe_build_index(
    r_table: RelationalTable, key: str, r_proj: str, path: str,
    device: torch.device,
) -> tuple[torch.Tensor, ...] | None:
    """Warm-path probe, called *before* the build side is materialized — a
    hit must skip the build-side column reads entirely, not just the sort."""
    if path == "col":  # colstore contents are not keyed by the table version
        return None
    hit = _BUILD_INDEX_CACHE.get(_cache_key(r_table, key, r_proj, path, device))
    if hit is not None:
        JOIN_BUILD_STATS["hits"] += 1
    else:
        JOIN_BUILD_STATS["misses"] += 1
    return hit


def _insert_build_index(
    entry: tuple[torch.Tensor, ...],
    r_table: RelationalTable,
    key: str,
    r_proj: str,
    path: str,
) -> None:
    """Cache ``entry`` under the device its tensors live on."""
    global _build_index_bytes
    if path == "col":
        return
    # versions are monotonic: this table's older entries can never hit again
    _drop_build_entries(r_table.uid, keep_version=r_table.version)
    nbytes = _entry_bytes(entry)
    if nbytes > _BUILD_INDEX_CAPACITY:
        return  # larger than the whole budget: never cached
    ck = _cache_key(r_table, key, r_proj, path, entry[0].device)
    # same-key overwrite releases the old bytes first (two identical joins
    # compiled in one tick both miss at compile time and both insert)
    _pop_build_entry(ck)
    while _build_index_bytes + nbytes > _BUILD_INDEX_CAPACITY and _BUILD_INDEX_CACHE:
        _pop_build_entry(next(iter(_BUILD_INDEX_CACHE)))
    _BUILD_INDEX_CACHE[ck] = entry
    _build_index_bytes += nbytes
    if r_table.uid not in _BUILD_INDEX_FINALIZED:
        weakref.finalize(r_table, _drop_build_entries, r_table.uid)
        _BUILD_INDEX_FINALIZED.add(r_table.uid)


# ------------------------------------------------------------ plan compiler
@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Everything :func:`compile_plan` needs beyond the plan and the engine.

    Frozen so a server tick can stamp per-tick state (the snapshot) with
    ``dataclasses.replace`` without aliasing the client's object.

    * ``path`` — data path of the paper's §6 comparison: ``"rme"`` (the
      engine; the compiler picks the physical route within it), ``"row"``
      or ``"col"`` (host baselines; ``col`` reads ``colstore`` /
      ``right_colstore``).
    * ``snapshot_ts`` — MVCC visibility pin (rme path only).
    * ``join_route`` — override the costed join route choice
      (``"device-hash-join"`` / ``"shared-scan-join"`` /
      ``"flipped-scan-join"``).
    * ``backend`` — fail fast if the engine is not this backend.
    * ``stream`` / ``stream_chunk_rows`` — chunked projection delivery.
    * ``optimize`` — run the :mod:`repro_torch.core.optimizer` passes
      before lowering.
    """

    path: str = "rme"
    colstore: Mapping[str, np.ndarray] | None = None
    right_colstore: Mapping[str, np.ndarray] | None = None
    snapshot_ts: int | None = None
    join_route: str | None = None
    backend: str | None = None
    stream: bool = False
    stream_chunk_rows: int | None = None
    optimize: bool = True


@dataclasses.dataclass
class PhysicalQuery:
    """A logical plan lowered to a physical route.

    * ``ops`` — engine-level scan ops the route needs served.  A batch
      executor hands the ops of *all* queries in a tick to one
      ``execute_many`` call; the results come back aligned with ``ops``.
    * ``launch(results)`` — enqueue the remaining device work; never
      blocks on the host.
    * ``finalize(token)`` — produce the user-facing result; the only step
      allowed to pull scalars to the host.

    A query compiled with ``stream=True`` carries ``stream``, a
    zero-argument callable returning the chunk iterator of
    :meth:`RelationalMemoryEngine.stream_project`, and no scan ops.
    ``run()`` is the blocking one-shot spelling.
    """

    engine: RelationalMemoryEngine
    shape: QueryShape
    path: str  # requested data path: "rme" | "row" | "col"
    route: str  # chosen physical route, e.g. "fused-aggregate", "shared-scan"
    cost: Plan | None
    ops: tuple[ScanOp, ...]
    _launch: Callable[[Sequence[Any]], Any]
    _finalize: Callable[[Any], Any]
    stream: Callable[[], Any] | None = None  # chunk-iterator factory
    # --- optimizer/compile introspection (stamped by compile_plan) ---
    options: "CompileOptions | None" = None
    logical: PlanNode | None = None  # the tree the client submitted
    optimized: PlanNode | None = None  # the tree that was actually lowered
    passes: tuple[str, ...] = ()  # optimizer + planner passes that fired
    # chosen multi-join order: (key, right_proj, est cold build bytes) per
    # spec, in execution order
    join_order: tuple[tuple[str, str, int], ...] = ()

    @property
    def views(self) -> tuple[EphemeralView, ...]:
        """The projection views among ``ops`` (kept for introspection)."""
        return tuple(op.view for op in self.ops if isinstance(op, ProjectOp))

    @property
    def backend(self) -> str:
        """The execution backend this query will run on."""
        return self.engine.backend

    def explain(self) -> str:
        """Human-readable compile report: chosen route, the before/after
        trees, the rewrite passes that fired, the cost-model estimate, and
        (for join chains) the chosen join order with estimated build bytes."""
        lines = [
            f"route: {self.route} (path={self.path},"
            f" backend={self.engine.backend})"
        ]
        if self.logical is not None:
            lines.append(f"logical:   {describe(self.logical)}")
        if self.optimized is not None and self.optimized is not self.logical:
            lines.append(f"optimized: {describe(self.optimized)}")
        lines.append(
            "passes: " + (", ".join(self.passes) if self.passes else "(none)")
        )
        if self.cost is not None:
            lines.append(f"cost: {self.cost}")
        for i, (key, right_proj, est) in enumerate(self.join_order):
            lines.append(
                f"join[{i}]: on {key} -> {right_proj}"
                f" (est cold build {est:,} B)"
            )
        return "\n".join(lines)

    def launch(self, results: Sequence[Any]) -> Any:
        return self._launch(results)

    def finalize(self, token: Any) -> Any:
        return self._finalize(token)

    def run(self) -> Any:
        if self.stream is not None:
            parts = list(self.stream())
            if len(parts) == 1:
                return parts[0]
            out_words = sum(self.shape.table.schema.column(c).words
                            for c in self.shape.columns)
            if not parts:  # an empty table streams zero chunks
                return torch.zeros((0, out_words), dtype=torch.int32,
                                   device=self.engine.device)
            return torch.cat(parts, 0)
        results = self.engine.execute_many(list(self.ops)) if self.ops else []
        return self._finalize(self._launch(results))


def _pred_args(pred: Predicate | None) -> tuple[str | None, str, Any]:
    if pred is None:
        return None, "none", 0
    return pred.col, pred.op, pred.k


def _check_fused_dtypes(table: RelationalTable, *cols: str | None) -> None:
    """Fused kernels decode 4-byte numeric words; reject anything else at
    compile time, so a bad query fails its own ticket instead of poisoning
    the tick's shared pass."""
    for name in cols:
        if name is None:
            continue
        if name in table.codecs:
            # codec-backed columns store raw int32 code words — exactly what
            # the fused kernels read
            continue
        dtype = table.schema.column(name).dtype
        if dtype not in ("int32", "float32"):
            raise ValueError(
                f"column {name!r}: fused kernels need a 4-byte numeric "
                f"column, got {dtype}"
            )


def _check_snapshot_path(path: str, snapshot_ts: int | None) -> None:
    """Snapshot-pinned reads are an rme-path capability: the host baselines
    have no timestamp channel, so asking for one is a plan error."""
    if snapshot_ts is not None and path != "rme":
        raise PlanError(
            f"snapshot_ts requires the rme path, not {path!r} "
            "(host baselines carry no MVCC timestamps)"
        )


def _compile_aggregate(
    engine: RelationalMemoryEngine, shape: QueryShape, o: CompileOptions
) -> PhysicalQuery:
    path, colstore, snapshot_ts = o.path, o.colstore, o.snapshot_ts
    agg = shape.agg
    pred_col, pred_op, pred_k = _pred_args(shape.pred)
    dev = engine.device

    def _combine(s: float, c: float):
        if agg.op == "sum":
            return s
        if agg.op == "count":
            return c
        return s / max(c, 1.0)

    if path != "rme":
        def launch(_):
            a = _host_col(shape.table, colstore, agg.col, path, dev).to(torch.float32)
            if pred_col is not None:
                p = _host_col(shape.table, colstore, pred_col, path, dev)
                mask = _pred_mask(p, pred_op, pred_k)
            else:
                mask = torch.ones(a.shape, dtype=torch.bool, device=a.device)
            return torch.sum(torch.where(mask, a, _zero(a))), torch.sum(mask)

        return PhysicalQuery(
            engine, shape, path, route=f"host-{path}", cost=None, ops=(),
            _launch=launch,
            _finalize=lambda t: _combine(float(t[0]), float(t[1])),
        )

    cost = plan_query(engine, shape.table, list(shape.columns), aggregate_only=True)
    encoded = any(c is not None and c in shape.table.codecs
                  for c in (agg.col, pred_col))
    if cost.path == "fused" or snapshot_ts is not None or encoded:
        # the aggregate is a scan op: in a tick's batch it rides the shared
        # pass; alone, execute_many routes it to the single-op kernel.  A
        # snapshot-pinned aggregate must take this route — only the fused
        # kernel evaluates the MVCC test
        _check_fused_dtypes(shape.table, agg.col, pred_col)
        op = AggregateOp(shape.table, agg.col, pred_col=pred_col,
                         pred_op=pred_op, pred_k=pred_k,
                         snapshot_ts=snapshot_ts)

        def finalize(out):
            engine.stats.bytes_to_cpu += 8  # the scalar pair crosses on sync
            host = out.cpu()
            return _combine(float(host[0]), float(host[1]))

        return PhysicalQuery(
            engine, shape, path, route="fused-aggregate", cost=cost, ops=(op,),
            _launch=lambda results: results[0], _finalize=finalize,
        )

    # hot / rme / row routes reduce a materialized (or sliced) column group
    view = engine.register(shape.table, shape.columns)

    def launch(packed):
        arr = packed[0]
        off_a, _ = view.column_words(agg.col)
        vals = arr[:, off_a].to(torch.float32)
        if pred_col is not None:
            off_p, _ = view.column_words(pred_col)
            mask = _pred_mask(arr[:, off_p], pred_op, pred_k)
        else:
            mask = torch.ones(vals.shape, dtype=torch.bool, device=vals.device)
        return torch.sum(torch.where(mask, vals, _zero(vals))), torch.sum(mask)

    return PhysicalQuery(
        engine, shape, path, route=cost.path, cost=cost, ops=(ProjectOp(view),),
        _launch=launch,
        _finalize=lambda t: _combine(float(t[0]), float(t[1])),
    )


def _compile_groupby(
    engine: RelationalMemoryEngine, shape: QueryShape, o: CompileOptions
) -> PhysicalQuery:
    path, colstore, snapshot_ts = o.path, o.colstore, o.snapshot_ts
    g = shape.group
    pred_col, pred_op, pred_k = _pred_args(shape.pred)
    dev = engine.device

    def _combine(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        if g.op == "sum":
            return sums
        return sums / torch.clamp(counts, min=1.0)

    if path != "rme":
        def launch(_):
            a = _host_col(shape.table, colstore, g.agg, path, dev).to(torch.float32)
            grp = group_ids(
                _host_col(shape.table, colstore, g.group, path, dev), g.num_groups
            ).long()
            if pred_col is not None:
                p = _host_col(shape.table, colstore, pred_col, path, dev)
                mask = _pred_mask(p, pred_op, pred_k)
            else:
                mask = torch.ones(a.shape, dtype=torch.bool, device=a.device)
            vals = torch.where(mask, a, _zero(a))
            cnt = mask.to(torch.float32)
            sums = torch.zeros(g.num_groups, dtype=torch.float32, device=a.device)
            counts = torch.zeros(g.num_groups, dtype=torch.float32, device=a.device)
            return sums.index_add_(0, grp, vals), counts.index_add_(0, grp, cnt)

        return PhysicalQuery(
            engine, shape, path, route=f"host-{path}", cost=None, ops=(),
            _launch=launch, _finalize=lambda t: _combine(*t),
        )

    # a scan op like the aggregate; a snapshot pins MVCC visibility in-scan
    _check_fused_dtypes(shape.table, g.group, g.agg, pred_col)
    op = GroupByOp(
        shape.table, g.group, g.agg, g.num_groups,
        pred_col=pred_col, pred_op=pred_op, pred_k=pred_k,
        snapshot_ts=snapshot_ts,
    )

    return PhysicalQuery(
        engine, shape, path, route="fused-groupby", cost=None, ops=(op,),
        _launch=lambda results: results[0], _finalize=lambda t: _combine(*t),
    )


def _resident_full_rows(engine: RelationalMemoryEngine, table, cols) -> torch.Tensor:
    """Column word-slices streamed from the device-resident row store,
    charged to the PMU as one full-row pass — the beyond-Q-cap fallback."""
    words = engine.device_words(table)
    parts, out_bytes = [], 0
    for n in cols:
        off = table.schema.word_offset(n)
        w = table.schema.column(n).words
        parts.append(words[:, off : off + w])
        out_bytes += table.schema.column(n).width
    engine.stats.rows_projected += table.row_count
    engine.stats.bytes_from_dram += table.row_count * table.schema.row_bytes
    engine.stats.bytes_to_cpu += table.row_count * out_bytes
    return torch.cat(parts, dim=1)


def _numeric_anchor(table: RelationalTable, cols) -> str | None:
    """A projection column an inert (``"none"``) predicate can anchor on:
    int32 code words or a plain 4-byte numeric column."""
    return next(
        (n for n in cols
         if n in table.codecs  # code words are int32, inert op never decodes
         or table.schema.column(n).dtype in ("int32", "float32")),
        None,
    )


def _masked_rows(mask: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None], packed, _zero(packed))


def _compile_project(
    engine: RelationalMemoryEngine, shape: QueryShape, o: CompileOptions,
    extra_passes: list[str],
) -> PhysicalQuery:
    path, colstore, snapshot_ts = o.path, o.colstore, o.snapshot_ts
    stream, stream_chunk_rows = o.stream, o.stream_chunk_rows
    table, cols = shape.table, shape.columns
    pred_col, pred_op, pred_k = _pred_args(shape.pred)
    dev = engine.device
    if (o.optimize and path == "rme" and shape.pred is not None
            and len(cols) <= MAX_ENABLED_COLUMNS
            and pred_class(table, shape.pred) == "all"):
        # a provably all-pass predicate on a (packed, mask) plan: the
        # lowering goes inert — anchored on a projection column with op
        # "none", so the real predicate column leaves the union geometry
        anchor = _numeric_anchor(table, cols)
        if anchor is not None:
            pred_col, pred_op, pred_k = anchor, "none", 0
            extra_passes.append("eliminate-trivial-pred")

    if stream:
        # incremental delivery, one row-store chunk at a time: only the
        # predicate-free, snapshot-free rme projection has a per-chunk
        # contract
        if path != "rme":
            raise PlanError(f"streamed results need the rme path, not {path!r}")
        if shape.pred is not None or snapshot_ts is not None:
            raise PlanError(
                "streamed results serve plain projections only — a "
                "predicate or MVCC snapshot needs the (packed, mask) "
                "contract, which has no per-chunk spelling"
            )
        if len(cols) > MAX_ENABLED_COLUMNS:
            raise PlanError(
                f"streamed projection of {len(cols)} columns exceeds the "
                f"configuration port's Q cap ({MAX_ENABLED_COLUMNS})"
            )
        view = engine.register(table, cols)
        return PhysicalQuery(
            engine, shape, path, route="stream-project", cost=None, ops=(),
            _launch=lambda _: None, _finalize=lambda t: t,
            stream=lambda: engine.stream_project(
                view, chunk_rows=stream_chunk_rows
            ),
        )

    if shape.pred is not None:
        # fused selection+projection: rows failing the predicate are zeroed
        # in-scan, a validity bitmap travels alongside
        if path == "rme":
            if len(cols) > MAX_ENABLED_COLUMNS:
                # beyond the Q cap: stream full rows from the resident store,
                # predicate applied engine-side on raw code words against
                # the code-translated constant — the fused contract
                def launch(_):
                    words = engine.device_words(table)
                    codec = table.codecs.get(pred_col)
                    op_, k_ = (codec.translate_pred(pred_op, pred_k)
                               if codec is not None else (pred_op, pred_k))
                    p = _decode_i32(
                        words[:, table.schema.word_offset(pred_col)],
                        "int32" if codec is not None
                        else table.schema.column(pred_col).dtype,
                    )
                    mask = (_pred_mask(p, op_, k_) if op_ != "none"
                            else torch.ones(p.shape, dtype=torch.bool,
                                            device=p.device))
                    if snapshot_ts is not None:
                        mask = mask & engine.valid_mask(table, snapshot_ts)
                    packed = _resident_full_rows(engine, table, cols)
                    return _masked_rows(mask, packed), mask

                return PhysicalQuery(
                    engine, shape, path, route="row-fallback", cost=None,
                    ops=(), _launch=launch, _finalize=lambda t: t,
                )

            # a scan op with the rme_filter contract: (packed, mask)
            _check_fused_dtypes(table, pred_col)
            view = engine.register(table, cols, snapshot_ts=snapshot_ts)
            op = FilterOp(view, pred_col, pred_op, pred_k, snapshot_ts)

            return PhysicalQuery(
                engine, shape, path, route="fused-filter", cost=None, ops=(op,),
                _launch=lambda results: results[0], _finalize=lambda t: t,
            )

        def launch(_):
            p = _host_col(table, colstore, pred_col, path, dev)
            mask = _pred_mask(p, pred_op, pred_k)
            parts = [_host_words(table, colstore, n, path, dev) for n in cols]
            return _masked_rows(mask, torch.cat(parts, dim=1)), mask

        return PhysicalQuery(
            engine, shape, path, route=f"host-{path}", cost=None, ops=(),
            _launch=launch, _finalize=lambda t: t,
        )

    if path == "rme":
        if snapshot_ts is not None:
            # a snapshot-pinned projection needs the validity bitmap: route
            # through the filter kernel with a pass-everything predicate on
            # a 4-byte numeric column; a group without one (or beyond the Q
            # cap) takes the resident-row fallback below
            pred_anchor = _numeric_anchor(table, cols)
            if len(cols) <= MAX_ENABLED_COLUMNS and pred_anchor is not None:
                view = engine.register(table, cols, snapshot_ts=snapshot_ts)
                op = FilterOp(view, pred_anchor, "none", 0, snapshot_ts)
                return PhysicalQuery(
                    engine, shape, path, route="snapshot-project", cost=None,
                    ops=(op,),
                    _launch=lambda results: results[0], _finalize=lambda t: t,
                )

            def launch(_):
                mask = engine.valid_mask(table, snapshot_ts)
                packed = _resident_full_rows(engine, table, cols)
                return _masked_rows(mask, packed), mask

            return PhysicalQuery(
                engine, shape, path, route="row-fallback", cost=None, ops=(),
                _launch=launch, _finalize=lambda t: t,
            )

        cost = plan_query(engine, table, list(cols))
        if cost.path in ("rme", "hot"):
            view = engine.register(table, cols)
            return PhysicalQuery(
                engine, shape, path, route=cost.path, cost=cost,
                ops=(ProjectOp(view),),
                _launch=lambda packed: packed[0], _finalize=lambda t: t,
            )

        # inexpressible (beyond the Q cap) or cheaper as full rows: stream
        # whole rows from the device-resident store
        return PhysicalQuery(
            engine, shape, path, route="row-fallback", cost=cost, ops=(),
            _launch=lambda _: _resident_full_rows(engine, table, cols),
            _finalize=lambda t: t,
        )

    def launch(_):
        parts = [_host_words(table, colstore, n, path, dev) for n in cols]
        return torch.cat(parts, dim=1)

    return PhysicalQuery(
        engine, shape, path, route=f"host-{path}", cost=None, ops=(),
        _launch=launch, _finalize=lambda t: t,
    )


def _lookup_sorted(sorted_keys: torch.Tensor, probe: torch.Tensor):
    """Left-sided binary search of ``probe`` in ``sorted_keys``: the clipped
    positions and where the key there equals the probe key."""
    if sorted_keys.numel() == 0:
        pos = torch.zeros(probe.shape, dtype=torch.long, device=probe.device)
        return pos, torch.zeros(probe.shape, dtype=torch.bool, device=probe.device)
    dt = torch.promote_types(sorted_keys.dtype, probe.dtype)
    sorted_keys, probe = sorted_keys.to(dt), probe.to(dt)
    pos = torch.searchsorted(sorted_keys.contiguous(), probe.contiguous()).clamp_(
        0, sorted_keys.shape[0] - 1)
    return pos, sorted_keys[pos] == probe


def _sort_probe(
    s_key: torch.Tensor,
    s_val: torch.Tensor,
    cached: tuple[torch.Tensor, torch.Tensor] | None,
    read_build: Callable[[], tuple[torch.Tensor, torch.Tensor]],
    r_table: RelationalTable,
    key: str,
    r_proj: str,
    path: str,
) -> JoinResult:
    """Probe-side join math shared by the rme and host routes: reuse the
    cached sorted build index, or build + insert it from ``read_build()``
    (only called on a miss)."""
    if cached is not None:
        rk_sorted, rv_sorted = cached
    else:
        r_key, r_val = read_build()
        order = torch.argsort(r_key, stable=True)
        rk_sorted, rv_sorted = r_key[order], r_val[order]
        _insert_build_index((rk_sorted, rv_sorted), r_table, key, r_proj, path)
    pos, matched = _lookup_sorted(rk_sorted, s_key)
    r_vals = (rv_sorted[pos] if rv_sorted.numel()
              else torch.zeros(s_key.shape, dtype=rv_sorted.dtype,
                               device=s_key.device))
    return JoinResult(
        s_proj=s_val,
        r_proj=torch.where(matched, r_vals, _zero(r_vals)),
        matched=matched,
    )


def _spec_device_expressible(table: RelationalTable, spec) -> bool:
    """Can the device hash route serve one join spec?  Both key columns
    must be int32 (or dict-encoded through one shared dictionary) and both
    payloads plain 4-byte numeric."""
    for t, name in ((table, spec.left_proj),
                    (spec.right_table, spec.right_proj)):
        col = t.schema.column(name)
        if (col.words != 1 or col.dtype not in ("int32", "float32")
                or name in t.codecs):
            return False
    for t in (table, spec.right_table):
        if t.schema.column(spec.key).words != 1:
            return False
    a = table.codecs.get(spec.key)
    b = spec.right_table.codecs.get(spec.key)
    if a is not None or b is not None:
        from .compression import DictCodec
        if not (isinstance(a, DictCodec) and isinstance(b, DictCodec)):
            return False
        return a is b or bool(np.array_equal(a.dictionary, b.dictionary))
    return (table.schema.column(spec.key).dtype == "int32"
            and spec.right_table.schema.column(spec.key).dtype == "int32")


def _device_join_expressible(shape: QueryShape) -> bool:
    """Whole-shape device-route check: every spec of the (possibly multi-)
    join chain must be expressible, and a probe-side predicate must sit on
    a 4-byte numeric column."""
    if shape.pred is not None:
        try:
            _check_fused_dtypes(shape.table, shape.pred.col)
        except ValueError:
            return False
    return all(_spec_device_expressible(shape.table, s) for s in shape.joins)


# host check for the flipped route's build-side uniqueness, cached per table
# version (an append/update bumps version and naturally re-checks)
_KEY_UNIQUE_CACHE: dict[tuple, bool] = {}


def _key_unique(table: RelationalTable, key: str) -> bool:
    ck = (table.uid, table.version, key)
    hit = _KEY_UNIQUE_CACHE.get(ck)
    if hit is None:
        raw = np.asarray(table.words())[:, table.schema.word_offset(key)]
        hit = bool(np.unique(raw).size == table.row_count)
        _KEY_UNIQUE_CACHE[ck] = hit
    return hit


FLIP_JOIN_PATH = "rme-flip"


def _flip_applicable(shape: QueryShape, snapshot_ts: int | None) -> bool:
    """Can the flipped sort-probe serve this join?  The probe table becomes
    the build side, so its key must be duplicate-free, single-word and
    non-string on both sides; predicates and snapshots have no flipped
    spelling."""
    j = shape.join
    if (len(shape.joins) != 1 or shape.pred is not None
            or snapshot_ts is not None):
        return False
    for t in (shape.table, j.right_table):
        col = t.schema.column(j.key)
        if col.words != 1 or col.dtype == "str":
            return False
    return _key_unique(shape.table, j.key)


def _side_ship_bytes(engine: RelationalMemoryEngine, table: RelationalTable,
                     cols: list[str]) -> int:
    """Modeled cost of scanning + shipping one side's {key, payload} packed
    block to the CPU — zero when the reorg cache already holds it."""
    geom = TableGeometry.from_schema(table.schema, cols, table.row_count)
    if engine.peek_project(table, geom) is not None:
        return 0
    return bytes_moved(geom)["rme"] + table.row_count * geom.out_bytes_per_row


def _join_route(
    engine: RelationalMemoryEngine, shape: QueryShape, snapshot_ts: int | None
) -> str:
    """Choose the join's physical route by modeled bytes through the
    hierarchy:

    * ``device-hash-join``: probe bus beats over the {key, payload} union +
      the partition upload when the build cache is cold.
    * ``shared-scan-join``: the probe-side scan **and** its packed block
      shipped for the CPU-side sort-probe, plus the same for the build side
      when the sorted index is cold.
    * ``flipped-scan-join``: ship the right table per call and keep the
      sorted index over the left — only when the probe key is duplicate-free
      and strictly cheaper.

    A snapshot-pinned or probe-predicated join has no host spelling, so it
    takes the device route or fails at compile time.
    """
    j = shape.join
    s_table, r_table = shape.table, j.right_table
    dev = engine.device
    expressible = _device_join_expressible(shape)
    if snapshot_ts is not None or shape.pred is not None:
        if not expressible:
            raise PlanError(
                ("snapshot_ts" if snapshot_ts is not None
                 else "probe-predicated") +
                " join needs device-expressible columns "
                "(int32 keys, 4-byte numeric payloads)"
            )
        return "device-hash-join"
    s_geom = TableGeometry.from_schema(
        s_table.schema, [j.left_proj, j.key], s_table.row_count
    )
    probe_beats = bytes_moved(s_geom)["rme"]
    host = 0
    if engine.peek_project(s_table, s_geom) is None:
        host += probe_beats + s_table.row_count * s_geom.out_bytes_per_row
    if _peek_build_entry(r_table, j.key, j.right_proj, "rme", dev) is None:
        host += _side_ship_bytes(engine, r_table, [j.key, j.right_proj])
    host_route = "shared-scan-join"
    if _flip_applicable(shape, snapshot_ts):
        flipped = _side_ship_bytes(engine, r_table, [j.key, j.right_proj])
        if _peek_build_entry(s_table, j.key, j.left_proj,
                             FLIP_JOIN_PATH, dev) is None:
            flipped += _side_ship_bytes(engine, s_table,
                                        [j.left_proj, j.key])
        # strictly cheaper only: at a tie the standard orientation keeps the
        # build index on the (assumed-stable) dimension side
        if flipped < host:
            host, host_route = flipped, "flipped-scan-join"
    if not expressible:
        return host_route
    device = probe_beats
    if _peek_build_entry(r_table, j.key, j.right_proj, DEVICE_JOIN_PATH,
                         dev) is None:
        device += estimated_partition_bytes(r_table.row_count)
    # ties resolve toward the device: the offloaded probe leaves the CPU free
    return "device-hash-join" if device <= host else host_route


def _join_probe_key(table: RelationalTable, key: str,
                    codes: torch.Tensor) -> torch.Tensor:
    """Sort-probe key spelling: mismatched per-table dictionaries mean codes
    are not comparable across tables, so the host routes decode them first."""
    codec = table.codecs.get(key)
    if codec is None:
        return codes
    out = codec.decode(codes)
    return out if isinstance(out, torch.Tensor) else torch.as_tensor(
        out, device=codes.device)


def _compile_flipped_join(
    engine: RelationalMemoryEngine, shape: QueryShape, o: CompileOptions
) -> PhysicalQuery:
    """Build/probe sides swapped: scan the *right* table per call, keep the
    sorted index (key, probe slot, probe payload) over the *left*.  Each
    right row scatters its payload into the probe slot its key owns — sound
    because the flipped build side is duplicate-free on the key.  Emits the
    standard per-probe-row :class:`JoinResult`."""
    j = shape.join
    s_table, r_table = shape.table, j.right_table
    if not _flip_applicable(shape, o.snapshot_ts):
        raise PlanError(
            "flipped-scan-join needs a duplicate-free single-word non-string "
            "probe-side key and no predicate/snapshot"
        )
    cached = _probe_build_index(s_table, j.key, j.left_proj, FLIP_JOIN_PATH,
                                engine.device)
    rv_view = engine.register(r_table, (j.key, j.right_proj))
    lv = None if cached is not None else engine.register(
        s_table, (j.left_proj, j.key)
    )
    ops = (ProjectOp(rv_view),) if lv is None else (
        ProjectOp(rv_view), ProjectOp(lv)
    )

    def launch(packed):
        r_packed = packed[0]
        rk = _join_probe_key(r_table, j.key,
                             r_packed[:, rv_view.column_words(j.key)[0]])
        rv = r_packed[:, rv_view.column_words(j.right_proj)[0]]
        if cached is not None:
            lk_sorted, slot_sorted, s_vals = cached
        else:
            l_packed = packed[1]
            lk = _join_probe_key(s_table, j.key,
                                 l_packed[:, lv.column_words(j.key)[0]])
            s_vals = l_packed[:, lv.column_words(j.left_proj)[0]]
            order = torch.argsort(lk, stable=True)
            lk_sorted, slot_sorted = lk[order], order.to(torch.int32)
            _insert_build_index((lk_sorted, slot_sorted, s_vals),
                                s_table, j.key, j.left_proj, FLIP_JOIN_PATH)
        n_left = s_vals.shape[0]
        r_proj = torch.zeros(n_left, dtype=rv.dtype, device=rv.device)
        matched = torch.zeros(n_left, dtype=torch.bool, device=rv.device)
        if n_left == 0 or rk.shape[0] == 0:
            return JoinResult(s_proj=s_vals, r_proj=r_proj, matched=matched)
        pos, hit = _lookup_sorted(lk_sorted, rk)
        # only hits scatter: the reference's out-of-range slot (dropped by
        # its scatter) is masked out before the index_put
        slot = slot_sorted[pos][hit].long()
        r_proj[slot] = rv[hit]
        matched[slot] = True
        return JoinResult(s_proj=s_vals, r_proj=r_proj, matched=matched)

    return PhysicalQuery(
        engine, shape, o.path, route="flipped-scan-join", cost=None,
        ops=ops, _launch=launch, _finalize=lambda t: t,
    )


def _mask_join_pred(res: JoinResult, mask: torch.Tensor) -> JoinResult:
    """Apply a probe-side predicate mask to a finished join result — the
    same zero-fill contract as the fused route's ``_finish_join``."""
    return JoinResult(
        s_proj=torch.where(mask, res.s_proj, _zero(res.s_proj)),
        r_proj=torch.where(mask, res.r_proj, _zero(res.r_proj)),
        matched=res.matched & mask,
    )


def _compile_join(
    engine: RelationalMemoryEngine, shape: QueryShape, o: CompileOptions
) -> PhysicalQuery:
    """Equi-join (paper §6 / §8).  On the rme path the compiler chooses
    between three physical routes by modeled bytes (:func:`_join_route`, or
    the caller's ``join_route`` override):

    * ``device-hash-join`` — the build side lives as cached device hash
      buckets (one build per build-table version), and the probe is the
      hash-join kernel over the probe rows — straight from the row-store
      chunks when the join is alone on its table, or on the packed block of
      the tick's shared scan.  The only route that serves a snapshot or a
      probe-side predicate.
    * ``shared-scan-join`` — the paper's §6 sort-probe over slimmed
      {key, payload} blocks.
    * ``flipped-scan-join`` — the sort-probe with sides swapped.
    """
    j = shape.join
    s_table, r_table = shape.table, j.right_table
    path, snapshot_ts = o.path, o.snapshot_ts
    pred_col, pred_op, pred_k = _pred_args(shape.pred)
    dev = engine.device

    if path == "rme":
        route = o.join_route or _join_route(engine, shape, snapshot_ts)
        if shape.pred is not None and route != "device-hash-join":
            raise PlanError(
                "a probe-side join predicate fuses into the probe scan — "
                "device-hash-join only"
            )
        if route == "flipped-scan-join":
            return _compile_flipped_join(engine, shape, o)
        if route == "device-hash-join":
            if pred_col is not None:
                _check_fused_dtypes(s_table, pred_col)
            # probe the partition cache before touching the build side
            partitions = _probe_build_index(
                r_table, j.key, j.right_proj, DEVICE_JOIN_PATH, dev
            )
            sv = engine.register(s_table, (j.left_proj, j.key),
                                 snapshot_ts=snapshot_ts)
            op = JoinOp(sv, j.left_proj, j.key, r_table, j.right_proj,
                        snapshot_ts=snapshot_ts, partitions=partitions,
                        pred_col=pred_col, pred_op=pred_op, pred_k=pred_k)
            return PhysicalQuery(
                engine, shape, path, route="device-hash-join", cost=None,
                ops=(op,),
                _launch=lambda results: results[0], _finalize=lambda t: t,
            )

    # probe the sorted-index cache before touching the build side at all
    cached = _probe_build_index(r_table, j.key, j.right_proj, path, dev)

    if path == "rme":
        # a string key here means the device route was not expressible (the
        # dictionaries differ), and string codes cannot decode into the
        # sort-probe's numeric key space
        if any(t.schema.column(j.key).dtype == "str"
               for t in (s_table, r_table)):
            raise PlanError(
                f"string join key {j.key!r} needs one shared table-level "
                "dictionary on both tables (device hash route)"
            )

        sv = engine.register(s_table, (j.left_proj, j.key))
        rv = None if cached is not None else engine.register(
            r_table, (j.key, j.right_proj)
        )
        ops = (ProjectOp(sv),) if rv is None else (ProjectOp(sv), ProjectOp(rv))

        def launch(packed):
            def read_build():
                r_packed = packed[1]
                return (_join_probe_key(
                            r_table, j.key,
                            r_packed[:, rv.column_words(j.key)[0]]),
                        r_packed[:, rv.column_words(j.right_proj)[0]])

            s_packed = packed[0]
            return _sort_probe(
                _join_probe_key(s_table, j.key,
                                s_packed[:, sv.column_words(j.key)[0]]),
                s_packed[:, sv.column_words(j.left_proj)[0]],
                cached, read_build, r_table, j.key, j.right_proj, path,
            )

        return PhysicalQuery(
            engine, shape, path, route="shared-scan-join", cost=None,
            ops=ops, _launch=launch, _finalize=lambda t: t,
        )

    def launch(_):
        def read_build():
            return (_host_col(r_table, o.right_colstore, j.key, path, dev),
                    _host_col(r_table, o.right_colstore, j.right_proj, path, dev))

        res = _sort_probe(
            _host_col(s_table, o.colstore, j.key, path, dev),
            _host_col(s_table, o.colstore, j.left_proj, path, dev),
            cached, read_build, r_table, j.key, j.right_proj, path,
        )
        if pred_col is not None:
            # host baselines reason in value space: the probe-side predicate
            # evaluates on the decoded column and masks the finished result
            p = _host_col(s_table, o.colstore, pred_col, path, dev)
            res = _mask_join_pred(res, _pred_mask(p, pred_op, pred_k))
        return res

    return PhysicalQuery(
        engine, shape, path, route=f"host-{path}", cost=None, ops=(),
        _launch=launch, _finalize=lambda t: t,
    )


def _compile_multi_join(
    engine: RelationalMemoryEngine, shape: QueryShape, o: CompileOptions
) -> tuple[PhysicalQuery, tuple[tuple[str, str, int], ...]]:
    """A left-deep join chain: cost-ordered device probes over one shared
    probe view.  The chain's joins are independent per probe row, so the
    compiler turns it into N :class:`JoinOp`\\ s over **one** union probe
    view (their probe-side scan requests are identical: one pass) and
    orders the build sides by estimated cold build bytes."""
    if o.path != "rme":
        raise PlanError(
            f"a {len(shape.joins)}-join chain compiles on the rme path only"
            " (host baselines serve single joins)"
        )
    s_table = shape.table
    dev = engine.device
    for spec in shape.joins:
        if not _spec_device_expressible(s_table, spec):
            raise PlanError(
                f"join chain spec on key {spec.key!r} is not "
                "device-expressible (int32/shared-dict single-word keys, "
                "plain 4-byte payloads)"
            )
    pred_col, pred_op, pred_k = _pred_args(shape.pred)
    if pred_col is not None:
        _check_fused_dtypes(s_table, pred_col)

    def build_cost(spec) -> int:
        if _peek_build_entry(spec.right_table, spec.key, spec.right_proj,
                             DEVICE_JOIN_PATH, dev) is not None:
            return 0
        return estimated_partition_bytes(spec.right_table.row_count)

    costs = [build_cost(s) for s in shape.joins]
    order = sorted(range(len(shape.joins)), key=lambda i: (costs[i], i))
    sv = engine.register(s_table, shape.columns, snapshot_ts=o.snapshot_ts)
    ops, slot = [], {}
    for rank, i in enumerate(order):
        spec = shape.joins[i]
        slot[i] = rank
        partitions = _probe_build_index(
            spec.right_table, spec.key, spec.right_proj, DEVICE_JOIN_PATH, dev
        )
        ops.append(JoinOp(sv, spec.left_proj, spec.key, spec.right_table,
                          spec.right_proj, snapshot_ts=o.snapshot_ts,
                          partitions=partitions, pred_col=pred_col,
                          pred_op=pred_op, pred_k=pred_k))
    join_order = tuple(
        (shape.joins[i].key, shape.joins[i].right_proj, costs[i])
        for i in order
    )

    def finalize(results):
        matched = results[0].matched
        for r in results[1:]:
            matched = matched & r.matched
        inner = results[slot[0]]  # the client's first join: the chain's s_proj
        return MultiJoinResult(
            s_proj=torch.where(matched, inner.s_proj, _zero(inner.s_proj)),
            r_projs=tuple(
                torch.where(matched, results[slot[i]].r_proj,
                            _zero(results[slot[i]].r_proj))
                for i in range(len(shape.joins))
            ),
            matched=matched,
        )

    pq = PhysicalQuery(
        engine, shape, o.path, route="device-hash-join", cost=None,
        ops=tuple(ops), _launch=lambda results: results, _finalize=finalize,
    )
    return pq, join_order


def _compile_const_empty(
    engine: RelationalMemoryEngine, shape: QueryShape, o: CompileOptions
) -> PhysicalQuery:
    """Constant-false elimination: a predicate that provably passes no row
    compiles to a zero-op constant result honoring the kind's contract — no
    scan, no bus-beat bytes.  Reported as the ``eliminate-empty`` pass."""
    table = shape.table
    dev = engine.device
    if shape.kind == "aggregate":
        # sum/count/avg over zero rows are all 0.0 (avg guards count with 1)
        return PhysicalQuery(
            engine, shape, o.path, route="const-empty", cost=None, ops=(),
            _launch=lambda _: None, _finalize=lambda t: 0.0,
        )
    if shape.kind == "groupby":
        g = shape.group

        return PhysicalQuery(
            engine, shape, o.path, route="const-empty", cost=None, ops=(),
            _launch=lambda _: None,
            _finalize=lambda t: torch.zeros(g.num_groups, dtype=torch.float32,
                                            device=dev),
        )
    out_words = sum(table.schema.column(c).words for c in shape.columns)

    def launch(_):
        rows = table.row_count  # at launch time, like every other route
        return (torch.zeros((rows, out_words), dtype=torch.int32, device=dev),
                torch.zeros(rows, dtype=torch.bool, device=dev))

    return PhysicalQuery(
        engine, shape, o.path, route="const-empty", cost=None, ops=(),
        _launch=launch, _finalize=lambda t: t,
    )


_LEGACY_COMPILE_KWARGS = (
    "path", "colstore", "right_colstore", "snapshot_ts", "join_route",
    "backend", "stream", "stream_chunk_rows",
)


def compile_plan(
    node: PlanNode | PlanBuilder | RelationalMemoryEngine,
    engine: RelationalMemoryEngine | PlanNode | PlanBuilder | None = None,
    options: CompileOptions | None = None,
    *,
    optimize: bool | None = None,
    **legacy,
) -> PhysicalQuery:
    """Lower a logical plan to a :class:`PhysicalQuery`.

    Canonical spelling::

        compile_plan(plan, engine, options=CompileOptions(...))

    ``options`` carries every compile knob; ``optimize=`` overrides
    ``options.optimize``.  The legacy spelling ``compile_plan(engine, plan,
    path=..., snapshot_ts=..., ...)`` is still accepted, as the reference
    accepts it: the argument order is sniffed, and the old keywords are
    folded into a :class:`CompileOptions` with a :class:`DeprecationWarning`.

    With ``optimize`` on (the default), the optimizer passes canonicalize
    the tree first and the planner adds its own eliminations
    (``eliminate-empty``, the inert-predicate lowering).  The compiled
    query records the before/after trees and the passes that fired.
    """
    if isinstance(node, RelationalMemoryEngine):  # legacy (engine, plan) order
        node, engine = engine, node
    if not isinstance(engine, RelationalMemoryEngine):
        raise TypeError(
            "compile_plan needs a plan and an engine: "
            "compile_plan(plan, engine, options=...)"
        )
    if legacy:
        unknown = set(legacy) - set(_LEGACY_COMPILE_KWARGS)
        if unknown:
            raise TypeError(
                f"compile_plan() got unexpected keyword(s) {sorted(unknown)}"
            )
        if options is not None:
            raise TypeError(
                "pass either options=CompileOptions(...) or the legacy "
                "keywords, not both"
            )
        warnings.warn(
            "compile_plan(engine, plan, path=..., snapshot_ts=..., ...) "
            "keywords are deprecated; pass "
            "options=CompileOptions(...) instead",
            DeprecationWarning, stacklevel=2,
        )
        options = CompileOptions(**legacy)
    o = options if options is not None else CompileOptions()
    if optimize is not None:
        o = dataclasses.replace(o, optimize=optimize)

    if o.path not in ("rme", "row", "col"):
        raise ValueError(f"unknown path {o.path!r}; want rme, row or col")
    if o.backend is not None and o.backend != engine.backend:
        raise PlanError(
            f"plan compiled for backend {o.backend!r} but the engine is "
            f"{engine.backend!r}"
        )
    _check_snapshot_path(o.path, o.snapshot_ts)
    logical = node.node if isinstance(node, PlanBuilder) else node
    tree, applied = (optimize_trace(logical) if o.optimize
                     else (logical, ()))
    shape = decompose(tree)
    if o.stream and shape.kind != "project":
        raise PlanError(
            f"stream=True serves projection-shaped plans only, not "
            f"{shape.kind!r} (scalar/grouped results have nothing to chunk)"
        )
    extra: list[str] = []
    join_order: tuple[tuple[str, str, int], ...] = ()
    if (o.optimize and o.path == "rme" and shape.pred is not None
            and shape.kind in ("project", "aggregate", "groupby")
            and pred_class(shape.table, shape.pred) == "never"):
        pq = _compile_const_empty(engine, shape, o)
        extra.append("eliminate-empty")
    elif shape.kind == "aggregate":
        pq = _compile_aggregate(engine, shape, o)
    elif shape.kind == "groupby":
        pq = _compile_groupby(engine, shape, o)
    elif shape.kind == "join":
        if len(shape.joins) > 1:
            pq, join_order = _compile_multi_join(engine, shape, o)
        else:
            pq = _compile_join(engine, shape, o)
    else:
        pq = _compile_project(engine, shape, o, extra)
    pq.options = o
    pq.logical = logical
    pq.optimized = tree
    pq.passes = tuple(applied) + tuple(extra)
    pq.join_order = join_order
    return pq
