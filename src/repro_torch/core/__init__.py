"""Relational Memory core on PyTorch: the port of ``repro.core``.

Layers (bottom-up):
  schema      — table layouts + RME geometry (configuration port, Table 1)
  descriptor  — Requestor Eq. (1)-(3): the bus-beat bytes a scan moves
  compression — dictionary + delta/FOR codecs (paper §4)
  table       — row-major MVCC row store (the single source of truth)
  ephemeral   — ephemeral variables (lazy column-group views)
  requests    — project / filter / aggregate / group-by / join scan ops
  engine      — the RME: epoch-validated reorg cache + delta-chunked device
                row store + the batch path onto the CUDA kernels
  executor    — BatchExecutor: coalesce pending ops, one shared scan/table
  plan        — logical plan IR (Scan/Filter/Project/Aggregate/GroupBy/Join)
  optimizer   — logical rewrite passes (pushdown, pruning, pred normalization)
  planner     — byte-cost path selection + compile_plan: plan -> PhysicalQuery
  operators   — Q0-Q5 over interchangeable rme/row/col access paths
  faults      — deterministic fault injection + lowering circuit breaker
  wal         — checksummed write-ahead log for crash-consistent writes
  distributed — the sharded backend (ShardedRowStore + ShardedEngine) and
                the free dist_* operators
"""

from .schema import (
    MAX_ENABLED_COLUMNS, WORD, Column, TableGeometry, TableSchema,
    benchmark_schema, geometry_from_intervals, merge_geometries,
)
from .table import TS_INF, RelationalTable, columnar_copy
from .descriptor import BUS_WIDTH, bytes_moved
from .ephemeral import EphemeralView
from .requests import (
    AggregateOp, FilterOp, GroupByOp, JoinOp, JoinResult, MultiJoinResult,
    ProjectOp, ScanOp,
)
from .engine import DeviceRowStore, EngineStats, PassHandle, RelationalMemoryEngine, ReorgCache
from .executor import BatchExecutor, execute_batch, materialize_batch
from .plan import (
    Aggregate, Filter, GroupBy, Join, PlanBuilder, PlanError, PlanNode,
    Project, Scan, decompose, plan,
)
from .optimizer import PASSES, Rewrite, optimize, optimize_trace, pred_class
from .planner import CompileOptions, PhysicalQuery, compile_plan
from .faults import (
    CircuitBreaker, FaultError, FaultPlan, PermanentFault, TransientFault,
    fault_plan,
)
from .wal import WriteAheadLog
from .distributed import ShardedEngine, ShardedRowStore, shard_ranges
from . import (compression, distributed, executor, faults, operators, optimizer,
               planner, wal)

__all__ = [
    "BUS_WIDTH", "MAX_ENABLED_COLUMNS", "WORD", "TS_INF",
    "Column", "TableSchema", "TableGeometry", "benchmark_schema",
    "geometry_from_intervals", "merge_geometries",
    "RelationalTable", "columnar_copy", "bytes_moved",
    "EphemeralView", "DeviceRowStore", "EngineStats", "PassHandle",
    "RelationalMemoryEngine", "ReorgCache", "BatchExecutor", "execute_batch",
    "materialize_batch",
    "AggregateOp", "FilterOp", "GroupByOp", "JoinOp", "JoinResult",
    "MultiJoinResult", "ProjectOp", "ScanOp",
    "Aggregate", "Filter", "GroupBy", "Join", "PlanBuilder", "PlanError",
    "PlanNode", "Project", "Scan", "decompose", "plan",
    "PASSES", "Rewrite", "optimize", "optimize_trace", "pred_class",
    "CompileOptions", "PhysicalQuery", "compile_plan",
    "CircuitBreaker", "FaultError", "FaultPlan", "PermanentFault",
    "TransientFault", "fault_plan", "WriteAheadLog",
    "ShardedEngine", "ShardedRowStore", "shard_ranges",
    "compression", "distributed", "executor", "faults", "operators",
    "optimizer", "planner", "wal",
]
