"""Relational Memory core on PyTorch: the port of ``repro.core``'s engine
batch path.

Layers (bottom-up):
  schema      — table layouts + RME geometry (configuration port, Table 1)
  descriptor  — Requestor Eq. (1)-(3): the bus-beat bytes a scan moves
  compression — dictionary + delta/FOR codecs (paper §4)
  table       — row-major MVCC row store (the single source of truth)
  ephemeral   — ephemeral variables (lazy column-group views)
  requests    — project / filter / aggregate / group-by scan ops
  engine      — the RME: epoch-validated reorg cache + delta-chunked device
                row store + the batch path onto the CUDA scan kernels
  executor    — BatchExecutor: coalesce pending ops, one shared scan/table
"""

from .schema import (
    MAX_ENABLED_COLUMNS, WORD, Column, TableGeometry, TableSchema,
    benchmark_schema, geometry_from_intervals,
)
from .table import TS_INF, RelationalTable
from .descriptor import BUS_WIDTH, bytes_moved
from .ephemeral import EphemeralView
from .requests import AggregateOp, FilterOp, GroupByOp, ProjectOp, ScanOp
from .engine import DeviceRowStore, EngineStats, PassHandle, RelationalMemoryEngine, ReorgCache
from .executor import BatchExecutor, execute_batch, materialize_batch
from . import compression, executor

__all__ = [
    "BUS_WIDTH", "MAX_ENABLED_COLUMNS", "WORD", "TS_INF",
    "Column", "TableSchema", "TableGeometry", "benchmark_schema",
    "geometry_from_intervals", "RelationalTable", "bytes_moved",
    "EphemeralView", "DeviceRowStore", "EngineStats", "PassHandle",
    "RelationalMemoryEngine", "ReorgCache", "BatchExecutor", "execute_batch",
    "materialize_batch",
    "AggregateOp", "FilterOp", "GroupByOp", "ProjectOp", "ScanOp",
    "compression", "executor",
]
