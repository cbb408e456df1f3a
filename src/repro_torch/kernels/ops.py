"""Public entry points of the port's RME kernel suite.

One import surface for the engine.  Every function dispatches on the
tensor's device: a CUDA tensor launches the hand-written Hopper kernel
(``csrc/rm_scan.cu``, ``csrc/rm_join.cu``), a CPU tensor runs the plain
PyTorch version beside it.
Only the paper's production revision, ``"mlp"``, is ported; the BSL and PCK
revisions are still to port (ROADMAP queue 2), and the reference's ``"xla"``
revision has no counterpart — the plain versions play its part on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core.schema import TableGeometry

from .rme_aggregate import aggregate, aggregate_torch, groupby_sum, groupby_sum_torch
from .rme_filter import filter_project, filter_project_torch
from .rme_join import (
    JoinPartitions,
    build_partitions,
    estimated_partition_bytes,
    hash_join,
    hash_join_torch,
    partitions_from_numpy,
    probe_vmem_footprint_bytes,
)
from .rme_project import DEFAULT_BLOCK_ROWS, project, project_torch, vmem_footprint_bytes
from .rme_scan_multi import (
    AggregateRequest,
    FilterRequest,
    GroupByRequest,
    ProjectRequest,
    combine_chunk_outputs,
    reduced_result_bytes,
    request_intervals,
    scan_multi,
    scan_multi_torch,
    scan_vmem_footprint_bytes,
    union_geometry,
)

REVISIONS = ("mlp",)


def check_revision(revision: str) -> None:
    if revision not in REVISIONS:
        raise ValueError(
            f"revision {revision!r} is not ported (ROADMAP queue 2 lists the "
            f"bsl/pck kernels); the port has {REVISIONS}"
        )


def project_any(
    words: torch.Tensor,
    geom: TableGeometry,
    revision: str = "mlp",
) -> torch.Tensor:
    """Dispatch projection across the ported revisions."""
    check_revision(revision)
    return project(words, geom)


__all__ = [
    "REVISIONS",
    "DEFAULT_BLOCK_ROWS",
    "AggregateRequest",
    "FilterRequest",
    "GroupByRequest",
    "JoinPartitions",
    "ProjectRequest",
    "aggregate",
    "aggregate_torch",
    "build_partitions",
    "check_revision",
    "combine_chunk_outputs",
    "estimated_partition_bytes",
    "filter_project",
    "filter_project_torch",
    "groupby_sum",
    "groupby_sum_torch",
    "hash_join",
    "hash_join_torch",
    "partitions_from_numpy",
    "probe_vmem_footprint_bytes",
    "project",
    "project_any",
    "project_torch",
    "reduced_result_bytes",
    "request_intervals",
    "scan_multi",
    "scan_multi_torch",
    "scan_vmem_footprint_bytes",
    "union_geometry",
    "vmem_footprint_bytes",
]
