"""Public entry points of the port's RME kernel suite.

One import surface for the engine.  Every function dispatches on the
tensor's device: a CUDA tensor launches the hand-written Hopper kernel
(``csrc/rm_scan.cu``, ``csrc/rm_join.cu``, ``csrc/rm_project.cu``), a CPU
tensor runs the plain PyTorch version beside it.  The paper's three §5.2
revisions (``"bsl"``, ``"pck"``, ``"mlp"``) each have their projection
kernel; the reference's ``"xla"`` revision has no counterpart — the plain
versions play its part on the CPU.
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
from .rme_project import (
    DEFAULT_BLOCK_ROWS,
    REVISIONS,
    project,
    project_torch,
    vmem_footprint_bytes,
)
from .rme_project_multi import project_multi, project_multi_torch
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
from .rme_select import densify, select_compact, select_compact_torch


def check_revision(revision: str) -> None:
    if revision == "xla":
        raise ValueError(
            "the port has no 'xla' revision: the plain PyTorch versions play "
            f"its part on the CPU (device='cpu'); want one of {REVISIONS}")
    if revision not in REVISIONS:
        raise ValueError(f"unknown revision {revision!r}; want one of {REVISIONS}")


def project_any(
    words: torch.Tensor,
    geom: TableGeometry,
    revision: str = "mlp",
) -> torch.Tensor:
    """Dispatch projection to the revision's kernel."""
    check_revision(revision)
    return project(words, geom, revision)


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
    "densify",
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
    "project_multi",
    "project_multi_torch",
    "project_torch",
    "reduced_result_bytes",
    "request_intervals",
    "scan_multi",
    "scan_multi_torch",
    "scan_vmem_footprint_bytes",
    "select_compact",
    "select_compact_torch",
    "union_geometry",
    "vmem_footprint_bytes",
]
