"""Packed projection — the port of ``repro.kernels.rme_project``: the
paper's three §5.2 datapath revisions.

``project`` copies the enabled word ranges of each row into an
``(N, out_words)`` int32 block.  On a CUDA tensor it launches the
revision's kernel:

* ``"mlp"`` — ``rm_project_kernel`` (``csrc/rm_scan.cu``, the Hopper form of
  ``_mlp_kernel``): whole row tiles staged with coalesced loads; rows wider
  than ``_cuda.DIRECT_ROW_WORDS`` take ``rm_project_spans_kernel``
  (``csrc/rm_spans.cu``), which copies the column ranges
  (:func:`span_plan`) with aligned 16-byte transfers;
* ``"pck"`` — ``rm_project_pck_kernel`` (``csrc/rm_project.cu``, from
  ``_pck_kernel``): column chunks gathered into a shared-memory packer, one
  store of the packed tile; rows wider than ``_cuda.DIRECT_ROW_WORDS`` take
  ``rm_project_pck_wide_kernel``, whose blocks walk (row tile, packed range)
  items (``_cuda.pck_plan``), gather each range column by column with
  aligned 16-byte loads into one of two packers, and store it by bulk
  copies while the next range is gathered into the other;
* ``"bsl"`` — ``rm_project_bsl_kernel`` (``csrc/rm_project.cu``, from
  ``_bsl_kernel``): one column per block, stored straight into the output;
  rows wider than ``_cuda.DIRECT_ROW_WORDS`` take
  ``rm_project_bsl_wide_kernel`` (chunks of a column, ``_cuda.bsl_plan``).

On a CPU tensor every revision runs :func:`project_torch`, the one plain
version (the revisions compute the same function).  There is no fallback
between the two: a CUDA tensor gets the kernel or an error.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.schema import TableGeometry

from . import _cuda
from .common import DEFAULT_BLOCK_ROWS, column_slices, geometry_words

__all__ = ["DEFAULT_BLOCK_ROWS", "REVISIONS", "project", "project_torch", "span_plan",
           "vmem_footprint_bytes"]

# the paper's §5.2 revisions, baseline first; "mlp" is the production one
REVISIONS = ("bsl", "pck", "mlp")


def _check_geometry(words: torch.Tensor, geom: TableGeometry) -> None:
    if words.shape[1] < geom.row_words:
        raise ValueError(
            f"storage rows {words.shape[1]}w < geometry rows {geom.row_words}w")


def project_torch(words: torch.Tensor, geom: TableGeometry) -> torch.Tensor:
    """Plain PyTorch packed projection (one gather of the enabled words)."""
    _check_geometry(words, geom)
    idx = torch.tensor(geometry_words(geom), dtype=torch.long, device=words.device)
    return words.index_select(1, idx)


def span_plan(geom: TableGeometry, row_words: int) -> _cuda.SpanPlan:
    """The span kernel's plan for ``geom``'s columns over rows of
    ``row_words`` storage words, kept for the last ``_cuda.SPAN_PLANS``
    layouts: the key is the geometry's layout (:meth:`TableGeometry.
    layout_key`: the row width and the column ranges) and ``row_words`` —
    no row count, snapshot time or predicate constant — so a repeated
    projection, also after an append, plans nothing."""
    return _layout_plan(geom.layout_key(), row_words)


@functools.lru_cache(maxsize=_cuda.SPAN_PLANS)
def _layout_plan(layout: tuple, row_words: int) -> _cuda.SpanPlan:
    row_bytes, widths, offsets, frame = layout
    geom = TableGeometry(row_bytes, 0, widths, offsets, frame, max_columns=len(widths))
    return _cuda.span_plan(column_slices(geom), row_words, geom.out_words_per_row)


@functools.lru_cache(maxsize=_cuda.SPAN_PLANS)
def _layout_slices(layout: tuple) -> tuple[tuple[int, int, int], ...]:
    """``column_slices`` of a layout (BSL's and PCK's launches), kept as
    the span plans are."""
    row_bytes, widths, offsets, frame = layout
    geom = TableGeometry(row_bytes, 0, widths, offsets, frame, max_columns=len(widths))
    return tuple(map(tuple, column_slices(geom)))


def project(words: torch.Tensor, geom: TableGeometry,
            revision: str = "mlp") -> torch.Tensor:
    """Packed projection ``(N, row_words) -> (N, out_words)`` via the RME's
    ``revision`` datapath (``"bsl"``, ``"pck"`` or ``"mlp"``).

    ``words.shape[1]`` may exceed ``geom.row_words``: the hidden MVCC words
    ride along in storage but are never shipped unless enabled."""
    if revision not in REVISIONS:
        raise ValueError(f"unknown RME revision {revision!r}; want one of {REVISIONS}")
    if words.is_cpu:
        return project_torch(words, geom)
    _check_geometry(words, geom)
    if revision == "mlp":
        row_words = words.shape[1]
        if row_words > _cuda.DIRECT_ROW_WORDS:
            return _cuda.run_spans(words, span_plan(geom, row_words))
        req = _cuda.KernelReq(_cuda.PROJECT, tuple(geometry_words(geom)))
        return _cuda.run("project", words, [req])[0]
    return _cuda.run_columns(f"project_{revision}", words, _layout_slices(geom.layout_key()),
                             geom.out_words_per_row)


def vmem_footprint_bytes(
    geom: TableGeometry, block_rows: int = DEFAULT_BLOCK_ROWS, revision: str = "mlp"
) -> int:
    """Modeled VMEM working set of one grid step (the 'data SPM' budget) of
    the reference package's kernels — a model kept for the engine's
    accounting, not the CUDA kernels' shared-memory use.

    MLP double-buffers the row tile (Pallas pipeline) and holds the packed
    output block; PCK adds the packer scratch; BSL holds a row tile + output.
    """
    row_tile = block_rows * geom.row_words * 4
    out_tile = block_rows * geom.out_words_per_row * 4
    if revision == "mlp":
        return 2 * row_tile + 2 * out_tile  # double-buffered in and out
    if revision == "pck":
        return row_tile + 2 * out_tile
    return row_tile + out_tile
