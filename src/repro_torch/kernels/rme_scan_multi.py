"""Heterogeneous one-pass scan — the port of ``repro.kernels.rme_scan_multi``.

A *scan request* describes what one consumer wants from a table's row-store
stream: a packed projection (:class:`ProjectRequest`), a filtered packed
block plus validity mask (:class:`FilterRequest`), a float32 ``[sum,
count]`` pair (:class:`AggregateRequest`) or per-group partials
(:class:`GroupByRequest`).  :func:`scan_multi` serves any mix of them in one
pass: on a CUDA tensor it launches ``rm_scan_multi_kernel``
(``csrc/rm_scan.cu``, the Hopper form of ``_scan_multi_kernel``), which
stages each row tile once and emits every request's output from it; on a CPU
tensor it runs :func:`scan_multi_torch`, the torch form of the reference's
``scan_multi_xla`` (one gather of the union of enabled words, then
per-request compute out of that shared array).

Byte accounting follows the union discipline: :func:`union_geometry` builds
the one accounting geometry covering every request's enabled words, so the
engine charges a fused pass's bus beats once.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.schema import WORD, TableGeometry, geometry_from_intervals

from . import _cuda
from .common import (
    DEFAULT_BLOCK_ROWS,
    geometry_words,
    group_sum_count,
    pred_k_bits,
    row_mask,
    sum_count,
)


# ------------------------------------------------------------ scan requests
@dataclasses.dataclass(frozen=True)
class ProjectRequest:
    """A packed column-group block: ``(N, out_words)`` int32."""

    geom: TableGeometry


@dataclasses.dataclass(frozen=True)
class FilterRequest:
    """Packed block with failing rows zeroed + bool validity mask."""

    geom: TableGeometry
    pred_word: int
    pred_dtype: str = "int32"
    pred_op: str = "gt"
    pred_k: int | float = 0
    ts_word: int = -1  # >= 0 fuses the MVCC snapshot test
    ts: int = 0


@dataclasses.dataclass(frozen=True)
class AggregateRequest:
    """``[sum, count]`` float32 pair over the predicate-passing rows."""

    agg_word: int
    agg_dtype: str = "int32"
    pred_word: int = 0
    pred_dtype: str = "int32"
    pred_op: str = "none"
    pred_k: int | float = 0
    ts_word: int = -1
    ts: int = 0


@dataclasses.dataclass(frozen=True)
class GroupByRequest:
    """Per-group ``(sums[G], counts[G])`` over a static group domain."""

    group_word: int
    agg_word: int
    num_groups: int
    agg_dtype: str = "int32"
    pred_word: int = 0
    pred_dtype: str = "int32"
    pred_op: str = "none"
    pred_k: int | float = 0
    ts_word: int = -1
    ts: int = 0


ScanRequest = ProjectRequest | FilterRequest | AggregateRequest | GroupByRequest


def _strip_dynamic(req: ScanRequest) -> ScanRequest:
    """The request with its runtime operands (predicate constant, snapshot
    time) and the geometry's ``row_count`` normalized away — the request's
    *shape*, which keys the engine's circuit-breaker routes as in the
    reference (where it is also the kernel's trace key)."""
    if isinstance(req, (ProjectRequest, FilterRequest)):
        req = dataclasses.replace(
            req, geom=dataclasses.replace(req.geom, row_count=0))
    if isinstance(req, ProjectRequest):
        return req
    return dataclasses.replace(req, pred_k=0, ts=0)


def request_intervals(req: ScanRequest) -> list[tuple[int, int]]:
    """Byte intervals of the row-store words this request enables.

    This is the request's footprint on the Fetch-Unit stream: projected
    columns, the predicate word, the aggregate/group words, and the two
    hidden MVCC timestamp words when a snapshot test is fused.  The engine
    merges these across a batch into the one union accounting geometry.
    """
    spans: list[tuple[int, int]] = []
    if isinstance(req, (ProjectRequest, FilterRequest)):
        spans.extend(zip(req.geom.abs_offsets, req.geom.col_widths))
    if isinstance(req, AggregateRequest):
        spans.append((req.agg_word * WORD, WORD))
    if isinstance(req, GroupByRequest):
        spans.append((req.group_word * WORD, WORD))
        spans.append((req.agg_word * WORD, WORD))
    if not isinstance(req, ProjectRequest):
        if req.pred_op != "none":
            spans.append((req.pred_word * WORD, WORD))
        if req.ts_word >= 0:
            spans.append((req.ts_word * WORD, 2 * WORD))
    return spans


def union_geometry(
    requests: Sequence[ScanRequest], row_bytes: int, row_count: int
) -> TableGeometry:
    """The one accounting geometry covering every request's enabled words.

    Overlapping/adjacent intervals collapse into single burst chains via the
    shared charging rule (:func:`repro_torch.core.schema.
    geometry_from_intervals`) — the fused pass's bus beats are charged once
    for the whole batch.
    """
    intervals = [
        (o, w) for req in requests for o, w in request_intervals(req)
    ]
    if not intervals:
        raise ValueError("union_geometry needs at least one enabled word")
    return geometry_from_intervals(intervals, row_bytes=row_bytes,
                                   row_count=row_count)


def scan_vmem_footprint_bytes(
    requests: Sequence[ScanRequest], row_words: int,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> int:
    """Modeled VMEM working set of one fused grid step (2 MB SPM budget) of
    the reference kernel — the engine's tile guard model, not the CUDA
    kernel's shared-memory use.

    The row tile and every blocked output are double-buffered (Pallas
    pipeline); accumulator outputs (aggregates, group-by partials) are tiny
    and resident for the whole pass.
    """
    total = 2 * block_rows * row_words * 4  # double-buffered row tile
    for req in requests:
        if isinstance(req, ProjectRequest):
            total += 2 * block_rows * req.geom.out_words_per_row * 4
        elif isinstance(req, FilterRequest):
            total += 2 * block_rows * (req.geom.out_words_per_row + 1) * 4
        elif isinstance(req, AggregateRequest):
            total += 2 * 4
        else:
            total += req.num_groups * 2 * 4
    return total


def _check_requests(row_words: int, requests: Sequence[ScanRequest]) -> None:
    if not requests:
        raise ValueError("scan_multi needs at least one request")
    for req in requests:
        if isinstance(req, (ProjectRequest, FilterRequest)):
            if row_words < req.geom.row_words:
                raise ValueError(
                    f"storage rows {row_words}w < geometry rows {req.geom.row_words}w"
                )


# ------------------------------------------------------------- CUDA kernel
def kernel_request(req: ScanRequest) -> _cuda.KernelReq:
    """The request as the CUDA kernels take it."""
    if isinstance(req, ProjectRequest):
        return _cuda.KernelReq(_cuda.PROJECT, tuple(geometry_words(req.geom)))
    pred = dict(pred_word=req.pred_word,
                pred_float=_cuda.dtype_flag(req.pred_dtype),
                pred_op=req.pred_op,
                k_bits=pred_k_bits(req.pred_k, req.pred_dtype),
                ts_word=req.ts_word, ts=req.ts)
    if isinstance(req, FilterRequest):
        return _cuda.KernelReq(_cuda.FILTER, tuple(geometry_words(req.geom)),
                               **pred)
    agg = dict(agg_word=req.agg_word, agg_float=_cuda.dtype_flag(req.agg_dtype))
    if isinstance(req, AggregateRequest):
        return _cuda.KernelReq(_cuda.AGGREGATE, **pred, **agg)
    return _cuda.KernelReq(_cuda.GROUPBY, **pred, **agg,
                           group_word=req.group_word,
                           num_groups=req.num_groups)


def scan_multi(words: torch.Tensor, requests: Sequence[ScanRequest]) -> list:
    """One row-store pass serving a heterogeneous request batch.

    Returns one result per request, in order, each matching its single-op
    contract: ``(N, out_words)`` packed blocks for projections, ``(packed,
    bool mask)`` pairs for filters, float32 ``[sum, count]`` for aggregates,
    and ``(sums[G], counts[G])`` for group-bys.  The predicate constants and
    snapshot times are runtime operands of the kernel.
    """
    if words.device.type == "cpu":
        return scan_multi_torch(words, requests)
    _check_requests(words.shape[1], requests)
    return _cuda.run("scan_multi", words, [kernel_request(r) for r in requests])


# ------------------------------------------------------------ plain version
def scan_multi_torch(words: torch.Tensor,
                     requests: Sequence[ScanRequest]) -> list:
    """Plain PyTorch one-pass scan: gather the union of enabled words once,
    then compute every request's output from that shared array."""
    _check_requests(words.shape[1], requests)
    union = sorted({off // WORD + j for req in requests
                    for off, w in request_intervals(req) for j in range(w // WORD)})
    pos = {word: i for i, word in enumerate(union)}
    shared = words.index_select(
        1, torch.tensor(union, dtype=torch.long, device=words.device))

    def col(word: int) -> torch.Tensor:
        return shared[:, pos[word]]

    def mask_of(req) -> torch.Tensor:
        # only the words the request enables are in `shared`: remap them
        # into its columns and test there
        k_bits = pred_k_bits(req.pred_k, req.pred_dtype)
        return row_mask(shared, pos.get(req.pred_word, 0), req.pred_dtype,
                        req.pred_op, k_bits,
                        pos[req.ts_word] if req.ts_word >= 0 else -1, req.ts)

    def packed_of(geom: TableGeometry) -> torch.Tensor:
        idx = [pos[word] for word in geometry_words(geom)]
        return shared.index_select(
            1, torch.tensor(idx, dtype=torch.long, device=words.device))

    results = []
    for req in requests:
        if isinstance(req, ProjectRequest):
            results.append(packed_of(req.geom))
            continue
        mask = mask_of(req)
        if isinstance(req, FilterRequest):
            packed = packed_of(req.geom)
            results.append((torch.where(mask[:, None], packed,
                                        torch.zeros_like(packed)), mask))
        elif isinstance(req, AggregateRequest):
            results.append(sum_count(col(req.agg_word), req.agg_dtype, mask))
        else:
            results.append(group_sum_count(col(req.group_word), col(req.agg_word),
                                           req.agg_dtype, mask, req.num_groups))
    return results


# ----------------------------------------------------------- chunk combine
def combine_chunk_outputs(req: ScanRequest, parts: Sequence) -> object:
    """Merge one request's per-chunk outputs into its whole-table result.

    Blocked outputs (projections, filters) are row-local, so rows of chunk k
    land at their global offsets by concatenation; aggregate and group-by
    partials are associative and add.  MVCC snapshot tests are per row, so
    chunk boundaries never change visibility.
    """
    if isinstance(req, ProjectRequest):
        return torch.cat(list(parts), dim=0)
    if isinstance(req, FilterRequest):
        return (torch.cat([p[0] for p in parts], dim=0),
                torch.cat([p[1] for p in parts], dim=0))
    if isinstance(req, AggregateRequest):
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total
    sums, counts = parts[0]
    for s, c in parts[1:]:
        sums, counts = sums + s, counts + c
    return sums, counts


def scan_shard(chunks: Sequence[torch.Tensor],
               requests: Sequence[ScanRequest]) -> list[list]:
    """One shard's fused pass: an ordinary :func:`scan_multi` over each of
    its resident chunks, on the chunk's own device, with the per-chunk
    outputs left **uncombined** (``[chunk][request]``).

    The sharded engine needs that granularity: blocked outputs go back to
    global row order through each chunk's ownership segments, and reduced
    partials combine shard-locally before anything crosses shards.
    """
    return [scan_multi(chunk, requests) for chunk in chunks]


def reduced_result_bytes(req: ScanRequest) -> int | None:
    """Bytes of one request's *reduced* partial, or ``None`` for blocked kinds
    (the unit of the sharded backend's interconnect accounting: an aggregate
    ships its float32 ``[sum, count]`` pair, a group-by its ``(G, 2)``
    partial; blocked outputs are charged to ``bytes_to_cpu`` instead)."""
    if isinstance(req, AggregateRequest):
        return 2 * 4
    if isinstance(req, GroupByRequest):
        return req.num_groups * 2 * 4
    return None
