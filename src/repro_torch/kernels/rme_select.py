"""Near-memory selection with compaction — the port of
``repro.kernels.rme_select``.

``select_compact`` ships only the rows that pass: the table is cut into
contract blocks of ``block_rows`` rows, and each block's passing rows are
packed, moved to the front of the block in their original order, and the
rest of the block zero-filled, beside a per-block count::

    blocks (ceil(N / block_rows), block_rows, out_words) int32
    counts (ceil(N / block_rows),) int32

A row passes when the predicate holds and, with ``ts_word >= 0``, it is
visible at snapshot ``ts``.  On a CUDA tensor ``select_compact`` launches
``rm_select_compact_kernel`` (``csrc/rm_project.cu``, the Hopper form of
``_select_kernel``: one CUDA block per contract block, warp ballots in place
of the reference's stable argsort); the rows past ``N`` in the last block
are masked, never copied.  On a CPU tensor it runs
:func:`select_compact_torch`.  :func:`densify` concatenates the block
prefixes into one dense relation (plain torch, as the reference's is plain
``jnp``).
"""

from __future__ import annotations

import torch

from repro_torch.core.schema import TableGeometry

from . import _cuda
from .common import DEFAULT_BLOCK_ROWS, geometry_words, pred_k_bits, row_mask

__all__ = ["densify", "select_compact", "select_compact_torch"]


def _check(words: torch.Tensor, block_rows: int, pred_op: str) -> None:
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    if pred_op not in _cuda.PRED_OPS:
        raise ValueError(pred_op)
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"want (N, row_words) int32 words, got {words.dtype} "
                         f"{tuple(words.shape)}")


def select_compact_torch(
    words: torch.Tensor,
    geom: TableGeometry,
    pred_word: int,
    pred_dtype: str = "int32",
    pred_op: str = "gt",
    pred_k=0,
    ts: int = 0,
    ts_word: int = -1,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the mask and the packed rows of the whole
    table, then each passing row's slot from a running count per block."""
    _check(words, block_rows, pred_op)
    n = words.shape[0]
    n_blocks = -(-n // block_rows)
    mask = row_mask(words, pred_word, pred_dtype, pred_op,
                    pred_k_bits(pred_k, pred_dtype), ts_word, ts)
    idx = torch.tensor(geometry_words(geom), dtype=torch.long, device=words.device)
    packed = words.index_select(1, idx)
    block = torch.arange(n, device=words.device) // block_rows
    keep = mask.to(torch.int64)
    counts = torch.zeros(n_blocks, dtype=torch.int64, device=words.device)
    counts.index_add_(0, block, keep)
    # rank of each passing row within its block, in row order
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.cumsum(keep, 0) - keep - starts[block]
    out = torch.zeros((n_blocks * block_rows, idx.numel()), dtype=torch.int32,
                      device=words.device)
    out[(block * block_rows + rank)[mask]] = packed[mask]
    return (out.view(n_blocks, block_rows, idx.numel()),
            counts.to(torch.int32))


def select_compact(
    words: torch.Tensor,
    geom: TableGeometry,
    pred_word: int,
    pred_dtype: str = "int32",
    pred_op: str = "gt",
    pred_k=0,
    ts: int = 0,
    ts_word: int = -1,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(blocks (n_blocks, block_rows, out_w), counts (n_blocks,))``.

    ``blocks[b, :counts[b]]`` are the packed projections of the passing rows
    of block ``b`` in original order; the rest of the block is zero."""
    if words.device.type == "cpu":
        return select_compact_torch(words, geom, pred_word, pred_dtype, pred_op,
                                    pred_k, ts, ts_word, block_rows)
    _check(words, block_rows, pred_op)
    req = _cuda.KernelReq(
        _cuda.PROJECT, tuple(geometry_words(geom)), pred_word=pred_word,
        pred_float=_cuda.dtype_flag(pred_dtype), pred_op=pred_op,
        k_bits=pred_k_bits(pred_k, pred_dtype), ts_word=ts_word, ts=ts)
    return _cuda.run_select(words, req, block_rows)


def densify(blocks: torch.Tensor, counts: torch.Tensor, total: int) -> torch.Tensor:
    """Concatenate block prefixes into one dense ``(total, out_w)`` relation.

    ``total`` is a bound (``>= counts.sum()``); surplus rows are zero.  One
    scatter over global positions, as the reference's ``densify``."""
    n_blocks, block_rows, out_w = blocks.shape
    counts = counts.to(torch.int64)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(block_rows, device=blocks.device)
    valid = slot[None, :] < counts[:, None]
    dest = (starts[:, None] + slot[None, :])[valid]
    out = torch.zeros((total, out_w), dtype=blocks.dtype, device=blocks.device)
    keep = dest < total
    out[dest[keep]] = blocks[valid][keep]
    return out
