"""Fused selection + aggregation and group-by — the port of
``repro.kernels.rme_aggregate``.

``aggregate`` is ``SELECT SUM(a), COUNT(*) FROM t WHERE pred(b)`` as a
float32 ``[sum, count]`` pair; ``groupby_sum`` is the per-group version over
floored-modulo group ids.  MVCC snapshots are fused when ``ts_word >= 0``.
On a CUDA tensor they launch ``rm_aggregate_kernel`` / ``rm_groupby_kernel``
(``csrc/rm_scan.cu``, the Hopper forms of ``_agg_kernel`` and
``_groupby_kernel``); on a CPU tensor they run the ``*_torch`` versions.
Sums accumulate in float32, as on the TPU.
"""

from __future__ import annotations

import torch

from . import _cuda
from .common import group_sum_count, pred_k_bits, row_mask, sum_count


def aggregate_torch(
    words: torch.Tensor,
    agg_word: int,
    agg_dtype: str = "int32",
    pred_word: int = 0,
    pred_dtype: str = "int32",
    pred_op: str = "none",
    pred_k=0,
    ts: int = 0,
    ts_word: int = -1,
) -> torch.Tensor:
    """Plain PyTorch version: float32 ``[sum, count]``."""
    mask = row_mask(words, pred_word, pred_dtype, pred_op,
                    pred_k_bits(pred_k, pred_dtype), ts_word, ts)
    return sum_count(words[:, agg_word], agg_dtype, mask)


def aggregate(
    words: torch.Tensor,
    agg_word: int,
    agg_dtype: str = "int32",
    pred_word: int = 0,
    pred_dtype: str = "int32",
    pred_op: str = "none",
    pred_k=0,
    ts: int = 0,
    ts_word: int = -1,
) -> torch.Tensor:
    """``SELECT SUM(a), COUNT(*) FROM t WHERE pred(b)`` fused in the engine.

    Returns float32 ``[sum, count]``.  ``ts_word >= 0`` enables the fused MVCC
    snapshot test against storage words ``ts_word`` / ``ts_word + 1``.
    """
    if words.device.type == "cpu":
        return aggregate_torch(words, agg_word, agg_dtype, pred_word, pred_dtype,
                               pred_op, pred_k, ts, ts_word)
    req = _cuda.KernelReq(
        _cuda.AGGREGATE, pred_word=pred_word,
        pred_float=_cuda.dtype_flag(pred_dtype), pred_op=pred_op,
        k_bits=pred_k_bits(pred_k, pred_dtype), ts_word=ts_word, ts=ts,
        agg_word=agg_word, agg_float=_cuda.dtype_flag(agg_dtype),
    )
    return _cuda.run("aggregate", words, [req])[0]


def groupby_sum_torch(
    words: torch.Tensor,
    group_word: int,
    agg_word: int,
    num_groups: int,
    agg_dtype: str = "int32",
    pred_word: int = 0,
    pred_dtype: str = "int32",
    pred_op: str = "none",
    pred_k=0,
    ts: int = 0,
    ts_word: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(sums[G], counts[G])`` float32."""
    mask = row_mask(words, pred_word, pred_dtype, pred_op,
                    pred_k_bits(pred_k, pred_dtype), ts_word, ts)
    return group_sum_count(words[:, group_word], words[:, agg_word], agg_dtype,
                           mask, num_groups)


def groupby_sum(
    words: torch.Tensor,
    group_word: int,
    agg_word: int,
    num_groups: int,
    agg_dtype: str = "int32",
    pred_word: int = 0,
    pred_dtype: str = "int32",
    pred_op: str = "none",
    pred_k=0,
    ts: int = 0,
    ts_word: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``SELECT SUM(a), COUNT(*) ... GROUP BY g``: ``(sums[G], counts[G])``.

    The group key domain is ``g mod G`` (floored), with a static G."""
    if words.device.type == "cpu":
        return groupby_sum_torch(words, group_word, agg_word, num_groups,
                                 agg_dtype, pred_word, pred_dtype, pred_op,
                                 pred_k, ts, ts_word)
    req = _cuda.KernelReq(
        _cuda.GROUPBY, pred_word=pred_word,
        pred_float=_cuda.dtype_flag(pred_dtype), pred_op=pred_op,
        k_bits=pred_k_bits(pred_k, pred_dtype), ts_word=ts_word, ts=ts,
        agg_word=agg_word, agg_float=_cuda.dtype_flag(agg_dtype),
        group_word=group_word, num_groups=num_groups,
    )
    return _cuda.run("groupby_sum", words, [req])[0]
