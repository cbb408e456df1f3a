"""Fused selection + projection — the port of ``repro.kernels.rme_filter``.

``SELECT A1 FROM t WHERE A3 > k``: the packed column group with rows that
fail the predicate (or the MVCC snapshot test) zeroed, plus a bool validity
mask.  Row positions are preserved, as in the reference.  On a CUDA tensor
``filter_project`` launches ``rm_filter_kernel`` (``csrc/rm_scan.cu``, the
Hopper form of ``_filter_kernel``); on a CPU tensor it runs
:func:`filter_project_torch`.
"""

from __future__ import annotations

import torch

from repro_torch.core.schema import TableGeometry

from . import _cuda
from .common import geometry_words, pred_k_bits, row_mask


def filter_project_torch(
    words: torch.Tensor,
    geom: TableGeometry,
    pred_word: int,
    pred_dtype: str = "int32",
    pred_op: str = "gt",
    pred_k=0,
    ts: int = 0,
    ts_word: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(packed (N, out_words) int32, mask (N,) bool)``."""
    mask = row_mask(words, pred_word, pred_dtype, pred_op,
                    pred_k_bits(pred_k, pred_dtype), ts_word, ts)
    idx = torch.tensor(geometry_words(geom), dtype=torch.long, device=words.device)
    packed = words.index_select(1, idx)
    return torch.where(mask[:, None], packed, torch.zeros_like(packed)), mask


def filter_project(
    words: torch.Tensor,
    geom: TableGeometry,
    pred_word: int,
    pred_dtype: str = "int32",
    pred_op: str = "gt",
    pred_k=0,
    ts: int = 0,
    ts_word: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(packed (N, out_words) int32, mask (N,) bool)``."""
    if words.device.type == "cpu":
        return filter_project_torch(words, geom, pred_word, pred_dtype, pred_op,
                                    pred_k, ts, ts_word)
    req = _cuda.KernelReq(
        _cuda.FILTER, tuple(geometry_words(geom)), pred_word=pred_word,
        pred_float=_cuda.dtype_flag(pred_dtype), pred_op=pred_op,
        k_bits=pred_k_bits(pred_k, pred_dtype), ts_word=ts_word, ts=ts,
    )
    return _cuda.run("filter_project", words, [req])[0]
