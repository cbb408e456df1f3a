"""Scan-sharing multi-view projection — the port of
``repro.kernels.rme_project_multi``: one row-store pass, many packed outputs.

``project_multi(words, geoms)`` returns one packed ``(N, out_words_v)``
int32 block per geometry.  On a CUDA tensor it launches
``rm_project_multi_kernel`` (``csrc/rm_scan.cu``, the Hopper form of
``_mlp_multi_kernel``): each row tile is staged once in shared memory and
every view's packed block is written from it (rows wider than
``_cuda.DIRECT_ROW_WORDS`` are read in place).  A launch carries at most
``_cuda.MAX_REQ`` views, of any number of packed words; more views split
into several launches, each one pass over the rows.  On a CPU tensor it runs
:func:`project_multi_torch`, the torch form of the reference's
``project_multi_xla``: one gather of the union of enabled words, then
per-view slices out of that one array.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.schema import TableGeometry

from . import _cuda
from .common import geometry_words

__all__ = ["project_multi", "project_multi_torch"]


def _check_geoms(row_words: int, geoms: Sequence[TableGeometry]) -> None:
    if not geoms:
        raise ValueError("project_multi needs at least one geometry")
    for g in geoms:
        if row_words < g.row_words:
            raise ValueError(
                f"storage rows {row_words}w < geometry rows {g.row_words}w")


def project_multi_torch(words: torch.Tensor,
                        geoms: Sequence[TableGeometry]) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version: gather the union of enabled words once, slice
    per view."""
    _check_geoms(words.shape[1], geoms)
    union = sorted({w for g in geoms for w in geometry_words(g)})
    pos = {word: i for i, word in enumerate(union)}
    shared = words.index_select(
        1, torch.tensor(union, dtype=torch.long, device=words.device))
    return tuple(
        shared.index_select(1, torch.tensor([pos[w] for w in geometry_words(g)],
                                            dtype=torch.long, device=words.device))
        for g in geoms)


def project_multi(words: torch.Tensor,
                  geoms: Sequence[TableGeometry]) -> tuple[torch.Tensor, ...]:
    """Shared-scan projection ``(N, row_words) -> [(N, out_words_v), ...]``.

    All geometries describe views over the same row layout; the row store is
    streamed once per launch however many views it carries."""
    if words.device.type == "cpu":
        return project_multi_torch(words, geoms)
    _check_geoms(words.shape[1], geoms)
    reqs = [_cuda.KernelReq(_cuda.PROJECT, tuple(geometry_words(g))) for g in geoms]
    return tuple(_cuda.run("project_multi", words, reqs))
