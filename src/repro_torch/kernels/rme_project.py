"""Packed projection — the port of ``repro.kernels.rme_project`` (MLP only).

``project`` copies the enabled word ranges of each row into an
``(N, out_words)`` int32 block.  On a CUDA tensor it launches
``rm_project_kernel`` (``csrc/rm_scan.cu``, the Hopper form of the
reference's ``_mlp_kernel``); on a CPU tensor it runs :func:`project_torch`,
the plain version of the same contract.  There is no fallback between the
two: a CUDA tensor gets the kernel or an error.

The paper's BSL and PCK revisions are not ported yet (ROADMAP queue 2).
"""

from __future__ import annotations

import torch

from repro_torch.core.schema import TableGeometry

from . import _cuda
from .common import DEFAULT_BLOCK_ROWS, geometry_words

__all__ = ["DEFAULT_BLOCK_ROWS", "project", "project_torch",
           "vmem_footprint_bytes"]


def _check_geometry(words: torch.Tensor, geom: TableGeometry) -> None:
    if words.shape[1] < geom.row_words:
        raise ValueError(
            f"storage rows {words.shape[1]}w < geometry rows {geom.row_words}w")


def project_torch(words: torch.Tensor, geom: TableGeometry) -> torch.Tensor:
    """Plain PyTorch packed projection (one gather of the enabled words)."""
    _check_geometry(words, geom)
    idx = torch.tensor(geometry_words(geom), dtype=torch.long, device=words.device)
    return words.index_select(1, idx)


def project(words: torch.Tensor, geom: TableGeometry) -> torch.Tensor:
    """Packed projection ``(N, row_words) -> (N, out_words)`` via the RME.

    ``words.shape[1]`` may exceed ``geom.row_words``: the hidden MVCC words
    ride along in storage but are never shipped unless enabled."""
    if words.device.type == "cpu":
        return project_torch(words, geom)
    _check_geometry(words, geom)
    req = _cuda.KernelReq(_cuda.PROJECT, tuple(geometry_words(geom)))
    return _cuda.run("project", words, [req])[0]


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
