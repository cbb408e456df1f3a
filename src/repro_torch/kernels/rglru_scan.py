"""The RG-LRU linear recurrence of the Griffin block's prefill.

The reference computes ``h_t = a_t * h_{t-1} + x_t`` over the sequence with
``lax.associative_scan`` (``repro/models/layers.py:1031``).  There is no
Pallas kernel behind it, and PyTorch has no associative scan: a loop over S
is two launches a step and a layer.  So on the card it goes to a
hand-written kernel instead:

* :func:`rglru_scan` — ``h (B, S, W)`` from ``a`` and ``x (B, S, W)``
  float32, ``h_{-1} = 0``: on CUDA tensors ``csrc/rm_rglru.cu`` through
  :func:`repro_torch.kernels._cuda.run_rglru_scan`, one launch of
  ``rm_rglru_scan_kernel`` (a thread a ``(b, w)`` lane, the operands loaded
  ahead of the chain); on CPU tensors :func:`rglru_scan_torch`, the plain
  version.

Both take the steps in order, each a float32 multiply then a float32 add
(no fused multiply-add), so the kernel is bit-equal to its plain version.
The reference's tree adds the same terms in another association, so the two
packages agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch

from . import _cuda


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    if a.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"a and x must be float32, got {a.dtype} and {x.dtype}")
    if a.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"want a and x of one shape (B, S, W), got {tuple(a.shape)} and "
                         f"{tuple(x.shape)}")


def rglru_scan_torch(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain version: a sequential float32 loop over S,
    ``h = a[:, t] * h + x[:, t]``."""
    _check(a, x)
    out = torch.empty_like(a)
    h = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = a[:, t] * h + x[:, t]
        out[:, t] = h
    return out


def rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``h (B, S, W)`` with ``h[:, t] = a[:, t] * h[:, t - 1] + x[:, t]`` from
    ``h[:, -1] = 0``: one kernel launch on the card, the plain version on the
    CPU."""
    if a.device.type == "cpu":
        return rglru_scan_torch(a, x)
    return _cuda.run_rglru_scan(a, x)
