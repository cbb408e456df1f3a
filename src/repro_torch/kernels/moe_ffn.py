"""The MoE block's expert FFN at a decode step's size.

The reference dispatches an MoE layer's token slots into a dense buffer
``buf (E, cap, d)`` and runs three einsums over every expert
(``repro/models/layers.py:583-585``): ``h = silu(buf @ Wg) * (buf @ Wu)``,
``out = h @ Wd``.  There is no Pallas kernel behind it.  At a decode step
few experts hold any row, yet the dense form reads every expert's weights;
skipping the empty ones in PyTorch needs shapes that depend on the data,
which a CUDA graph cannot hold.  So on the card a step's expert FFN goes to
a hand-written kernel instead:

* :func:`moe_ffn` — ``out`` from ``buf`` and ``count (E,)``, the kept rows of
  each expert (rows at or past it are zeros in ``buf`` and come out zero):
  on CUDA tensors ``csrc/rm_moe.cu`` through
  :func:`repro_torch.kernels._cuda.run_moe`, two launches of
  ``rm_moe_ffn_kernel`` (:func:`moe_gate_up`, then :func:`moe_down`), whose
  blocks read each expert's count on the device and skip the weights of an
  expert with none; on CPU tensors :func:`moe_ffn_torch`, the plain version;
* :func:`expert_ffn_dense` — the reference's three einsums as
  ``torch.bmm``, over every expert: the plain version's body, and the form a
  prefill takes (its ``cap`` is above ``MAX_ROWS``).

The kernel takes ``cap <= MAX_ROWS`` (16: every decode step up to 204 slots
at top-8 of 128 experts), float32 or bfloat16, ``d`` and ``f`` multiples of
8.  Its rounding points are the dense form's: each product rounded to the
compute dtype, then ``silu``, rounded, then the product of the two; its
float32 sums are added in a fixed order, with no atomics, so a result is the
same every run and in a CUDA graph's replay.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda

MAX_ROWS = _cuda.MOE_MAX_ROWS  # rows an expert (cap) the kernel takes


def expert_ffn_dense(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                     wd: torch.Tensor) -> torch.Tensor:
    """The reference's expert FFN over every expert: ``silu(buf @ Wg) *
    (buf @ Wu) @ Wd``, each product in the compute dtype, as three
    ``torch.bmm``."""
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    return torch.bmm(h, wd)


def _kept(x: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``x (E, cap, K)`` with the rows at or past each expert's count zeroed."""
    rows = torch.arange(x.shape[1], device=x.device)
    return x * (rows[None, :] < count[:, None]).to(x.dtype)[..., None]


def moe_ffn_torch(buf: torch.Tensor, count: torch.Tensor, wg: torch.Tensor,
                  wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`moe_ffn`: the dense form over ``buf`` with
    the rows at or past each expert's count zeroed."""
    return expert_ffn_dense(_kept(buf, count), wg, wu, wd)


def moe_gate_up_torch(buf, count, wg, wu) -> torch.Tensor:
    """The plain version of :func:`moe_gate_up`."""
    x = _kept(buf, count)
    return F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)


def moe_down_torch(h, count, wd) -> torch.Tensor:
    """The plain version of :func:`moe_down`."""
    return torch.bmm(_kept(h, count), wd)


def moe_gate_up(buf: torch.Tensor, count: torch.Tensor, wg: torch.Tensor,
                wu: torch.Tensor) -> torch.Tensor:
    """``h (E, cap, f) = silu(buf @ Wg) * (buf @ Wu)`` on each expert's kept
    rows, zeros past them: one kernel launch on the card, the plain version
    on the CPU."""
    if buf.device.type == "cpu":
        return moe_gate_up_torch(buf, count, wg, wu)
    return _cuda.run_moe(buf, count, wg, wu)


def moe_down(h: torch.Tensor, count: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """``out (E, cap, d) = h @ Wd`` on each expert's kept rows, zeros past
    them: one kernel launch on the card, the plain version on the CPU."""
    if h.device.type == "cpu":
        return moe_down_torch(h, count, wd)
    return _cuda.run_moe(h, count, wd, None)


def moe_ffn(buf: torch.Tensor, count: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            wd: torch.Tensor) -> torch.Tensor:
    """The expert FFN of ``buf (E, cap, d)`` with ``count (E,)`` int64 kept
    rows an expert and the weights ``Wg``, ``Wu (E, d, f)``, ``Wd (E, f, d)``
    -> ``(E, cap, d)``: two kernel launches on the card (``cap <=
    MAX_ROWS``), the plain version on the CPU."""
    if buf.device.type == "cpu":
        return moe_ffn_torch(buf, count, wg, wu, wd)
    return moe_down(moe_gate_up(buf, count, wg, wu), count, wd)
