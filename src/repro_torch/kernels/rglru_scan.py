"""The RG-LRU linear recurrence of the Griffin block's prefill.

The reference computes ``h_t = a_t * h_{t-1} + x_t`` over the sequence with
``lax.associative_scan`` (``repro/models/layers.py:1031``).  There is no
Pallas kernel behind it, and PyTorch has no associative scan: a loop over S
is two launches a step and a layer.  So on the card it goes to a
hand-written kernel instead:

* :func:`rglru_scan` — ``h (B, S, W)`` from ``a`` and ``x (B, S, W)``
  float32, ``h_{-1} = 0``: on CUDA tensors ``csrc/rm_rglru.cu`` through
  :func:`repro_torch.kernels._cuda.run_rglru_scan`, one launch of
  ``rm_rglru_scan_kernel`` (a warp a block of 32 lanes of one batch row,
  ``a`` and ``x`` fed to it through a ring of stages in shared memory by
  TMA, or by ``cp.async`` where W is not a multiple of 4, a base not
  16-byte aligned or the grid over four blocks an SM;
  :func:`repro_torch.kernels._cuda.rglru_scan_plan`);
  on CPU tensors :func:`rglru_scan_torch`, the plain version.

Both take the steps in order, each a float32 multiply then a float32 add
(no fused multiply-add), so the kernel is bit-equal to its plain version.
The reference's tree adds the same terms in another association, so the two
packages agree to float32 rounding, not bit for bit.

The gradient (:class:`RGLRUScan`, a ``torch.autograd.Function``; XLA
differentiates the reference's ``associative_scan``) is the same linear
recurrence run backwards, ``g_t = dh_t + a_{t+1} g_{t+1}``, then ``dx = g``
and ``da_t = g_t h_{t-1}``: on CUDA tensors one launch of
``rm_rglru_scan_backward_kernel`` through
:func:`repro_torch.kernels._cuda.run_rglru_scan_backward` (a, h and dh
read once through a TMA ring from the last step down, da and dx written
once); on CPU tensors :func:`rglru_scan_backward_torch`, the plain reverse
loop, to which the kernel is bit-equal.
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


def _scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return rglru_scan_torch(a, x)
    return _cuda.run_rglru_scan(a, x)


def rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``h (B, S, W)`` with ``h[:, t] = a[:, t] * h[:, t - 1] + x[:, t]`` from
    ``h[:, -1] = 0``: one kernel launch on the card, the plain version on the
    CPU; differentiable (:class:`RGLRUScan`: one launch of the gradient's
    kernel backwards)."""
    if torch.is_grad_enabled() and (a.requires_grad or x.requires_grad):
        return RGLRUScan.apply(a, x)
    return _scan(a, x)


def _scan_backward(a: torch.Tensor, h: torch.Tensor,
                   dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if a.device.type == "cpu":
        return rglru_scan_backward_torch(a, h, dh)
    return _cuda.run_rglru_scan_backward(a, h, dh)


class RGLRUScan(torch.autograd.Function):
    """The scan with its gradient: the forward saves ``a`` and ``h``; the
    backward runs the recurrence ``g_t = dh_t + a_{t+1} g_{t+1}`` from the
    last step down, ``dx = g`` and ``da_t = g_t h_{t-1}`` (``h_{-1} = 0``):
    one kernel launch on the card, the plain reverse loop on the CPU."""

    @staticmethod
    def forward(ctx, a, x):
        h = _scan(a, x)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return _scan_backward(a, h, dh.contiguous())


def rglru_scan_backward_torch(a: torch.Tensor, h: torch.Tensor,
                              dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain reverse loop: ``g = a[:, t + 1] * g + dh[:, t]`` from
    ``t = S - 1`` down (``g`` zero before it), each a float32 multiply then
    add; returns ``(da, dx) = (g * h_{t-1}, g)``."""
    _check(a, dh)
    g = torch.empty_like(dh)
    acc = torch.zeros_like(dh[:, 0])
    s = a.shape[1]
    for t in range(s - 1, -1, -1):
        a_next = a[:, t + 1] if t + 1 < s else torch.zeros_like(acc)
        acc = a_next * acc + dh[:, t]
        g[:, t] = acc
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g
