"""The int8-weight decode matmul: ``y = x @ dequant(q, s)``.

The reference stores a quantized weight as ``{"q": int8 (in, out), "s":
bf16 (1, out)}`` and multiplies by ``cast(w, dt) = q.astype(dt) *
s.astype(dt)`` (``repro/models/layers.py:51``); on the TPU XLA fuses that
dequant into the consuming matmul, so the device reads the int8 buffer.
There is no Pallas kernel behind it.  Eager PyTorch would write and read
back a dequantized copy of every weight, so on the card a decode step's
products go to a hand-written kernel instead:

* :func:`w8_matmul` — on a CUDA tensor ``rm_w8_matmul_kernel`` of
  ``csrc/rm_w8.cu`` through :func:`repro_torch.kernels._cuda.run_w8`; on a
  CPU tensor :func:`w8_matmul_torch`, the plain version;
* :func:`dequantize` — the reference's ``cast`` of a record, which the plain
  version and the prefill's products use.

The kernel reads each int8 weight once and dequantizes it in registers
exactly as :func:`dequantize` does (in bf16 the product ``q · s`` rounded to
bf16, in float32 the exact product), accumulating in float32; its split-K
partials are summed in a fixed order, so a result does not change between
runs.  It takes ``x`` of ``(M, K)`` with ``M <= MAX_ROWS`` (the decode
step's B × 1 rows), float32 or bfloat16.
"""

from __future__ import annotations

import torch

from . import _cuda

MAX_ROWS = _cuda.W8_MAX_ROWS  # rows of x the kernel takes


def dequantize(q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The reference's ``cast`` of an int8 record: ``q.to(dt) * s.to(dt)``."""
    return q.to(dtype) * s.to(dtype)


def w8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x (M, K) @ dequantize(q (K, N), s (1, N), x.dtype)`` -> ``(M, N)``
    in x's dtype: the W8 kernel on the card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return w8_matmul_torch(x, q, s)
    return _cuda.run_w8(x, q, s)


def w8_matmul_torch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The plain version: the weight dequantized in x's dtype, then one
    matmul."""
    return x @ dequantize(q, s, x.dtype)
