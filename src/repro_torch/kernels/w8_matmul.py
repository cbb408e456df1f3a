"""The int8-weight decode matmul: ``y = x @ dequant(q, s)``.

The reference stores a quantized weight as ``{"q": int8 (in, out), "s":
bf16 (1, out)}`` and multiplies by ``cast(w, dt) = q.astype(dt) *
s.astype(dt)`` (``repro/models/layers.py:51``); on the TPU XLA fuses that
dequant into the consuming matmul, so the device reads the int8 buffer.
There is no Pallas kernel behind it.  Eager PyTorch would write and read
back a dequantized copy of every weight, so on the card a decode step's
products go to a hand-written kernel instead:

* :func:`w8_matmul_group` — the products of a group of records that share
  ``x`` (a layer's ``wq``, ``wk``, ``wv``; its ``w_gate``, ``w_up``): on
  CUDA tensors ``csrc/rm_w8.cu`` through
  :func:`repro_torch.kernels._cuda.run_w8`, in bf16 one launch of
  ``rm_w8_matmul_tc_kernel`` (the tensor cores) for the whole group, in
  float32 one launch of ``rm_w8_matmul_kernel`` (the CUDA cores) a record;
  on CPU tensors :func:`w8_matmul_torch` a record, the plain version;
* :func:`w8_matmul` — one product, a group of one;
* :func:`dequantize` — the reference's ``cast`` of a record, which the plain
  version and the prefill's products use.

The kernel reads each int8 weight once and dequantizes it in registers
exactly as :func:`dequantize` does (in bf16 the product ``q · s`` rounded to
bf16, in float32 the exact product), accumulating in float32; its split-K
sums are added in a fixed order that depends on K alone, so a result does
not change between runs, in a CUDA graph's replay, or between a product
launched in a group and alone.  It takes ``x`` of ``(M, K)`` with ``M <=
MAX_ROWS`` (the decode step's B × 1 rows), float32 or bfloat16.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import _cuda

MAX_ROWS = _cuda.W8_MAX_ROWS  # rows of x the kernel takes
MAX_RECORDS = _cuda.W8_MAX_RECORDS  # records one group takes


def dequantize(q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The reference's ``cast`` of an int8 record: ``q.to(dt) * s.to(dt)``."""
    return q.to(dtype) * s.to(dtype)


def w8_matmul_group(x: torch.Tensor, records: Sequence[tuple[torch.Tensor, torch.Tensor]]
                    ) -> list[torch.Tensor]:
    """``[x (M, K) @ dequantize(q, s, x.dtype) for q (K, N), s (1, N) in
    records]``, each ``(M, N)`` in x's dtype: the W8 kernel on the card, the
    plain version on the CPU.  Raises on an empty group, on more than
    ``MAX_RECORDS`` records, and on records that differ in K, device or
    dtype."""
    if not 1 <= len(records) <= MAX_RECORDS:
        raise ValueError(f"a group takes 1..{MAX_RECORDS} records, got {len(records)}")
    if x.device.type == "cpu":
        for q, s in records:
            if q.device != x.device or s.device != x.device:
                raise ValueError(f"x on {x.device} but a record on {q.device} / {s.device}")
        return [w8_matmul_torch(x, q, s) for q, s in records]
    return _cuda.run_w8(x, records)


def w8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x (M, K) @ dequantize(q (K, N), s (1, N), x.dtype)`` -> ``(M, N)``
    in x's dtype: the W8 kernel on the card, the plain version on the CPU."""
    return w8_matmul_group(x, [(q, s)])[0]


def w8_matmul_torch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The plain version: the weight dequantized in x's dtype, then one
    matmul."""
    return x @ dequantize(q, s, x.dtype)
