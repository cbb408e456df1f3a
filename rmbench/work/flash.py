"""The least work of causal GQA flash attention, forward and backward: 4·D
operations an unmasked (query, key) pair a head forward (QK and PV), 2.5
times that backward (QK recomputed, dV, dP, dQ, dK); q, k, v and the output
moved once forward; q, k, v, out, dout and the float32 row lse read and dq,
dk, dv written once backward."""

from __future__ import annotations

from . import peaks
from .flops import causal_pairs

BACKWARD_OPS = 2.5


def forward_work(b: int, s: int, h: int, kh: int, d: int, elem_bytes: int) -> tuple[int, int]:
    ops = 4 * b * h * d * causal_pairs(s)
    nbytes = (2 * b * s * h * d + 2 * b * s * kh * d) * elem_bytes
    return ops, nbytes


def backward_work(b: int, s: int, h: int, kh: int, d: int, elem_bytes: int) -> tuple[int, int]:
    ops, _ = forward_work(b, s, h, kh, d, elem_bytes)
    nbytes = (5 * b * s * h * d + 4 * b * s * kh * d) * elem_bytes + 4 * b * h * s
    return int(BACKWARD_OPS * ops), nbytes


def bound_s(work: tuple[int, int]) -> float:
    """The least time of ``(operations, bytes)`` on the bf16 tensor cores."""
    ops, nbytes = work
    return max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
