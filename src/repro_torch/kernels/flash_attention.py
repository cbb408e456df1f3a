"""Fused GQA flash attention — the port of ``repro.kernels.flash_attention``.

:func:`flash_attention` keeps the reference's layout and contract: q
``(B, S, H, D)``, k and v ``(B, S, KH, D)``, out ``(B, S, H, D)`` in q's
type; causal or bidirectional, with an optional sliding window, and G = H /
KH query heads sharing each KV head.  On a CUDA tensor it launches one of
the two Hopper forms of the reference's ``_flash_kernel`` in
``csrc/rm_flash.cu`` through :func:`repro_torch.kernels._cuda.run_flash`,
chosen by dtype:

* bfloat16: ``rm_flash_attention_tc_kernel`` on the tensor cores — 128
  query rows a block (two consumer warpgroups of 64), K and V tiles of 128
  keys (64 at D 256) brought by TMA into a two-stage ring, both products by
  ``wgmma``.  TMA needs each tensor's base 16-byte aligned and its strides
  multiples of 16 bytes (:func:`~repro_torch.kernels._cuda.check_flash_tma`);
* float32: ``rm_flash_attention_kernel`` on the CUDA cores, 64 × 64 tiles.

On a CPU tensor it runs :func:`flash_attention_torch`, the plain version.
``block_q`` and ``block_k`` are kept for API parity: the plain version walks
keys in ``block_k`` tiles as the reference does, while the CUDA kernels'
tiles are their own choice.

The gradient is :class:`FlashAttention`, a ``torch.autograd.Function``: its
forward is the kernel, unchanged, and it saves q, k and v; its backward
recomputes the plain version under autograd, one ``block_k`` tile of keys
at a time, each tile's step checkpointed (:func:`_online_step`) — the
reference's own backward, which XLA derives from ``blockwise_attention``
with ``jax.checkpoint(step)`` (``repro/models/layers.py:229-301``); JAX has
no backward kernel, so none is ported.  On the card a tensor that requires
grad always goes through the kernel's forward, never the plain one.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import _cuda

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 256
MASK_VALUE = -1e30


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"want q (B, S, H, D), k and v (B, S, KH, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, S, KH, D) = ({b}, {s}, KH, {d}), "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"{h} query heads do not split into groups of "
                         f"{k.shape[2]} KV heads")
    if not (q.dtype == k.dtype == v.dtype) or not q.dtype.is_floating_point:
        raise ValueError(f"q, k and v must share one floating type, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KH, D)
    v: torch.Tensor,  # (B, S, KH, D)
    causal: bool = True,
    window: int | None = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Fused attention; semantics match ``layers.blockwise_attention``.
    Differentiable: on the card through :class:`FlashAttention` where grad
    is needed, on the CPU through the plain version's own autograd (its key
    tiles checkpointed)."""
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal, window, block_q, block_k)
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, block_k)
    return _cuda.run_flash(q, k, v, causal, window)


class FlashAttention(torch.autograd.Function):
    """The kernel's forward with the plain version's gradient: ``forward``
    launches ``rm_flash.cu`` and saves q, k and v; ``backward`` recomputes
    :func:`flash_attention_torch` under autograd (``block_k`` keys a
    checkpointed step, so a step's float32 logits and probabilities exist
    only while that step is differentiated) and returns dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None, block_k: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.block_k = causal, window, block_k
        return _cuda.run_flash(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_torch(q, k, v, ctx.causal, ctx.window,
                                        block_k=ctx.block_k)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        return dq, dk, dv, None, None, None


def _online_step(qf, kc, vc, acc, m, l, j0, causal: bool, win: int):
    """One tile of keys ``kc``, ``vc`` (first key ``j0``) folded into the
    online softmax's float32 accumulator, running max and sum: the masked
    logits at ``MASK_VALUE``, ``p`` cast to v's type before the PV product."""
    s = qf.shape[1]
    q_pos = torch.arange(s, device=qf.device)
    logits = torch.einsum("bqkgd,bckd->bqkgc", qf, kc.float())
    dist = q_pos[:, None] - torch.arange(j0, j0 + kc.shape[1], device=qf.device)[None, :]
    mask = (dist >= 0) & (dist < win) if causal else dist.abs() < win
    logits = torch.where(mask[None, :, None, None, :], logits, MASK_VALUE)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bqkgc,bckd->bqkgd", p.to(vc.dtype).float(), vc.float())
    return acc * alpha[..., None] + pv, m_new, l


def flash_attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int | None = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """The plain version: the reference kernel's arithmetic on whole query
    rows, walking the keys in ``block_k`` tiles — q and k in float32, q
    scaled before the dot, masked logits at ``MASK_VALUE``, an online
    softmax with float32 ``m``, ``l`` and accumulator, ``p`` cast to v's
    type before the PV product, and ``acc / max(l, 1e-30)``.  Keys past S
    are simply absent (the reference pads and masks them: the same sums).
    ``block_q`` does not change the result and is accepted for parity.
    Under autograd each tile's step is checkpointed, as the reference
    checkpoints its blockwise step: the backward recomputes one tile's
    logits at a time.

    A window below 1 raises ``ValueError``, as the card's kernel does: such
    a window masks every key, and the reference's value there depends on
    its own padding of S to ``block_k`` (a deliberate difference)."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    del block_q
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    win = s if window is None else window
    block_k = max(1, min(block_k, s))
    qf = (q.float() * d ** -0.5).reshape(b, s, kh, g, d)
    acc = torch.zeros((b, s, kh, g, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, s, kh, g), float("-inf"), device=q.device)
    l = torch.zeros((b, s, kh, g), device=q.device)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    for j0 in range(0, s, block_k):
        kc, vc = k[:, j0:j0 + block_k], v[:, j0:j0 + block_k]
        if grad:
            acc, m, l = checkpoint(_online_step, qf, kc, vc, acc, m, l, j0, causal, win,
                                   use_reentrant=False, preserve_rng_state=False)
        else:
            acc, m, l = _online_step(qf, kc, vc, acc, m, l, j0, causal, win)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, s, h, d).to(q.dtype)


def attention_hbm_bytes(
    b: int, s: int, h: int, kh: int, d: int, chunk: int, dtype_bytes: int = 2
) -> dict:
    """Modeled per-layer attention HBM traffic: fused kernel vs pure XLA.

    XLA blockwise: Q/K/V/O + the f32 logits and weight tiles spilled per
    chunk step (2 tiles of B·S·H·chunk f32 per chunk, written + read).
    Fused kernel: Q/K/V/O only (logits live in VMEM).
    """
    qkvo = (2 * b * s * h * d + 2 * b * s * kh * d) * dtype_bytes
    n_chunks = max(s // chunk, 1)
    logits_spill = 2 * 2 * b * s * h * chunk * 4 * n_chunks
    return {
        "xla_blockwise": qkvo + logits_spill,
        "fused": qkvo,
        "savings": logits_spill,
    }
