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

The gradient on the card is :class:`FlashAttention`, a
``torch.autograd.Function``: its forward is the kernel, which also stores
each row's log-sum-exp, and it saves q, k, v, the output and that lse; its
backward is the hand-written kernel of ``csrc/rm_flash_bwd.cu``
(:func:`repro_torch.kernels._cuda.run_flash_backward`): P rebuilt from the
lse, dK and dV in one pass over the keys, dQ in another — bf16 on the
tensor cores (at D 256 dK and dV in a warpgroup each), float32 on the CUDA
cores.  The reference
has no backward kernel: XLA differentiates ``blockwise_attention``'s
checkpointed step (``repro/models/layers.py:292-298``).
:func:`flash_attention_backward_torch` is the backward kernel's plain
version, used by the tests and ``chip_smoke.py`` only.  On the CPU the
gradient is the plain forward's own autograd, one ``block_k`` tile of keys
a checkpointed step (:func:`_online_step`), as the reference's.  On the
card a tensor that requires grad always goes through the kernels, never the
plain version.
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
        return FlashAttention.apply(q, k, v, causal, window)
    return _cuda.run_flash(q, k, v, causal, window)


class FlashAttention(torch.autograd.Function):
    """The kernels' gradient: ``forward`` launches ``rm_flash.cu`` with the
    row log-sum-exp stored and saves q, k, v, the output and the lse;
    ``backward`` launches ``rm_flash_bwd.cu`` once and returns dq, dk and
    dv in q's type."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None):
        out, lse = _cuda.run_flash(q, k, v, causal, window, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _cuda.run_flash_backward(q, k, v, out, lse, dout, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def _online_step(qf, kc, vc, acc, m, l, j0, causal: bool, win: int):
    """One tile of keys ``kc``, ``vc`` (first key ``j0``) folded into the
    online softmax's float32 accumulator, running max and sum: the masked
    logits at ``MASK_VALUE``, ``p`` cast to v's type before the PV product."""
    logits = torch.einsum("bqkgd,bckd->bqkgc", qf, kc.float())
    mask = _mask(qf.shape[1], j0, kc.shape[1], causal, win, qf.device)
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
    return_lse: bool = False,
):
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

    With ``return_lse`` it returns ``(out, lse)``: each row's log-sum-exp
    of its masked, scaled logits, ``m + log l``, float32 ``(B, H, S)``, as
    the kernel stores it for the backward.

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
    out = out.reshape(b, s, h, d).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).reshape(b, s, h).permute(0, 2, 1).contiguous()


def _mask(s: int, j0: int, n: int, causal: bool, win: int, device) -> torch.Tensor:
    """The (S, n) mask of keys ``j0 .. j0 + n - 1``, as :func:`_online_step`'s."""
    dist = (torch.arange(s, device=device)[:, None]
            - torch.arange(j0, j0 + n, device=device)[None, :])
    return (dist >= 0) & (dist < win) if causal else dist.abs() < win


def flash_attention_backward_torch(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KH, D)
    v: torch.Tensor,  # (B, S, KH, D)
    out: torch.Tensor,  # (B, S, H, D), the forward's
    lse: torch.Tensor,  # (B, H, S) float32, the forward's
    dout: torch.Tensor,  # (B, S, H, D)
    causal: bool = True,
    window: int | None = None,
    block_k: int = DEFAULT_BLOCK_K,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's plain version (``csrc/rm_flash_bwd.cu``):
    ``(dq, dk, dv)`` in q's type from the forward's output and log-sum-exp,
    walking the keys in ``block_k`` tiles.  In float32: ``P = exp(scale q
    k - lse)`` where the mask allows (else 0), ``D = sum(dout * out)`` with
    ``out`` as stored, ``dV = P^T dout``, ``dP = dout v^T``, ``dS = P (dP -
    D)``, ``dQ = scale dS k``, ``dK = scale dS^T q`` — P and dS rounded to
    q's type before the products that take them, as the kernel rounds them
    (a no-op in float32).  Used by the tests and ``chip_smoke.py`` only."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    win = s if window is None else window
    block_k = max(1, min(block_k, s))
    scale = d ** -0.5
    dt = q.dtype
    q32 = q.float().reshape(b, s, kh, g, d)
    qs = q32 * scale
    do = dout.float().reshape(b, s, kh, g, d)
    delta = (do * out.float().reshape(b, s, kh, g, d)).sum(-1)
    row_lse = lse.permute(0, 2, 1).reshape(b, s, kh, g)
    dq = torch.zeros((b, s, kh, g, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, s, kh, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for j0 in range(0, s, block_k):
        kc, vc = k[:, j0:j0 + block_k].float(), v[:, j0:j0 + block_k].float()
        mask = _mask(s, j0, kc.shape[1], causal, win, q.device)[None, :, None, None, :]
        logits = torch.einsum("bqkgd,bckd->bqkgc", qs, kc)
        p = torch.where(mask, torch.exp(logits - row_lse[..., None]), 0.0)
        ds = p * (torch.einsum("bqkgd,bckd->bqkgc", do, vc) - delta[..., None])
        p, ds = p.to(dt).float(), ds.to(dt).float()
        dv[:, j0:j0 + block_k] = torch.einsum("bqkgc,bqkgd->bckd", p, do)
        dk[:, j0:j0 + block_k] = torch.einsum("bqkgc,bqkgd->bckd", ds, q32) * scale
        dq += torch.einsum("bqkgc,bckd->bqkgd", ds, kc)
    return (dq.mul_(scale).reshape(b, s, h, d).to(dt), dk.to(dt), dv.to(dt))


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
