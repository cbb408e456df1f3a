"""The layers of ``repro.models.layers`` on PyTorch.

Blocks: RMSNorm, RoPE / M-RoPE, GQA attention (the blockwise online-softmax form on
the CPU, the hand-written flash kernel on the card, cached attention for
decode, optional sliding window / qk-norm / QKV bias), the
SwiGLU / GeGLU / vanilla FFNs and the token-choice top-k MoE block with its
sort-based, capacity-bounded dispatch (its expert FFN at a decode step's
size on the hand-written kernel of ``kernels/moe_ffn.py``), plus the int8
serving weights (:class:`QuantizedWeight`, :func:`quantize_weight`,
:func:`quantize_for_serving`), the causal depthwise conv, the Mamba-2 SSD
mixer (the chunked form for a prefill, one step for decode) and the Griffin
RG-LRU mixer (its prefill recurrence on the hand-written scan kernel of
``kernels/rglru_scan.py``).  RoPE takes the M-RoPE form (positions ``(B,
3, S)``) of the VLM backbone.

Parameters live in small ``nn.Module``s (:class:`RMSNorm`,
:class:`Attention`, :class:`MLP`, :class:`MoE`, :class:`SSD`,
:class:`RGLRU`) whose attribute names are the reference's parameter-tree
keys, so a layer's ``state_dict`` names are the reference's paths.  Matmul
weights are stored in the compute dtype; norm scales, the SSD's ``a_log``,
``dt_bias`` and ``d_skip``, and the RG-LRU's gates (``w_a``, ``b_a``,
``w_x``, ``b_x``) and ``lambda_`` in float32 — the numbers the reference
gets from its float32 master copy cast at use.  A recurrent decode step
writes its state in place, as attention writes its KV cache.  Weights are
``requires_grad=False`` parameters; a train step differentiates the master
weights of its state instead (``lm.DecoderLM.loss``), and every layer here
is differentiable: attention's blockwise form checkpoints each key chunk's
step, as the reference's ``jax.checkpoint(step)``; the flash kernel and the
scan kernel have ``torch.autograd.Function`` gradients; the MoE block's
expert FFN under grad takes its dense ``torch.bmm`` form (the decode-sized
kernel has no backward).

Every matmul against a weight goes through :func:`linear`: a plain
``x @ cast(w, dt)``, except for an int8 weight with at most
``W8_DECODE_ROWS`` rows of ``x`` (a decode step), which goes to the
hand-written int8-weight kernel (``kernels/w8_matmul.py``) so that the
device reads the int8 buffer and never a dequantized copy.  Products that
share ``x`` (attention's q, k and v; a gated FFN's gate and up) go through
:func:`linear_group`: on the card, a decode step's int8 group is one launch.

Dtype discipline is the reference's: compute runs in the activations' dtype,
and softmax, norms and RoPE run in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as C
from repro_torch.distributed.partitioning import (
    axis_group,
    axis_index,
    axis_size,
    current_mesh,
    current_mesh_shape,
    current_rules,
    logical_spec,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_ffn import MAX_ROWS as MOE_MAX_ROWS
from repro_torch.kernels.moe_ffn import expert_ffn_dense, moe_ffn
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.w8_matmul import MAX_ROWS, dequantize, w8_matmul, w8_matmul_group

F32 = torch.float32
# devices whose tensors take the hand-written kernels: the card, and "meta"
# (the dry run), where a kernel's wrapper gives its output's shape and
# reports its work, and nothing runs
KERNEL_DEVICES = ("cuda", "meta")

MASK_VALUE = -1e30
# rows of x up to which an int8 weight's product on the card runs the W8
# kernel (a decode step: B x 1 rows); above it (a prefill) the weight is
# dequantized once and multiplied by torch.matmul
W8_DECODE_ROWS = MAX_ROWS
# rows an expert (the dispatch's capacity) up to which the expert FFN runs
# moe_ffn (on the card the MoE kernel: a decode step); above it (a prefill)
# the reference's three einsums over every expert, as torch.bmm
MOE_DECODE_ROWS = MOE_MAX_ROWS
# experts drawn at a time by init_moe: a slice's float32 draw, not a whole
# expert tensor's (3.2 GB at qwen3-moe-235b's widths)
MOE_INIT_EXPERTS = 16


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 on ``device``, stored as ``dtype``."""
    x = torch.randn(shape, generator=gen, dtype=F32, device=device)
    return x.mul_(scale).to(dtype)


def _weight(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class QuantizedWeight(nn.Module):
    """An int8 weight record, the reference's ``{"q": int8 (in, out), "s":
    bf16 (1, out)}`` leaf pair (per-output-channel absmax): two buffers, so a
    quantized layer's ``state_dict`` holds ``<name>.q`` and ``<name>.s``."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)


def cast(x, dtype: torch.dtype) -> torch.Tensor:
    """Cast a weight to the compute dtype; dequantizes an int8 record as the
    reference does, ``q.to(dt) * s.to(dt)`` (each element rounded in
    ``dt``)."""
    if isinstance(x, QuantizedWeight):
        return dequantize(x.q, x.s, dtype)
    return x if x.dtype == dtype else x.to(dtype)


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ cast(w, x.dtype)`` for every matmul site.  An int8 weight with
    at most ``W8_DECODE_ROWS`` rows of ``x`` goes to :func:`w8_matmul` (on
    the card the W8 kernel, on the CPU its plain version, the same
    product); otherwise the weight is cast and multiplied."""
    if isinstance(w, QuantizedWeight):
        k = x.shape[-1]
        rows = x.numel() // k
        if rows <= W8_DECODE_ROWS:
            y = w8_matmul(x.reshape(rows, k).contiguous(), w.q, w.s)
            return y.reshape(*x.shape[:-1], y.shape[-1])
    return x @ cast(w, x.dtype)


def linear_group(x: torch.Tensor, ws) -> list[torch.Tensor]:
    """``[linear(x, w) for w in ws]`` for weights that share ``x``.  On the
    card, when every weight is a :class:`QuantizedWeight` and ``x`` has at
    most ``W8_DECODE_ROWS`` rows (a decode step), the group is one call of
    :func:`w8_matmul_group` (one W8 launch in bf16), each output bit-equal
    to its product alone; otherwise (a prefill, float weights, the CPU) it
    is exactly ``[linear(x, w) for w in ws]``."""
    k = x.shape[-1]
    rows = x.numel() // k
    if (x.device.type in KERNEL_DEVICES and rows <= W8_DECODE_ROWS
            and all(isinstance(w, QuantizedWeight) for w in ws)):
        ys = w8_matmul_group(x.reshape(rows, k).contiguous(), [(w.q, w.s) for w in ws])
        return [y.reshape(*x.shape[:-1], y.shape[-1]) for y in ys]
    return [linear(x, w) for w in ws]


@torch.no_grad()
def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """Per-output-channel absmax int8 quantization of a 2-D weight, bit for
    bit the reference's: ``s = max(|w|, axis 0) / 127`` floored at 1e-12 (in
    float32), ``q = clip(round(w / s), -127, 127)`` (half to even), ``s``
    stored as bf16."""
    if w.dim() != 2:
        raise ValueError(f"quantize_weight takes a 2-D weight, got {tuple(w.shape)}")
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(dim=0, keepdim=True) / 127.0, 1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QuantizedWeight(q, s.to(torch.bfloat16))


# RG-LRU gate matrices (w_a, w_x) are not quantized (the reference keeps them
# bf16; here float32 weights of bf16 values): they parameterize decay rates,
# where int8 grid error compounds over thousands of recurrence steps
_QUANT_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
                "w_out", "w_branch", "w_zx")
_KEEP_F32 = ("a_log", "dt_bias", "lambda_", "d_skip")


@torch.no_grad()
def quantize_for_serving(model: nn.Module) -> nn.Module:
    """int8-quantize the large 2-D matmul weights of ``model`` in place (the
    reference's ``quantize_for_serving`` over a parameter tree) and return it.

    A weight named in ``_QUANT_NAMES`` becomes a :class:`QuantizedWeight`;
    every other float weight (embeddings, ``lm_head``, biases, norm scales)
    is rounded to bf16 values, as the reference casts those leaves to bf16 —
    the port keeps each in its own dtype (norm scales float32), so only the
    values change.  Each weight is freed as soon as its record exists, so
    the peak stays one weight's quantization above the model."""
    for module in list(model.modules()):
        for name in list(module._parameters):
            w = module._parameters[name]
            if w is None or not w.dtype.is_floating_point:
                continue
            if name in _QUANT_NAMES and w.dim() >= 2:
                record = quantize_weight(w)
                del module._parameters[name], w  # the weight's last reference
                setattr(module, name, record)
            elif name not in _KEEP_F32 and w.dtype != torch.bfloat16:
                w.copy_(w.to(torch.bfloat16))
    return model


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


class RMSNorm(nn.Module):
    """``scale`` stored as ``(1 + scale)``'s offset, gemma-style, in float32;
    zero at construction (the reference's ``init_rms_norm``)."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _weight(torch.zeros(d, dtype=F32, device=device))



# ------------------------------------------------------------------- RoPE
def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Frequency-index split for M-RoPE (temporal, height, width).

    Matches Qwen2-VL's published 16/24/24 split at head_dim=128 and scales
    proportionally elsewhere: s0 = hd/8, s1 = s2 = (hd/2 - s0)/2.
    """
    half = head_dim // 2
    s0 = head_dim // 8
    s1 = (half - s0) // 2
    return (s0, s1, half - s0 - s1)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 mrope: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (B, S) -> (B, S, half); for M-RoPE
    positions (B, 3, S), each frequency driven by the component (t, h or w)
    of its section (:func:`mrope_sections`).  The reference picks the
    component with a one-hot einsum, which multiplies by 1 and adds 0: the
    selection here gives the same float32 angles exactly.  The section of
    each frequency is computed on the device by comparisons, not copied
    from the host, so a CUDA graph can capture it."""
    half = head_dim // 2
    dev = positions.device
    idx = torch.arange(half, device=dev)
    exps = -idx.to(F32) / half
    # theta as a filled device scalar, not a host copy: a CUDA graph can
    # capture a fill, not a copy from pageable memory
    freqs = torch.pow(torch.full((), theta, dtype=F32, device=dev), exps)
    if not mrope:
        ang = positions.to(F32)[..., None] * freqs  # (B, S, half)
        return torch.cos(ang), torch.sin(ang)
    if positions.dim() != 3 or positions.shape[1] != 3:
        raise ValueError(f"M-RoPE wants positions (B, 3, S), got {tuple(positions.shape)}")
    ang3 = positions.to(F32)[..., None] * freqs  # (B, 3, S, half)
    s0, s1, _ = mrope_sections(head_dim)
    ang = torch.where(idx < s0, ang3[:, 0],
                      torch.where(idx < s0 + s1, ang3[:, 1], ang3[:, 2]))  # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, Dh) rotated with (B, S, half) tables (llama-style half split)."""
    half = x.shape[-1] // 2
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention
@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope: bool = False
    window: int | None = None  # None = full causal
    causal: bool = True  # False: bidirectional (encoder self-attention)
    softmax_scale: float | None = None

    @property
    def scale(self) -> float:
        return self.softmax_scale or self.head_dim**-0.5


class Attend(nn.Module):
    """The attention body of a layer: ``(q, k, v) -> out``, dispatched by
    :func:`_attend`.  A module of its own, with no parameters, so a forward
    hook can read the q, k and v a layer hands the kernel."""

    def __init__(self, spec: AttnSpec, chunk: int):
        super().__init__()
        self.spec = spec
        self.chunk = chunk

    def forward(self, q, k, v):
        return _attend(q, k, v, self.spec, self.chunk)


class Attention(nn.Module):
    """One attention layer's weights (``wq``, ``wk``, ``wv``, ``wo``, the
    optional ``b*`` biases and ``q_norm`` / ``k_norm``) and its body."""

    def __init__(self, spec: AttnSpec, dtype: torch.dtype, device=None,
                 chunk: int = 1024):
        super().__init__()
        d, h, k, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
        empty = dict(dtype=dtype, device=device)
        self.wq = _weight(torch.empty((d, h * hd), **empty))
        self.wk = _weight(torch.empty((d, k * hd), **empty))
        self.wv = _weight(torch.empty((d, k * hd), **empty))
        self.wo = _weight(torch.empty((h * hd, d), **empty))
        if spec.qkv_bias:
            self.bq = _weight(torch.zeros(h * hd, dtype=F32, device=device))
            self.bk = _weight(torch.zeros(k * hd, dtype=F32, device=device))
            self.bv = _weight(torch.zeros(k * hd, dtype=F32, device=device))
        if spec.qk_norm:
            self.q_norm = RMSNorm(hd, device)
            self.k_norm = RMSNorm(hd, device)
        self.attend = Attend(spec, chunk)


@torch.no_grad()
def _draw_fan_in(gen: torch.Generator, module: nn.Module) -> None:
    """Every 2-D weight of ``module`` (not of its submodules) drawn as
    ``N(0, 1) / sqrt(fan_in)``, fan_in its first dimension — the reference's
    scale for each of them; its 1-D weights (biases) start at zero."""
    for w in module.parameters(recurse=False):
        if w.dim() == 2:
            w.copy_(normal(gen, w.shape, w.shape[0] ** -0.5, w.dtype, w.device))
        else:
            w.zero_()


@torch.no_grad()
def init_attention(gen: torch.Generator, params: Attention) -> Attention:
    """Draw an attention layer's weights in place."""
    _draw_fan_in(gen, params)
    for norm in (getattr(params, "q_norm", None), getattr(params, "k_norm", None)):
        if norm is not None:
            norm.scale.zero_()
    return params


def _qkv(params: Attention, spec: AttnSpec, x: torch.Tensor, cos, sin):
    """Project + rope; returns q (B,S,H,Dh), k/v (B,S,K,Dh)."""
    b, s, _ = x.shape
    dt = x.dtype
    q, k, v = linear_group(x, [params.wq, params.wk, params.wv])
    if spec.qkv_bias:
        q = q + cast(params.bq, dt)
        k = k + cast(params.bk, dt)
        v = v + cast(params.bv, dt)
    q = q.reshape(b, s, spec.n_heads, spec.head_dim)
    k = k.reshape(b, s, spec.n_kv_heads, spec.head_dim)
    v = v.reshape(b, s, spec.n_kv_heads, spec.head_dim)
    if spec.qk_norm:
        q = rms_norm(q, params.q_norm.scale)
        k = rms_norm(k, params.k_norm.scale)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def blockwise_attention(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, S, K, Dh)
    v: torch.Tensor,
    spec: AttnSpec,
    chunk: int = 1024,
) -> torch.Tensor:
    """Flash-style attention: online-softmax loop over KV chunks (the CPU
    path, as in the reference).  q is scaled in the compute dtype; logits and
    the PV product accumulate in float32."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh  # GQA group size
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:  # pad KV to a chunk multiple; padded keys are masked out below
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    s_kv = s + pad
    n_kv = s_kv // chunk
    window = spec.window or s_kv

    qh = (q * spec.scale).reshape(b, s, kh, g, hd).float()
    acc = torch.zeros((b, s, kh, g, hd), dtype=F32, device=q.device)
    m = torch.full((b, s, kh, g), float("-inf"), device=q.device)
    l = torch.zeros((b, s, kh, g), device=q.device)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    for i in range(n_kv):
        kv_start = i * chunk
        kc, vc = k[:, kv_start:kv_start + chunk], v[:, kv_start:kv_start + chunk]
        args = (qh, kc, vc, acc, m, l, kv_start, spec, s, window, q.dtype)
        if grad:  # the reference's jax.checkpoint(step): recompute in the backward
            acc, m, l = checkpoint(_blockwise_step, *args, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            acc, m, l = _blockwise_step(*args)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, s, h, hd).to(q.dtype)


def _blockwise_step(qh, kc, vc, acc, m, l, kv_start: int, spec: AttnSpec, s: int,
                    window: int, dtype: torch.dtype):
    """One KV chunk of :func:`blockwise_attention`'s online softmax."""
    chunk = kc.shape[1]
    q_pos = torch.arange(s, device=qh.device)
    k_pos = kv_start + torch.arange(chunk, device=qh.device)
    logits = torch.einsum("bqkgd,bckd->bqkgc", qh, kc.float())
    dist = q_pos[:, None] - k_pos[None, :]
    if spec.causal:
        mask = (dist >= 0) & (dist < window)  # (S, chunk)
    else:
        mask = dist.abs() < window  # bidirectional (encoder)
    mask = mask & (k_pos < s)[None, :]  # drop chunk padding
    logits = torch.where(mask[None, :, None, None, :], logits, MASK_VALUE)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bqkgc,bckd->bqkgd", p.to(dtype).float(), vc.float())
    return acc * alpha[..., None] + pv, m_new, l


def _attend(q, k, v, spec: AttnSpec, chunk: int) -> torch.Tensor:
    """Attention dispatch by the tensors' device: the hand-written flash
    kernel on the card, the blockwise form on the CPU — as the reference
    takes its Pallas kernel on the TPU and the XLA form elsewhere (a meta
    tensor takes the kernel's shape form)."""
    if q.device.type in KERNEL_DEVICES:
        return flash_attention(q, k, v, causal=spec.causal, window=spec.window,
                               block_k=min(chunk, q.shape[1]))
    return blockwise_attention(q, k, v, spec, chunk=chunk)


def _attention(params: Attention, spec: AttnSpec, x: torch.Tensor, positions: torch.Tensor):
    """Attention over a whole sequence: (the output projected by ``wo``, the
    rotated k and the v it attended over)."""
    cos, sin = rope_cos_sin(positions, spec.head_dim, spec.rope_theta, spec.mrope)
    q, k, v = _qkv(params, spec, x, cos, sin)
    out = params.attend(q, k, v)
    b, s = x.shape[:2]
    return linear(out.reshape(b, s, spec.n_heads * spec.head_dim), params.wo), k, v


def attention_forward(params: Attention, spec: AttnSpec, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """Attention over a sequence with no cache — the reference's
    ``attention_train``: causal or, with ``spec.causal`` False,
    bidirectional (the encoder's self-attention)."""
    return _attention(params, spec, x, positions)[0]


def attention_prefill(
    params: Attention, spec: AttnSpec, x: torch.Tensor, positions: torch.Tensor,
    cache_len: int,
) -> tuple[torch.Tensor, dict]:
    """Attention over the prompt; also emits the KV cache laid out for
    decode: (B, K, cache_len, Dh), zero-padded — for a windowed layer the
    last ``window`` positions, the ring buffer's contents."""
    y, k, v = _attention(params, spec, x, positions)
    s = x.shape[1]
    keep = s if spec.window is None else min(s, spec.window)
    pad = max(cache_len - keep, 0)
    ck = F.pad(k[:, s - keep:], (0, 0, 0, 0, 0, pad))
    cv = F.pad(v[:, s - keep:], (0, 0, 0, 0, 0, pad))
    cache = {"k": ck.transpose(1, 2).contiguous(), "v": cv.transpose(1, 2).contiguous()}
    return y, cache


def _decode_sp_axes(cache_shape: tuple[int, ...]):
    """Physical axes carrying the decode cache's sequence dim, or None."""
    spec = logical_spec("batch", None, "kv_seq", None, shape=cache_shape)
    entries = list(spec) + [None] * (4 - len(spec))
    seq_axes = entries[2]
    if seq_axes is None:
        return None, None
    seq_axes = seq_axes if isinstance(seq_axes, tuple) else (seq_axes,)
    batch_axes = entries[0]
    if batch_axes is not None and not isinstance(batch_axes, tuple):
        batch_axes = (batch_axes,)
    return seq_axes, batch_axes


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s part on this rank (the same storage), or ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def _decode_logits(qh, ck, valid) -> torch.Tensor:
    """Float32 logits of one token over the slots ``ck`` (B, K, S, Dh),
    ``MASK_VALUE`` where ``valid`` (S,) is false."""
    logits = torch.einsum("bkgd,bksd->bkgs", qh, ck.float())
    return torch.where(valid[None, None, None, :], logits, MASK_VALUE)


def _decode_attend(logits, cv) -> torch.Tensor:
    """The cached attention over the slots ``cv`` of :func:`_decode_logits`'
    ``logits``: ``softmax``, then the float32 PV product."""
    return torch.einsum("bkgs,bksd->bkgd", torch.softmax(logits, dim=-1), cv.float())


def _attention_decode_sp(spec: AttnSpec, q, k, v, cache: dict, pos, seq_axes
                         ) -> torch.Tensor:
    """Sequence-parallel cached attention (decode-SP), the reference's
    ``_attention_decode_sp``: the cache's sequence dim is split over
    ``seq_axes`` (the model axis); each rank owns a contiguous chunk of
    ``s_cache // n_seq`` ring slots, writes the new token in place only if
    it owns the slot ``pos % s_cache``, computes partial attention over its
    chunk, and the ranks combine with a 3-term online-softmax reduction —
    the running max all-reduced with ``MAX``, the sums with ``SUM``.  No
    rank gathers the cache.

    The combine is the reference's function in another arithmetic, so that
    one sequence rank gives the one-device form's bits: each rank attends
    over its chunk as the one-device form does (:func:`_decode_attend`:
    ``softmax``, PV), giving ``o``, beside its max ``m`` and ``l = Σ exp(
    logits - m)``; with ``M`` the all-reduced max, a rank's weight is ``c =
    exp(m - M) · l`` over the all-reduced sum of the ``c`` (at least 1;
    clamped at 1e-30 as the reference's ``l``), and ``out`` is the
    all-reduced sum of ``c · o``.  Over one rank ``c = l / l = 1`` exactly
    and no collective is called.

    A ``DTensor`` cache is the rank's chunk of its own batch rows (its local
    part, cut by ``launch.specs.cache_partition_specs``); a plain tensor is
    the whole cache, of which the rank reads and writes its chunk (a view).
    ``pos`` stays on the device: the owner test and the mask read no value
    back to the host.  Returns the combined ``(B, K, G, Dh)`` float32 output."""
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("decode-SP needs the mesh of the rules: enter "
                         "partitioning.mesh_axis_rules(mesh)")
    b = q.shape[0]
    kh = spec.n_kv_heads
    g = spec.n_heads // kh
    hd = spec.head_dim
    n_seq = axis_size(mesh, seq_axes)
    s_cache = cache["k"].shape[2]
    chunk = s_cache // n_seq
    idx = axis_index(mesh, seq_axes)
    group = axis_group(mesh, seq_axes)
    ck, cv = cache["k"], cache["v"]
    if hasattr(ck, "to_local"):
        ck, cv = _local(ck), _local(cv)
    else:
        ck, cv = ck.narrow(2, idx * chunk, chunk), cv.narrow(2, idx * chunk, chunk)
    if ck.shape[0] != b or ck.shape[2] != chunk:
        raise ValueError(f"the rank's cache part {tuple(ck.shape)} does not hold {b} rows "
                         f"and a chunk of {chunk} slots")
    qh = (q * spec.scale).reshape(b, kh, g, hd).float()
    local_slot = pos % s_cache - idx * chunk
    ok = (local_slot >= 0) & (local_slot < chunk)
    ls = local_slot.clamp(0, chunk - 1).reshape(1).long()
    for c, new in ((ck, k), (cv, v)):
        new = new.transpose(1, 2)
        c.index_copy_(2, ls, torch.where(ok, new, c.index_select(2, ls)))
    k_pos = idx * chunk + torch.arange(chunk, device=q.device)
    logits = _decode_logits(qh, ck, k_pos <= pos)
    o = _decode_attend(logits, cv)
    m = logits.amax(dim=-1)  # (B, K, G)
    l_own = torch.exp(logits - m[..., None]).sum(dim=-1)
    # the collectives reduce in place: the rank's m and c are used first
    c = torch.exp(m - C.all_reduce(m.clone(), group, "max")) * l_own
    c = c / torch.clamp(C.all_reduce(c.clone(), group), min=1e-30)
    return C.all_reduce(o * c[..., None], group)


def attention_decode(
    params: Attention, spec: AttnSpec, x: torch.Tensor, cache: dict, pos
) -> tuple[torch.Tensor, dict]:
    """One-token cached attention. x (B,1,D); cache k/v (B,K,S,Dh); pos a
    0-d integer tensor on x's device (or an int).

    For windowed layers the cache is a ring buffer of size ``window``: the
    write slot is ``pos % window`` and, once full, every slot is valid.
    When the active sharding rules place the cache's sequence dim on a mesh
    axis, the sequence-parallel form is used (:func:`_attention_decode_sp`:
    writes in the owning rank's chunk, an online-softmax combine), exactly
    where the reference takes its ``shard_map`` path; otherwise the
    single-device form (on a ``DTensor`` cache, the rank's part).  At one
    sequence rank the SP form gives the one-device form's bits.
    Unlike the reference (which returns new arrays) the new token is written
    into the cache tensors in place — a step would otherwise copy the whole
    cache — and the same dict is returned.  The slot, the validity mask and
    the RoPE position are computed on the device from ``pos``, so the step
    never reads ``pos`` back to the host (a CUDA graph replays it)."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device)
    # the RoPE position: pos in every component of an M-RoPE layer's (B, 3, 1)
    rope_pos = pos.expand(b, 3, 1) if spec.mrope else pos.expand(b, 1)
    cos, sin = rope_cos_sin(rope_pos, spec.head_dim, spec.rope_theta, spec.mrope)
    q, k, v = _qkv(params, spec, x, cos, sin)
    kh = spec.n_kv_heads
    g = spec.n_heads // kh
    seq_axes, _ = _decode_sp_axes(tuple(cache["k"].shape))
    if seq_axes is not None:
        out = _attention_decode_sp(spec, q, k, v, cache, pos, seq_axes)
    else:
        ck, cv = _local(cache["k"]), _local(cache["v"])
        s_cache = ck.shape[2]
        # windowed layers use the cache as a ring buffer; full caches never
        # wrap (pos < s_cache), so one modular slot covers both
        slot = (pos % s_cache).reshape(1).long()
        ck.index_copy_(2, slot, k.transpose(1, 2))
        cv.index_copy_(2, slot, v.transpose(1, 2))
        qh = (q * spec.scale).reshape(b, kh, g, spec.head_dim).float()
        # a ring slot only holds one of the last s_cache positions, so slot
        # validity reduces to "has this slot been written yet"
        out = _decode_attend(
            _decode_logits(qh, ck, torch.arange(s_cache, device=x.device) <= pos), cv)
    out = out.reshape(b, 1, spec.n_heads * spec.head_dim).to(x.dtype)
    return linear(out, params.wo), cache


def init_attention_cache(spec: AttnSpec, batch: int, max_len: int,
                         dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    s = min(max_len, spec.window) if spec.window is not None else max_len
    shape = (batch, spec.n_kv_heads, s, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ------------------------------------------------------------------- FFNs
class MLP(nn.Module):
    """``w_gate``, ``w_up``, ``w_down`` (SwiGLU / GeGLU) or ``w_in``,
    ``w_down`` (the vanilla FFN)."""

    def __init__(self, d_model: int, d_ff: int, kind: str, dtype: torch.dtype,
                 device=None):
        super().__init__()
        if kind not in ("swiglu", "geglu", "gelu"):
            raise ValueError(f"unknown mlp kind {kind!r}")
        empty = dict(dtype=dtype, device=device)
        if kind in ("swiglu", "geglu"):
            self.w_gate = _weight(torch.empty((d_model, d_ff), **empty))
            self.w_up = _weight(torch.empty((d_model, d_ff), **empty))
        else:
            self.w_in = _weight(torch.empty((d_model, d_ff), **empty))
        self.w_down = _weight(torch.empty((d_ff, d_model), **empty))


def init_mlp(gen: torch.Generator, params: MLP) -> MLP:
    """Draw an FFN's weights in place."""
    _draw_fan_in(gen, params)
    return params


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp(params: MLP, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu_tanh
        gate, up = linear_group(x, [params.w_gate, params.w_up])
        h = act(gate) * up
        return linear(h, params.w_down)
    h = _gelu_tanh(linear(x, params.w_in))
    return linear(h, params.w_down)




# -------------------------------------------------------------------- MoE
@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int  # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


class MoE(nn.Module):
    """One MoE layer's weights, named as the reference's keys: ``router (d,
    E)``, ``expert_gate`` and ``expert_up (E, d, f)``, ``expert_down (E, f,
    d)``."""

    def __init__(self, spec: MoESpec, dtype: torch.dtype, device=None):
        super().__init__()
        e, d, f = spec.n_experts, spec.d_model, spec.d_ff
        empty = dict(dtype=dtype, device=device)
        self.router = _weight(torch.empty((d, e), **empty))
        self.expert_gate = _weight(torch.empty((e, d, f), **empty))
        self.expert_up = _weight(torch.empty((e, d, f), **empty))
        self.expert_down = _weight(torch.empty((e, f, d), **empty))


@torch.no_grad()
def init_moe(gen: torch.Generator, params: MoE) -> MoE:
    """Draw an MoE layer's weights in place at the reference's scales:
    ``d^-0.5`` for the router, gate and up, ``f^-0.5`` for down; each expert
    tensor ``MOE_INIT_EXPERTS`` experts at a time."""
    d, f = params.router.shape[0], params.expert_down.shape[1]
    w = params.router
    w.copy_(normal(gen, w.shape, d**-0.5, w.dtype, w.device))
    for w, scale in ((params.expert_gate, d**-0.5), (params.expert_up, d**-0.5),
                     (params.expert_down, f**-0.5)):
        for e0 in range(0, w.shape[0], MOE_INIT_EXPERTS):
            part = w[e0:e0 + MOE_INIT_EXPERTS]
            part.copy_(normal(gen, part.shape, scale, w.dtype, w.device))
    return params


def moe_capacity(spec: MoESpec, tokens: int) -> int:
    """Rows an expert keeps: ``max(ceil(capacity_factor * k * T / E), 4)``."""
    return max(int(math.ceil(spec.capacity_factor * spec.top_k * tokens / spec.n_experts)), 4)


class Routing(NamedTuple):
    """The dispatch's arrays, the reference's names: ``idx (T, k)``, the
    chosen experts; over the ``T * k`` slots in sorted order ``order``,
    ``st``, ``sg``, ``keep``, ``dest``; ``count (E,)`` the kept slots of
    each expert (int64)."""

    idx: torch.Tensor
    order: torch.Tensor
    st: torch.Tensor
    sg: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    count: torch.Tensor


def moe_route(spec: MoESpec, probs: torch.Tensor, n_experts: int, expert_base: int,
              cap: int, rank_offset: torch.Tensor | None = None) -> Routing:
    """The reference's top-k routing and capacity ranks, step for step
    (``repro/models/layers.py:560-578``), with no value read to the host:
    top-k over the full expert range as the first ``k`` of a stable
    descending sort (``lax.top_k`` breaks ties toward the lower index), the
    gates normalised in float32, token-major slots, a stable sort of the
    slots by expert, segment starts by ``searchsorted`` (left), and each
    slot's rank in its expert; a slot past ``cap`` (or of an expert outside
    ``[expert_base, expert_base + n_experts)``) is dropped, its ``dest`` the
    row ``n_experts * cap``.

    ``rank_offset (n_experts,)``, where given, is each expert's slots that
    come before these ones in the global token order (other batch ranks'
    tokens): a slot is kept while its rank plus that offset is below
    ``cap``, and its row is its local rank (this rank's buffer holds only
    its own slots; a row's output depends on that row alone)."""
    t = probs.shape[0]
    k = spec.top_k
    dev = probs.device
    vals, ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[:, :k], ranked[:, :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    local = idx - expert_base
    mine = (local >= 0) & (local < n_experts)
    slot_expert = torch.where(mine, local, n_experts).reshape(t * k)
    slot_token = torch.arange(t * k, device=dev) // k
    slot_gate = gate.reshape(t * k)
    order = torch.argsort(slot_expert, stable=True)
    se, st, sg = slot_expert[order], slot_token[order], slot_gate[order]
    experts = torch.arange(n_experts, device=dev)
    seg_start = torch.searchsorted(se, experts)
    rank = torch.arange(t * k, device=dev) - seg_start[torch.clamp_max(se, n_experts - 1)]
    count = torch.searchsorted(se, experts, right=True) - seg_start
    if rank_offset is None:
        keep = (rank < cap) & (se < n_experts)
        count = torch.clamp_max(count, cap)
    else:
        before = rank_offset[torch.clamp_max(se, n_experts - 1)]
        keep = (rank + before < cap) & (se < n_experts)
        count = torch.clamp(torch.minimum(count, cap - rank_offset), min=0)
    dest = torch.where(keep, se * cap + rank, n_experts * cap)
    return Routing(idx, order, st, sg, keep, dest, count)


def _moe_dispatch_compute(
    spec: MoESpec, xt: torch.Tensor, probs: torch.Tensor, wg, wu, wd,
    n_experts: int, expert_base: int, cap: int, rank_offset: torch.Tensor | None = None,
) -> torch.Tensor:
    """Capacity-bounded top-k dispatch + expert FFN + weighted combine over
    the expert range ``[expert_base, expert_base + n_experts)``, as the
    reference's.  No shape depends on the data, and nothing is read back to
    the host, so a CUDA graph can hold it:

    * the buffers have one row more than the reference's, ``n_experts *
      cap``, which takes the dropped slots (the reference's out-of-bounds
      ``mode="drop"`` scatter and ``mode="fill"`` gather) and is sliced away
      or is zero;
    * the expert FFN is :func:`moe_ffn` for ``cap <= MOE_DECODE_ROWS`` (on
      the card the MoE kernel, which reads only the experts whose ``count``
      is not 0), else — and under grad, which the kernel lacks — the dense
      three products over every expert;
    * the combine (:func:`moe_combine`) is deterministic, where
      ``index_add_`` on the card would add a token's rows by atomics."""
    t, d = xt.shape
    r = moe_route(spec, probs, n_experts, expert_base, cap, rank_offset)
    buf = xt.new_zeros((n_experts * cap + 1, d))
    buf.index_copy_(0, r.dest, xt.index_select(0, r.st))
    buf = buf[:-1].view(n_experts, cap, d)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (buf, wg, wu, wd))
    if cap <= MOE_DECODE_ROWS and not grad:
        out = moe_ffn(buf, r.count, wg, wu, wd)
    else:
        out = expert_ffn_dense(buf, wg, wu, wd)
    return moe_combine(out.reshape(n_experts * cap, d), r, t)


def moe_combine(out: torch.Tensor, r: Routing, tokens: int) -> torch.Tensor:
    """``y (T, d)``: each token's kept slots' rows of ``out (E * cap, d)``
    times their gates, in ``out``'s dtype — the reference's ``zeros.at[st]
    .add(gathered * sg)``, deterministic: a token's ``k`` weighted rows are
    gathered in the sorted order (increasing expert) and added one at a time,
    the order of the reference's scatter-add on the CPU; a dropped slot
    gathers the zero row appended to ``out``."""
    k = r.idx.shape[1]
    dt = out.dtype
    rows = torch.cat([out, out.new_zeros((1, out.shape[1]))])
    # each slot's place in the sorted order; a token's k places in increasing
    # order are its slots by increasing expert
    place = torch.empty_like(r.order)
    place.scatter_(0, r.order, torch.arange(tokens * k, device=out.device))
    place = place.view(tokens, k).sort(dim=1).values
    part = rows[r.dest[place]] * r.sg[place].to(dt)[..., None]  # (T, k, d)
    y = torch.zeros((tokens, out.shape[1]), dtype=dt, device=out.device)
    for j in range(k):
        y = y + part[:, j]
    return y


def _moe_axes() -> tuple | None:
    """(expert_axes, fsdp_axes) when EP sharding rules are active."""
    rules = current_rules()
    if not rules:
        return None
    ea = rules.get("expert")
    if not ea:
        return None
    sizes = current_mesh_shape()
    n = 1
    for a in ea:
        n *= sizes.get(a, 1)
    if n <= 1:
        return None
    return tuple(ea), tuple(rules.get("fsdp") or ())


def _batch_axes() -> tuple[str, ...]:
    """The active rules' batch axes (empty with no rules)."""
    return tuple((current_rules() or {}).get("batch") or ())


def _sharded_mesh():
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("the MoE block's sharded forms need the mesh of the rules: "
                         "enter partitioning.mesh_axis_rules(mesh)")
    return mesh


def _router_probs(params: MoE, xt: torch.Tensor, router=None) -> torch.Tensor:
    return torch.softmax(linear(xt, params.router if router is None else router).float(),
                         dim=-1)


def moe_block(params: MoE, spec: MoESpec, x: torch.Tensor) -> torch.Tensor:
    """Token-choice top-k MoE with sort-based, capacity-bounded dispatch.

    With no sharding rules (or an expert axis of one rank and one batch
    rank), the reference's single-device branch.  Under a mesh's rules
    (``partitioning.mesh_axis_rules``), ``x`` is this rank's rows of the
    batch and the weights are whole on every rank (the serve path holds
    them whole; the sharded train step gathers them once a step), so the
    reference's weight all-gathers are slices here, while the compute is
    split the reference's way:

    * an expert axis of more than one rank (``_moe_axes``): the reference's
      expert-parallel ``shard_map`` forms, chosen as it chooses them
      (``stationary = fsdp_axes and t·k < 3·e_local·f_ff``, ``t`` the
      global tokens) — :func:`_moe_local_gather` (a train step's or a
      prefill's tokens: each rank runs its experts on its own tokens) or
      :func:`_moe_local_stationary` (a decode step's: tokens gathered over
      the batch axes, each rank contracts its experts' d-slice);
    * an expert axis of one rank and more than one batch rank: the
      reference runs the single-device branch under GSPMD on the global
      batch, so :func:`_moe_global_order` keeps its capacity and its
      keep/drop decisions over the global token order.
    """
    b, s, d = x.shape
    dt = x.dtype
    t = b * s
    e, k = spec.n_experts, spec.top_k
    axes = _moe_axes()
    if axes is None:
        batch_axes = _batch_axes()
        mesh = current_mesh()
        if mesh is not None and batch_axes and axis_size(mesh, batch_axes) > 1:
            return _moe_global_order(params, spec, x, mesh, batch_axes)
        cap = moe_capacity(spec, t)
        xt = x.reshape(t, d)
        probs = _router_probs(params, xt)
        y = _moe_dispatch_compute(
            spec, xt, probs, cast(params.expert_gate, dt), cast(params.expert_up, dt),
            cast(params.expert_down, dt), e, 0, cap)
        return y.reshape(b, s, d)

    expert_axes, fsdp_axes = axes
    mesh = _sharded_mesh()
    e_local = e // axis_size(mesh, expert_axes)
    f_ff = params.expert_down.shape[-2]
    batch_axes = _batch_axes()
    t_global = t * (axis_size(mesh, batch_axes) if batch_axes else 1)
    # the reference's mode choice: gathering weights moves ~3·E_l·D·F bytes a
    # shard, keeping them stationary ~tokens·k·(D+F)
    stationary = bool(fsdp_axes) and t_global * k < 3 * e_local * f_ff
    if stationary:
        return _moe_local_stationary(params, spec, x, mesh, expert_axes, fsdp_axes,
                                     batch_axes)
    return _moe_local_gather(params, spec, x, mesh, expert_axes)


def _expert_slices(params: MoE, base: int, e_local: int, dt: torch.dtype):
    return (cast(params.expert_gate[base:base + e_local], dt),
            cast(params.expert_up[base:base + e_local], dt),
            cast(params.expert_down[base:base + e_local], dt))


def _moe_local_gather(params: MoE, spec: MoESpec, x: torch.Tensor, mesh,
                      expert_axes: tuple[str, ...]) -> torch.Tensor:
    """The reference's ``local_gather``: this rank runs
    ``_moe_dispatch_compute`` on its own tokens (``cap`` from them) for its
    expert range ``[shard·e_local, (shard+1)·e_local)``, and the partial
    outputs are summed over the expert group.  The tokens and the router
    enter that group alike on every rank (their gradient the group's sum);
    the sum's gradient is handed to each rank once."""
    bl, sl, d = x.shape
    tl = bl * sl
    dt = x.dtype
    e_local = spec.n_experts // axis_size(mesh, expert_axes)
    group = axis_group(mesh, expert_axes)
    base = axis_index(mesh, expert_axes) * e_local
    xt = C.enter_partial(x.reshape(tl, d), group)
    probs = _router_probs(params, xt, C.enter_partial(params.router, group))
    wg, wu, wd = _expert_slices(params, base, e_local, dt)
    y = _moe_dispatch_compute(spec, xt, probs, wg, wu, wd, e_local, base,
                              moe_capacity(spec, tl))
    return C.sum_replicated(y, group).reshape(bl, sl, d)


def _moe_local_stationary(params: MoE, spec: MoESpec, x: torch.Tensor, mesh,
                          expert_axes: tuple[str, ...], fsdp_axes: tuple[str, ...],
                          batch_axes: tuple[str, ...]) -> torch.Tensor:
    """The reference's ``local_stationary`` (decode-sized): the tokens are
    gathered over the batch axes; this rank dispatches its ``d / n_fsdp``
    slice of each token to its experts, the partial gate and up products
    (separate products: the sum over the FSDP group comes before the SiLU)
    are summed over the FSDP group, the down product gives its d-slice of
    the output, the expert group sums those, the FSDP group gathers the
    d-slices, and the rank takes its batch rows back."""
    bl, sl, d = x.shape
    dt = x.dtype
    e_local = spec.n_experts // axis_size(mesh, expert_axes)
    n_fsdp = axis_size(mesh, fsdp_axes)
    egroup = axis_group(mesh, expert_axes)
    fgroup = axis_group(mesh, fsdp_axes)
    xe = C.enter_partial(x, egroup)
    xg = C.gather_partial(xe, axis_group(mesh, batch_axes), 0) if batch_axes else xe
    tg = xg.shape[0] * sl
    cap = moe_capacity(spec, tg)
    xt = xg.reshape(tg, d)
    probs = _router_probs(params, xt, C.enter_partial(params.router, egroup))
    base = axis_index(mesh, expert_axes) * e_local
    d_slice = d // n_fsdp
    d0 = axis_index(mesh, fsdp_axes) * d_slice
    r = moe_route(spec, probs, e_local, base, cap)
    xs = xt[:, d0:d0 + d_slice]
    buf = xs.new_zeros((e_local * cap + 1, d_slice))
    buf = buf.index_copy(0, r.dest, xs.index_select(0, r.st))[:-1].view(e_local, cap, d_slice)
    wg, wu, wd = _expert_slices(params, base, e_local, dt)
    h = torch.bmm(buf, wg[:, d0:d0 + d_slice])
    hu = torch.bmm(buf, wu[:, d0:d0 + d_slice])
    h = C.sum_partial(torch.stack([h, hu]), fgroup)
    h = F.silu(h[0]) * h[1]
    out = torch.bmm(h, wd[:, :, d0:d0 + d_slice]).reshape(e_local * cap, d_slice)
    y = C.sum_replicated(moe_combine(out, r, tg), egroup)  # (tg, d_slice)
    y = C.gather_partial(y, fgroup, 1) if n_fsdp > 1 else y  # (tg, D)
    tl = bl * sl
    row0 = axis_index(mesh, batch_axes) * tl if batch_axes else 0
    return y[row0:row0 + tl].reshape(bl, sl, d)


def _moe_global_order(params: MoE, spec: MoESpec, x: torch.Tensor, mesh,
                      batch_axes: tuple[str, ...]) -> torch.Tensor:
    """The single-device branch over a batch split on several ranks, as
    the reference runs it under GSPMD on the global batch: the capacity of
    the global token count, and each slot's rank in its expert counted over
    the global token order (batch-rank-major) — each rank's count of slots
    an expert all-gathered over the batch group, the lower ranks' sums the
    offsets of this rank's slots.  Only this rank's slots are dispatched."""
    b, s, d = x.shape
    dt = x.dtype
    t = b * s
    e, k = spec.n_experts, spec.top_k
    group = axis_group(mesh, batch_axes)
    n = axis_size(mesh, batch_axes)
    cap = moe_capacity(spec, t * n)
    xt = x.reshape(t, d)
    probs = _router_probs(params, xt)
    with torch.no_grad():
        idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
        mine = torch.bincount(idx.reshape(-1), minlength=e)
        counts = C.all_gather(mine[None], group, 0)  # (n, E)
        rank_offset = counts[:axis_index(mesh, batch_axes)].sum(dim=0)
    y = _moe_dispatch_compute(
        spec, xt, probs, cast(params.expert_gate, dt), cast(params.expert_up, dt),
        cast(params.expert_down, dt), e, 0, cap, rank_offset)
    return y.reshape(b, s, d)


def moe_aux_loss(params: MoE, spec: MoESpec, x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss (mean over tokens), float32.  Under a
    mesh's rules with more than one batch rank, the mean is over the global
    batch, as the reference's under GSPMD: the top-1 counts, the summed
    probabilities (its gradient summed too) and the token count are
    all-reduced over the batch group."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs = _router_probs(params, xt)
    top1 = torch.argmax(probs, dim=-1)
    mesh, batch_axes = current_mesh(), _batch_axes()
    if mesh is None or not batch_axes or axis_size(mesh, batch_axes) == 1:
        frac = F.one_hot(top1, spec.n_experts).float().mean(dim=0)
        imp = probs.mean(dim=0)
        return spec.n_experts * torch.sum(frac * imp)
    group = axis_group(mesh, batch_axes)
    tokens = b * s * axis_size(mesh, batch_axes)
    frac = C.all_reduce(F.one_hot(top1, spec.n_experts).float().sum(dim=0), group) / tokens
    imp = C.sum_partial(probs.sum(dim=0), group) / tokens
    return spec.n_experts * torch.sum(frac * imp)


# --------------------------------------------------------- depthwise conv
def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                  state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv. x (B, S, C), kernel (W, C). Returns (y,
    new_state), ``new_state`` the last W-1 inputs — a new tensor, which a
    decode copies into its cache (:func:`_store`).

    W shifted adds, as the reference.  ``state`` (B, W-1, C) is the last
    W-1 inputs for streaming decode; ``torch.cat`` promotes ``state`` and
    ``x`` to one dtype as ``jnp.concatenate`` does."""
    w = kernel.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], w - 1, x.shape[2]))
    ext = torch.cat([state, x], dim=1)  # (B, S+W-1, C)
    s = x.shape[1]
    y = ext[:, 0:s] * cast(kernel[0], x.dtype)
    for i in range(1, w):
        y = y + ext[:, i:i + s] * cast(kernel[i], x.dtype)
    return y, ext[:, -(w - 1):]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def check_state(state: dict, dtype: torch.dtype) -> None:
    """A recurrent state a decode at compute ``dtype`` can write in place:
    its ``conv`` must hold what the step's concatenation gives (the
    promotion of its own dtype and ``dtype``: a bf16 ``conv`` at float32
    compute would need a new float32 array, which the reference returns and
    an in-place step cannot), and ``ssm`` / ``h`` must be float32.  A host
    check of dtypes alone (safe inside a CUDA graph's capture)."""
    conv = state["conv"]
    if torch.promote_types(conv.dtype, dtype) != conv.dtype:
        raise ValueError(
            f"the conv state is {conv.dtype} but a {dtype} decode step writes "
            f"{torch.promote_types(conv.dtype, dtype)} into it: cast the state first "
            f"(a prefill returns it in the compute dtype)")
    for name in ("ssm", "h"):
        if name in state and state[name].dtype != F32:
            raise ValueError(f"the {name} state must be float32, got {state[name].dtype}")


# ---------------------------------------------------------------- Mamba-2
@dataclasses.dataclass(frozen=True)
class SSDSpec:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


class SSD(nn.Module):
    """One Mamba-2 mixer's weights, the reference's keys: ``w_zx`` (the fused
    input projection to ``[z, x, B, C, dt]``), ``conv_kernel``, ``a_log``,
    ``dt_bias``, ``d_skip``, ``norm.scale`` and ``w_out``.  ``a_log``,
    ``dt_bias`` and ``d_skip`` stay float32 at every compute dtype (the
    reference reads them from its float32 master copy)."""

    def __init__(self, spec: SSDSpec, dtype: torch.dtype, device=None):
        super().__init__()
        if spec.n_groups != 1:
            raise NotImplementedError("SSD is implemented for n_groups=1 (mamba2 default)")
        d, di, n, h = spec.d_model, spec.d_inner, spec.d_state, spec.n_heads
        empty = dict(dtype=dtype, device=device)
        self.w_zx = _weight(torch.empty((d, 2 * di + 2 * n + h), **empty))
        self.conv_kernel = _weight(torch.empty((spec.conv_width, spec.conv_channels), **empty))
        self.a_log = _weight(torch.empty(h, dtype=F32, device=device))
        self.dt_bias = _weight(torch.empty(h, dtype=F32, device=device))
        self.d_skip = _weight(torch.empty(h, dtype=F32, device=device))
        self.norm = RMSNorm(di, device)
        self.w_out = _weight(torch.empty((di, d), **empty))


@torch.no_grad()
def init_ssd(gen: torch.Generator, params: SSD) -> SSD:
    """Draw a Mamba-2 mixer's weights in place at the reference's scales
    (``w_zx`` and ``w_out`` by fan-in, ``conv_kernel`` by its channels) and
    set its constants: ``a_log = log(linspace(1, 16, H))``, ``dt_bias =
    log(expm1(1e-2))`` (softplus⁻¹ of 0.01), ``d_skip = 1``."""
    for w, scale in ((params.w_zx, params.w_zx.shape[0] ** -0.5),
                     (params.conv_kernel, params.conv_kernel.shape[1] ** -0.5),
                     (params.w_out, params.w_out.shape[0] ** -0.5)):
        w.copy_(normal(gen, w.shape, scale, w.dtype, w.device))
    h = params.a_log.shape[0]
    params.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, h, dtype=F32)))
    params.dt_bias.copy_(torch.log(torch.expm1(torch.full((h,), 1e-2, dtype=F32))))
    params.d_skip.fill_(1.0)
    params.norm.scale.zero_()
    return params


def _ssd_split(params: SSD, spec: SSDSpec, x: torch.Tensor):
    """Input projection; returns z, xbc (the conv's channels: x, B, C), dt."""
    di, n, h = spec.d_inner, spec.d_state, spec.n_heads
    zxbcdt = linear(x, params.w_zx)
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., -h:]


def _ssd_post(params: SSD, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params.norm.scale)
    return linear(y, params.w_out)


def ssd_block(params: SSD, spec: SSDSpec, x: torch.Tensor, return_state: bool = False):
    """Mamba-2 SSD, the reference's chunked "state-space duality" form.

    Within a chunk the recurrence is a masked contraction (batched matmuls,
    laid out ``(B, nc, H, Q, K)`` so the mask is one float32 tensor, built
    in place); across chunks a loop over the ``nc`` chunks carries the
    ``(B, H, P, N)`` state.  A sequence that is not a chunk multiple is
    padded, the padded steps frozen with ``dt = 0``, and the conv state is
    the last W-1 *valid* inputs, as in the reference."""
    b, s, _ = x.shape
    di, n, h, p = spec.d_inner, spec.d_state, spec.n_heads, spec.head_dim
    q = min(spec.chunk, s)
    pad = (-s) % q
    s_real = s
    if pad:  # pad to a chunk multiple; padded steps are frozen via dt=0 below
        x = F.pad(x, (0, 0, 0, pad))
        s = s + pad
    nc = s // q

    z, xbc, dt = _ssd_split(params, spec, x)
    xbc_pre = F.silu(xbc)
    xbc, conv_state = causal_conv1d(xbc_pre, params.conv_kernel)
    if pad and return_state:  # conv state = last W-1 *valid* inputs
        w = params.conv_kernel.shape[0]
        ext = torch.cat([xbc_pre.new_zeros((b, w - 1, xbc_pre.shape[2])),
                         xbc_pre[:, :s_real]], dim=1)
        conv_state = ext[:, -(w - 1):]
    xh = xbc[..., :di]
    bm = xbc[..., di:di + n]  # (B, S, N), single group
    cm = xbc[..., di + n:]  # (B, S, N)

    dt = softplus(dt.float() + params.dt_bias)  # (B, S, H)
    if pad:  # dt=0 on padding: decay=1 and zero input — state passes through
        dt = dt * (torch.arange(s, device=x.device) < s_real).to(F32)[None, :, None]
    a = -torch.exp(params.a_log)  # (H,)
    log_decay = dt * a  # (B, S, H) = log a_t (negative)

    xh = xh.reshape(b, s, h, p)
    xdt = xh.float() * dt[..., None]  # dt-weighted input
    xc = xdt.reshape(b, nc, q, h, p)
    bc = bm.reshape(b, nc, q, n).float()
    cc = cm.reshape(b, nc, q, n).float()
    cum = torch.cumsum(log_decay.reshape(b, nc, q, h), dim=2)  # (B, nc, Q, H) inclusive
    total = cum[:, :, -1]  # (B, nc, H)

    # ---- intra-chunk: M[h, q, k] = (C_q . B_k) * exp(cum_q - cum_k) * causal
    gl = cc @ bc.transpose(-1, -2)  # (B, nc, Q, K)
    cum_h = cum.permute(0, 1, 3, 2)  # (B, nc, H, Q)
    m = cum_h[..., :, None] - cum_h[..., None, :]  # (B, nc, H, Q, K)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    if torch.is_grad_enabled():  # autograd keeps exp's output: no in-place product
        m = torch.exp(m.masked_fill(~causal, float("-inf"))) * gl[:, :, None]
    else:
        m.masked_fill_(~causal, float("-inf")).exp_().mul_(gl[:, :, None])
    y_intra = m @ xc.permute(0, 1, 3, 2, 4)  # (B, nc, H, Q, P)
    del m, gl

    # ---- chunk states: S_c = sum_k B_k ⊗ x_k * exp(total - cum_k)
    wk = torch.exp(total[:, :, None, :] - cum)  # (B, nc, Q, H)
    xw = (xc * wk[..., None]).permute(0, 1, 3, 4, 2)  # (B, nc, H, P, Q)
    states = xw @ bc[:, :, None]  # (B, nc, H, P, N)

    # ---- inter-chunk scan (nc steps, tiny state)
    h_prev = torch.zeros((b, h, p, n), dtype=F32, device=x.device)
    decay = torch.exp(total)  # (B, nc, H)
    h_prevs = []  # the state entering each chunk
    for c in range(nc):
        h_prevs.append(h_prev)
        h_prev = h_prev * decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (B, nc, H, P, N)

    # ---- inter-chunk contribution: Y_inter[q] = (C_q . h_prev) * exp(cum_q)
    y_inter = (cc[:, :, None] @ h_prevs.transpose(-1, -2))  # (B, nc, H, Q, P)
    y_inter = y_inter * torch.exp(cum_h)[..., None]

    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    y = y + xh.float() * params.d_skip[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    if pad:
        y, z = y[:, :s_real], z[:, :s_real]
    out = _ssd_post(params, y, z)
    if return_state:
        return out, {"conv": conv_state.contiguous(), "ssm": h_prev}
    return out


def init_ssd_state(spec: SSDSpec, batch: int, device=None) -> dict:
    """The reference's zero state: ``conv`` bf16 at every compute dtype (as
    the reference's), ``ssm`` float32."""
    return {"conv": torch.zeros((batch, spec.conv_width - 1, spec.conv_channels),
                                dtype=torch.bfloat16, device=device),
            "ssm": torch.zeros((batch, spec.n_heads, spec.head_dim, spec.d_state),
                               dtype=F32, device=device)}


def ssd_decode(params: SSD, spec: SSDSpec, x: torch.Tensor, state: dict
               ) -> tuple[torch.Tensor, dict]:
    """Single-token SSD step: h = a*h + B ⊗ (dt*x); y = C.h + D*x.  The new
    conv and SSM states are written into ``state``'s tensors in place (a
    CUDA graph keeps their addresses) and the same dict is returned; a state
    the step cannot write in place raises (:func:`check_state`)."""
    check_state(state, x.dtype)
    b = x.shape[0]
    di, n, h, p = spec.d_inner, spec.d_state, spec.n_heads, spec.head_dim
    z, xbc, dt = _ssd_split(params, spec, x)
    xbc, conv_state = causal_conv1d(F.silu(xbc), params.conv_kernel, state["conv"])
    xh = xbc[:, 0, :di].reshape(b, h, p).float()
    bm = xbc[:, 0, di:di + n].float()  # (B, N), single group
    cm = xbc[:, 0, di + n:].float()  # (B, N)
    dt = softplus(dt[:, 0].float() + params.dt_bias)  # (B, H)
    a = torch.exp(dt * -torch.exp(params.a_log))  # (B, H)
    xdt = xh * dt[..., None]  # (B, H, P)
    ssm = state["ssm"]
    ssm.mul_(a[..., None, None]).add_(xdt[..., None] * bm[:, None, None, :])
    y = (ssm @ cm[:, None, :, None])[..., 0]  # (B, H, P)
    y = y + xh * params.d_skip[None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    state["conv"].copy_(conv_state)
    return _ssd_post(params, y, z), state


# ----------------------------------------------------------------- RG-LRU
@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    d_model: int
    lru_width: int
    conv_width: int = 4
    c: float = 8.0  # the paper's fixed temperature


class Scan(nn.Module):
    """The RG-LRU recurrence of a layer: ``(a, x) -> h``, by
    :func:`~repro_torch.kernels.rglru_scan.rglru_scan`.  A module of its own,
    with no parameters, so a forward hook can read what a layer hands the
    kernel."""

    def forward(self, a, x):
        return rglru_scan(a, x)


class RGLRU(nn.Module):
    """One Griffin recurrent mixer's weights, the reference's keys:
    ``w_branch`` ([gate branch, recurrent branch]), ``conv_kernel``, ``w_a``,
    ``b_a`` (the recurrence gate), ``w_x``, ``b_x`` (the input gate),
    ``lambda_`` and ``w_out``.  The gate weights and biases and ``lambda_``
    stay float32 at every compute dtype: the reference gates in float32 from
    its float32 master copy (``_rglru_gates`` casts ``w_a`` / ``w_x`` to
    float32), so no step makes a float32 copy of them."""

    def __init__(self, spec: RGLRUSpec, dtype: torch.dtype, device=None):
        super().__init__()
        d, w = spec.d_model, spec.lru_width
        empty = dict(dtype=dtype, device=device)
        f32 = dict(dtype=F32, device=device)
        self.w_branch = _weight(torch.empty((d, 2 * w), **empty))
        self.conv_kernel = _weight(torch.empty((spec.conv_width, w), **empty))
        self.w_a = _weight(torch.empty((w, w), **f32))
        self.b_a = _weight(torch.empty(w, **f32))
        self.w_x = _weight(torch.empty((w, w), **f32))
        self.b_x = _weight(torch.empty(w, **f32))
        self.lambda_ = _weight(torch.empty(w, **f32))
        self.w_out = _weight(torch.empty((w, d), **empty))
        self.scan = Scan()


@torch.no_grad()
def init_rglru(gen: torch.Generator, params: RGLRU, c: float = 8.0) -> RGLRU:
    """Draw a recurrent mixer's weights in place at the reference's scales
    (``w_branch``, ``w_a``, ``w_x``, ``w_out`` by fan-in, ``conv_kernel`` by
    the width), zero biases, and ``lambda_`` as the reference draws it:
    ``u ~ U(0.9², 0.999²)``, ``Λ = log(u^(1/c) / (1 - u^(1/c)))``, so that
    ``sigmoid(Λ)^c = u`` (the reference's comment says [0.9, 0.999]; its
    draw gives [0.81, 0.998])."""
    w = params.lambda_.shape[0]
    u = torch.rand((w,), generator=gen, dtype=F32, device=params.lambda_.device)
    u = u * (0.999**2 - 0.9**2) + 0.9**2
    root = u ** (1.0 / c)
    params.lambda_.copy_(torch.log(root / (1 - root)))
    for t, scale in ((params.w_branch, params.w_branch.shape[0] ** -0.5),
                     (params.conv_kernel, w ** -0.5), (params.w_a, w ** -0.5),
                     (params.w_x, w ** -0.5), (params.w_out, w ** -0.5)):
        t.copy_(normal(gen, t.shape, scale, t.dtype, t.device))
    params.b_a.zero_()
    params.b_x.zero_()
    return params


def _rglru_gates(params: RGLRU, spec: RGLRUSpec, xr: torch.Tensor):
    """Per-step gate math shared by scan and decode. xr (…, W) float32."""
    r = torch.sigmoid(xr @ cast(params.w_a, F32) + cast(params.b_a, F32))
    i = torch.sigmoid(xr @ cast(params.w_x, F32) + cast(params.b_x, F32))
    log_a = -spec.c * r * softplus(params.lambda_)  # (…, W)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * i * xr


def rglru_block(params: RGLRU, spec: RGLRUSpec, x: torch.Tensor, return_state: bool = False):
    """Griffin recurrent block: conv → RG-LRU → gate-mix.  The recurrence
    runs :func:`rglru_scan` (on the card the hand-written scan kernel)."""
    dt = x.dtype
    branches = linear(x, params.w_branch)
    gate = _gelu_tanh(branches[..., :spec.lru_width])
    xr, conv_state = causal_conv1d(branches[..., spec.lru_width:], params.conv_kernel)
    xr = xr.float()
    a, bterm = _rglru_gates(params, spec, xr)  # (B, S, W) each
    h = params.scan(a.contiguous(), bterm.contiguous())
    y = h.to(dt) * gate
    out = linear(y, params.w_out)
    if return_state:
        return out, {"conv": conv_state.contiguous(), "h": h[:, -1].contiguous()}
    return out


def init_rglru_state(spec: RGLRUSpec, batch: int, device=None) -> dict:
    """The reference's zero state: ``conv`` bf16 at every compute dtype, ``h``
    float32."""
    return {"conv": torch.zeros((batch, spec.conv_width - 1, spec.lru_width),
                                dtype=torch.bfloat16, device=device),
            "h": torch.zeros((batch, spec.lru_width), dtype=F32, device=device)}


def rglru_decode(params: RGLRU, spec: RGLRUSpec, x: torch.Tensor, state: dict
                 ) -> tuple[torch.Tensor, dict]:
    """One recurrent step; the new conv state and ``h`` are written into
    ``state``'s tensors in place and the same dict is returned (a state the
    step cannot write in place raises: :func:`check_state`)."""
    check_state(state, x.dtype)
    dt = x.dtype
    branches = linear(x, params.w_branch)
    gate = _gelu_tanh(branches[..., :spec.lru_width])
    xr, conv_state = causal_conv1d(branches[..., spec.lru_width:], params.conv_kernel,
                                   state["conv"])
    a, bterm = _rglru_gates(params, spec, xr[:, 0].float())
    h = state["h"].mul_(a).add_(bterm)
    state["conv"].copy_(conv_state)
    return linear(h[:, None, :].to(dt) * gate, params.w_out), state
