"""The dense layer subset of ``repro.models.layers`` on PyTorch.

Blocks: RMSNorm, RoPE, GQA attention (the blockwise online-softmax form on
the CPU, the hand-written flash kernel on the card, cached attention for
decode, optional sliding window / qk-norm / QKV bias) and the
SwiGLU / GeGLU / vanilla FFNs, plus the int8 serving weights
(:class:`QuantizedWeight`, :func:`quantize_weight`,
:func:`quantize_for_serving`).  MoE, Mamba-2 SSD, RG-LRU and M-RoPE raise
``NotImplementedError`` naming their ROADMAP item.

Parameters live in small ``nn.Module``s (:class:`RMSNorm`,
:class:`Attention`, :class:`MLP`) whose attribute names are the reference's
parameter-tree keys, so a layer's ``state_dict`` names are the reference's
paths.  Matmul weights are stored in the compute dtype and norm scales in
float32 — the numbers the reference gets from its float32 master copy cast
at use.  Weights never require grad: this slice serves only.

Every matmul against a weight goes through :func:`linear`: a plain
``x @ cast(w, dt)``, except for an int8 weight on the card with at most
``W8_DECODE_ROWS`` rows of ``x`` (a decode step), which goes to the
hand-written int8-weight kernel (``kernels/w8_matmul.py``) so that the
device reads the int8 buffer and never a dequantized copy.

Dtype discipline is the reference's: compute runs in the activations' dtype,
and softmax, norms and RoPE run in float32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.w8_matmul import MAX_ROWS, dequantize, w8_matmul

F32 = torch.float32

MASK_VALUE = -1e30
# rows of x up to which an int8 weight's product on the card runs the W8
# kernel (a decode step: B x 1 rows); above it (a prefill) the weight is
# dequantized once and multiplied by torch.matmul
W8_DECODE_ROWS = MAX_ROWS


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


# RG-LRU gate matrices (w_a, w_x) stay bf16: they parameterize decay rates,
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
def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 mrope: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (B, S) -> (B, S, half)."""
    if mrope:
        raise NotImplementedError(
            "M-RoPE is not ported yet (ROADMAP queue 1 item 8.6, M-RoPE/VLM)")
    half = head_dim // 2
    dev = positions.device
    exps = -torch.arange(half, dtype=F32, device=dev) / half
    # theta as a filled device scalar, not a host copy: a CUDA graph can
    # capture a fill, not a copy from pageable memory
    freqs = torch.pow(torch.full((), theta, dtype=F32, device=dev), exps)
    ang = positions.to(F32)[..., None] * freqs  # (B, S, half)
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
    q = linear(x, params.wq)
    k = linear(x, params.wk)
    v = linear(x, params.wv)
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
    q_pos = torch.arange(s, device=q.device)
    acc = torch.zeros((b, s, kh, g, hd), dtype=F32, device=q.device)
    m = torch.full((b, s, kh, g), float("-inf"), device=q.device)
    l = torch.zeros((b, s, kh, g), device=q.device)
    for i in range(n_kv):
        kv_start = i * chunk
        kc = k[:, kv_start:kv_start + chunk].float()
        vc = v[:, kv_start:kv_start + chunk].float()
        k_pos = kv_start + torch.arange(chunk, device=q.device)
        logits = torch.einsum("bqkgd,bckd->bqkgc", qh, kc)
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
        pv = torch.einsum("bqkgc,bckd->bqkgd", p.to(q.dtype).float(), vc)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, s, h, hd).to(q.dtype)


def _attend(q, k, v, spec: AttnSpec, chunk: int) -> torch.Tensor:
    """Attention dispatch by the tensors' device: the hand-written flash
    kernel on the card, the blockwise form on the CPU — as the reference
    takes its Pallas kernel on the TPU and the XLA form elsewhere."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=spec.causal, window=spec.window)
    return blockwise_attention(q, k, v, spec, chunk=chunk)


def attention_prefill(
    params: Attention, spec: AttnSpec, x: torch.Tensor, positions: torch.Tensor,
    cache_len: int,
) -> tuple[torch.Tensor, dict]:
    """Attention over the prompt; also emits the KV cache laid out for
    decode: (B, K, cache_len, Dh), zero-padded — for a windowed layer the
    last ``window`` positions, the ring buffer's contents."""
    cos, sin = rope_cos_sin(positions, spec.head_dim, spec.rope_theta, spec.mrope)
    q, k, v = _qkv(params, spec, x, cos, sin)
    out = params.attend(q, k, v)
    b, s = x.shape[:2]
    y = linear(out.reshape(b, s, spec.n_heads * spec.head_dim), params.wo)
    keep = s if spec.window is None else min(s, spec.window)
    pad = max(cache_len - keep, 0)
    ck = F.pad(k[:, s - keep:], (0, 0, 0, 0, 0, pad))
    cv = F.pad(v[:, s - keep:], (0, 0, 0, 0, 0, pad))
    cache = {"k": ck.transpose(1, 2).contiguous(), "v": cv.transpose(1, 2).contiguous()}
    return y, cache


def attention_decode(
    params: Attention, spec: AttnSpec, x: torch.Tensor, cache: dict, pos
) -> tuple[torch.Tensor, dict]:
    """One-token cached attention. x (B,1,D); cache k/v (B,K,S,Dh); pos a
    0-d integer tensor on x's device (or an int).

    For windowed layers the cache is a ring buffer of size ``window``: the
    write slot is ``pos % window`` and, once full, every slot is valid.
    Unlike the reference (which returns new arrays) the new token is written
    into the cache tensors in place — a step would otherwise copy the whole
    cache — and the same dict is returned.  The slot, the validity mask and
    the RoPE position are computed on the device from ``pos``, so the step
    never reads ``pos`` back to the host (a CUDA graph replays it)."""
    b = x.shape[0]
    s_cache = cache["k"].shape[2]
    pos = torch.as_tensor(pos, device=x.device)
    cos, sin = rope_cos_sin(pos.expand(b, 1), spec.head_dim, spec.rope_theta, spec.mrope)
    q, k, v = _qkv(params, spec, x, cos, sin)
    kh = spec.n_kv_heads
    g = spec.n_heads // kh
    # windowed layers use the cache as a ring buffer; full caches never
    # wrap (pos < s_cache), so one modular slot covers both
    slot = (pos % s_cache).reshape(1).long()
    ck, cv = cache["k"], cache["v"]
    ck.index_copy_(2, slot, k.transpose(1, 2))
    cv.index_copy_(2, slot, v.transpose(1, 2))
    qh = (q * spec.scale).reshape(b, kh, g, spec.head_dim).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qh, ck.float())
    # a ring slot only holds one of the last s_cache positions, so slot
    # validity reduces to "has this slot been written yet"
    valid = torch.arange(s_cache, device=x.device) <= pos
    logits = torch.where(valid[None, None, None, :], logits, MASK_VALUE)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", w, cv.float())
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
        h = act(linear(x, params.w_gate)) * linear(x, params.w_up)
        return linear(h, params.w_down)
    h = _gelu_tanh(linear(x, params.w_in))
    return linear(h, params.w_down)

