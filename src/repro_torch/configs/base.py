"""Config schema + shape registry — the port's copy of ``repro.configs.base``.

``ArchConfig`` (with ``param_count``), ``ShapeSpec``, ``SHAPES`` and
``ARCH_NAMES`` are copied unchanged.  Of the ten architectures the port
serves the dense attention-only ones it has modules for: ``qwen3-8b``,
``gemma3-27b`` and the two with QKV bias, ``qwen1.5-110b`` and
``internlm2-20b``.  ``get_config`` / ``get_smoke_config`` of another name raise
``NotImplementedError`` naming ROADMAP queue 1 item 8 (the rest of the LM
stack: MoE, SSD, RG-LRU, M-RoPE and enc-dec blocks).
"""

from __future__ import annotations

import dataclasses
import importlib

# ----------------------------------------------------------------- configs
@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture, expressed as a layer pattern over block kinds.

    ``block_pattern`` is the repeat unit (e.g. 5 local + 1 global for
    gemma3); layers = pattern repeated ``n_layers // len(pattern)`` times,
    plus a prefix tail for the remainder.  Kinds: ``attn`` (global causal),
    ``local`` (sliding window), ``moe`` (global attn + MoE FFN), ``ssd``
    (Mamba-2 mixer, no FFN), ``rglru`` (RG-LRU mixer + FFN).
    """

    name: str
    family: str  # dense | moe | vlm | ssm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    block_pattern: tuple[str, ...] = ("attn",)
    window: int = 1024  # sliding window for "local" kinds
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope: bool = False  # M-RoPE (qwen2-vl): positions are (B, 3, S)
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu (vanilla)
    embed_inputs: bool = True  # False: batch provides precomputed embeddings
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid (recurrentgemma)
    lru_width: int = 0  # 0 -> d_model
    # enc-dec (seamless)
    n_enc_layers: int = 0  # >0 selects the encoder-decoder family
    enc_subsample: int = 8  # frontend stub: frames = seq // subsample
    # numerics / scale
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"  # master params+moments; bf16 for MoE giants
    grad_accum: int = 1  # microbatches per step (activation-memory control)
    scan_unroll: int = 1  # units per scan step (residual-checkpoint control)
    attn_chunk: int = 1024
    loss_chunk: int = 2048
    vocab_pad_to: int = 128
    sub_quadratic: bool = False  # eligible for long_500k (DESIGN.md skip rules)
    notes: str = ""
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab + p - 1) // p) * p

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def tail_pattern(self) -> tuple[str, ...]:
        return self.block_pattern[: self.n_layers % len(self.block_pattern)]

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def param_count(self) -> int:
        """Exact parameter count N for the 6·N·D model-FLOPs estimate."""
        d, hd = self.d_model, self.resolved_head_dim
        h, k = self.n_heads, self.n_kv_heads
        attn = d * hd * (h + 2 * k) + h * hd * d
        if self.qkv_bias:
            attn += hd * (h + 2 * k)
        if self.qk_norm:
            attn += 2 * hd
        mlp = d * self.d_ff * (3 if self.mlp_kind in ("swiglu", "geglu") else 2)
        moe = d * self.n_experts + self.n_experts * d * self.d_ff * 3
        di = self.ssm_expand * d
        ssm_h = di // self.ssm_head_dim
        ssd = (
            d * (2 * di + 2 * self.ssm_state + ssm_h)
            + 4 * (di + 2 * self.ssm_state)
            + 3 * ssm_h + di + di * d
        )
        lw = self.lru_width or d
        rglru = d * 2 * lw + 4 * lw + 2 * lw * lw + 2 * lw + lw + lw * d
        per_kind = {
            "attn": attn + mlp + 2 * d,
            "local": attn + mlp + 2 * d,
            "moe": attn + moe + 2 * d,
            "ssd": ssd + d,
            "rglru": attn * 0 + rglru + mlp + 2 * d,
        }
        total = 0
        kinds = list(self.block_pattern) * self.n_units + list(self.tail_pattern)
        for kind in kinds:
            total += per_kind[kind]
        if self.is_encdec:  # encoder self-attn + FFN, decoder adds cross-attn
            total += self.n_enc_layers * (attn + mlp + 2 * d)
            total += self.n_layers * (attn + d)  # cross-attention + norm
        total += self.padded_vocab * d  # embedding
        total += self.padded_vocab * d  # untied lm head
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        expert = d * self.d_ff * 3
        inactive = (self.n_experts - self.top_k) * expert
        n_moe_layers = sum(
            1 for kind in (list(self.block_pattern) * self.n_units
                           + list(self.tail_pattern)) if kind == "moe"
        )
        return self.param_count() - n_moe_layers * inactive


# ------------------------------------------------------------------ shapes
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_NAMES = (
    "qwen1.5-110b",
    "qwen3-8b",
    "internlm2-20b",
    "gemma3-27b",
    "llama4-maverick-400b-a17b",
    "qwen3-moe-235b-a22b",
    "qwen2-vl-72b",
    "mamba2-1.3b",
    "seamless-m4t-medium",
    "recurrentgemma-9b",
)

_MODULES = {
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen3-8b": "qwen3_8b",
    "internlm2-20b": "internlm2_20b",
    "gemma3-27b": "gemma3_27b",
}


def _module(name: str):
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown architecture {name!r}; want one of {ARCH_NAMES}")
    if name not in _MODULES:
        raise NotImplementedError(
            f"{name} needs LM modules the port does not have yet (ROADMAP "
            f"queue 1 item 8); ported: {tuple(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).FULL


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE
