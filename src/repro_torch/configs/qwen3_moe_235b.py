"""qwen3-moe-235b-a22b — 128-expert top-8 MoE.  [hf:Qwen/Qwen3-30B-A3B; hf]"""

from .base import ArchConfig

FULL = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,  # qwen3 family uses explicit head_dim=128 (64·128 > d_model)
    d_ff=1536,  # per-expert hidden (moe_intermediate_size)
    vocab=151936,
    block_pattern=("moe",),
    n_experts=128,
    top_k=8,
    qk_norm=True,  # qwen3 family signature
    grad_accum=4,  # §Perf iter 2: 16 re-gathered expert weights 4× too often
    scan_unroll=2,  # halves residual checkpoints (94 -> 47 scan steps)
    param_dtype="bfloat16",  # f32 AdamW state cannot fit 235B on 256 chips
    rope_theta=1e6,
    mlp_kind="swiglu",
    source="hf:Qwen/Qwen3-30B-A3B (family)",
)

SMOKE = ArchConfig(
    name="qwen3-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab=512,
    block_pattern=("moe",),
    n_experts=8,
    top_k=2,
    qk_norm=True,
    rope_theta=1e4,
    attn_chunk=64,
    loss_chunk=64,
)
