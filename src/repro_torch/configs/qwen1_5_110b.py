"""qwen1.5-110b — dense GQA transformer with QKV bias.

[hf:Qwen/Qwen1.5-0.5B family scaled per assignment; hf-verified tier]
"""

from .base import ArchConfig

FULL = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,  # the Qwen1.5 signature
    grad_accum=16,
    scan_unroll=2,  # §Perf iter 2: 80 -> 40 residual checkpoints (unroll=4 refuted: +10% memory term, no peak win)
    rope_theta=1e6,
    mlp_kind="swiglu",
    source="hf:Qwen/Qwen1.5-0.5B (family); assignment row",
)

SMOKE = ArchConfig(
    name="qwen1.5-110b-smoke",
    family="dense",
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab=512,
    qkv_bias=True,
    rope_theta=1e4,
    mlp_kind="swiglu",
    attn_chunk=64,
    loss_chunk=64,
)
