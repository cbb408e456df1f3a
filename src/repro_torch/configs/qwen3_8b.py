"""qwen3-8b — dense GQA transformer with QK-norm.  [hf:Qwen/Qwen3-8B; hf]"""

from .base import ArchConfig

FULL = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,  # the Qwen3 signature
    grad_accum=4,
    scan_unroll=2,
    rope_theta=1e6,
    mlp_kind="swiglu",
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = ArchConfig(
    name="qwen3-8b-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab=512,
    qk_norm=True,
    rope_theta=1e4,
    attn_chunk=64,
    loss_chunk=64,
)
