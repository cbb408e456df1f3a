"""recurrentgemma-9b — RG-LRU + local attention hybrid, 1 attn : 2 recurrent.

[arXiv:2402.19427; unverified]  Constant-size RG-LRU state + 2048-window
local attention make it sub-quadratic: long_500k runs with O(window) memory.
38 layers = 12×(R,R,L) + 2-layer (R,R) tail.
"""

from .base import ArchConfig

FULL = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,  # MQA, per the assignment row
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=4096,
    grad_accum=4,
    rope_theta=1e4,
    mlp_kind="geglu",
    sub_quadratic=True,
    source="arXiv:2402.19427; unverified",
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=5,  # 1 unit + (rglru, rglru) tail
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=512,
    block_pattern=("rglru", "rglru", "local"),
    window=32,
    lru_width=64,
    rope_theta=1e4,
    mlp_kind="geglu",
    sub_quadratic=True,
    attn_chunk=64,
    loss_chunk=64,
)
