"""qwen2-vl-72b — VLM backbone with M-RoPE.  [arXiv:2409.12191; hf]

Backbone only, per the assignment: the vision frontend is a stub —
``input_specs`` provides precomputed patch embeddings (B, S, D) plus the
3-component M-RoPE position ids (B, 3, S).
"""

from .base import ArchConfig

FULL = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,  # qwen2 family keeps QKV bias
    mrope=True,
    embed_inputs=False,  # frontend stub: embeddings arrive precomputed
    grad_accum=16,
    scan_unroll=2,
    rope_theta=1e6,
    mlp_kind="swiglu",
    source="arXiv:2409.12191",
)

SMOKE = ArchConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab=512,
    qkv_bias=True,
    mrope=True,
    embed_inputs=False,
    rope_theta=1e4,
    attn_chunk=64,
    loss_chunk=64,
)
