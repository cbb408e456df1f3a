"""llama4-maverick-400b-a17b — MoE, 128 routed experts, top-1.

[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified tier]
Per the assignment row every layer is a routed-MoE layer with expert FFN
width d_ff=8192 and top-1 routing (the shared-expert/interleaved-dense
variations of the released checkpoints are out of the assigned geometry —
recorded in DESIGN.md §Arch-applicability notes).
"""

from .base import ArchConfig

FULL = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,  # per-expert hidden width
    vocab=202048,
    block_pattern=("attn", "moe"),  # interleaved dense:MoE 1:1 -> ~400B total
    n_experts=128,
    top_k=1,
    grad_accum=8,  # §Perf iter 2
    scan_unroll=2,
    param_dtype="bfloat16",  # f32 AdamW state cannot fit 395B on 256 chips
    rope_theta=5e5,
    mlp_kind="swiglu",
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family); unverified",
)

SMOKE = ArchConfig(
    name="llama4-maverick-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=512,
    block_pattern=("moe",),
    n_experts=8,
    top_k=1,
    rope_theta=1e4,
    attn_chunk=64,
    loss_chunk=64,
)
