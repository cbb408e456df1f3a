"""gemma3-27b — dense GQA with 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt family; unverified tier]  The 5-local:1-global
pattern makes only ~1/6 of layers hold full-length KV, so the config is
``sub_quadratic``-eligible for long_500k: global-layer KV is sequence-sharded
(decode-SP) while local layers keep a 1024-slot ring buffer.
"""

from .base import ArchConfig

FULL = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,  # gemma3 uses an explicit head_dim (not d_model/heads)
    d_ff=21504,
    vocab=262144,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    grad_accum=8,
    qk_norm=True,  # gemma3 applies RMS-norm to q and k
    rope_theta=1e6,
    mlp_kind="geglu",
    sub_quadratic=True,
    source="hf:google/gemma-3-1b-pt (family); unverified",
    notes="62 = 10×(5L+1G) + 2L tail; local window 1024",
)

SMOKE = ArchConfig(
    name="gemma3-27b-smoke",
    family="dense",
    n_layers=8,  # 1 full unit + 2-layer tail exercises the tail path
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab=512,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window=32,
    qk_norm=True,
    rope_theta=1e4,
    mlp_kind="geglu",
    sub_quadratic=True,
    attn_chunk=64,
    loss_chunk=64,
)
