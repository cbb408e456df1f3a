"""seamless-m4t-medium — encoder-decoder, multimodal.  [arXiv:2308.11596; hf]

Backbone only: the speech frontend is a stub — ``input_specs`` provides
precomputed frame embeddings (B, S/8, D) for the encoder (8× conv
subsampling), while the decoder consumes text tokens.  Decode shapes
exercise the decoder with the fixed encoder context.
"""

from .base import ArchConfig

FULL = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,  # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    enc_subsample=8,
    rope_theta=1e4,
    mlp_kind="gelu",  # vanilla transformer FFN
    source="arXiv:2308.11596",
)

SMOKE = ArchConfig(
    name="seamless-smoke",
    family="audio",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    enc_subsample=8,
    rope_theta=1e4,
    mlp_kind="gelu",
    attn_chunk=64,
    loss_chunk=64,
)
