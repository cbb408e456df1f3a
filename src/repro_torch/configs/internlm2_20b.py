"""internlm2-20b — dense GQA transformer.  [arXiv:2403.17297; hf]"""

from .base import ArchConfig

FULL = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92544,
    grad_accum=8,
    scan_unroll=2,
    rope_theta=1e6,
    mlp_kind="swiglu",
    source="arXiv:2403.17297",
)

SMOKE = ArchConfig(
    name="internlm2-20b-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=3,
    head_dim=16,
    d_ff=192,
    vocab=512,
    rope_theta=1e4,
    attn_chunk=64,
    loss_chunk=64,
)
