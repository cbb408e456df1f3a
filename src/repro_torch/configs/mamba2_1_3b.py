"""mamba2-1.3b — attention-free SSD (state-space duality).  [arXiv:2405.21060]

O(1)-state decode makes every decode shape (incl. long_500k) runnable.
n_heads/n_kv_heads are unused by the SSD mixer (kept for schema uniformity).
"""

from .base import ArchConfig

FULL = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=0,  # attention-free: SSD blocks only, no FFN
    vocab=50280,
    block_pattern=("ssd",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    grad_accum=4,  # §Perf: SSD chunk tensors scale with microbatch; 19->~10 GiB
    sub_quadratic=True,
    source="arXiv:2405.21060; unverified",
)

SMOKE = ArchConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=512,
    block_pattern=("ssd",),
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=32,
    sub_quadratic=True,
    attn_chunk=64,
    loss_chunk=64,
)
