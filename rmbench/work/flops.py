"""Model operations of a dense decoder's train step (``6 · N · tokens`` over
the matmul weights, plus attention), for a step's share of the card's peak.
The configuration is read by its fields: ``n_layers``, ``d_model``,
``n_heads``, ``n_kv_heads``, ``head_dim``, ``d_ff``, ``vocab`` (padded),
``qk_norm`` — every layer an attending SwiGLU layer with an untied head."""

from __future__ import annotations


def param_count(n_layers: int, d_model: int, n_heads: int, n_kv_heads: int,
                head_dim: int, d_ff: int, vocab: int, qk_norm: bool) -> int:
    """Every weight: per layer the four attention products, the QK-norm
    scales, the three SwiGLU products and two norm scales; the token
    embedding, the untied head and the final norm."""
    d, hd = d_model, head_dim
    attn = d * hd * (n_heads + 2 * n_kv_heads) + n_heads * hd * d
    if qk_norm:
        attn += 2 * hd
    mlp = 3 * d * d_ff
    return n_layers * (attn + mlp + 2 * d) + 2 * vocab * d + d


def causal_pairs(seq: int) -> int:
    """Unmasked (query, key) pairs of one causal head."""
    return seq * (seq + 1) // 2


def train_step_flops(n_layers: int, d_model: int, n_heads: int, n_kv_heads: int,
                     head_dim: int, d_ff: int, vocab: int, qk_norm: bool,
                     tokens: int, seq: int) -> int:
    """6 × the matmul weights (all but the embedding, a gather) × tokens,
    plus attention: 3 × 4·H·D a causal pair an attending layer (the forward,
    and twice that backward)."""
    matmul = param_count(n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff,
                         vocab, qk_norm) - vocab * d_model
    pairs = causal_pairs(seq) * (tokens // seq)
    return 6 * matmul * tokens + 3 * 4 * n_heads * head_dim * pairs * n_layers
