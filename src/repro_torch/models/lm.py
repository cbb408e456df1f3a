"""Decoder-only LM — the serving subset of ``repro.models.lm`` on PyTorch.

The architecture is the reference's *layer pattern* (``ArchConfig``): a
repeat unit of block kinds, ``n_units`` times, plus a tail.  The reference
scans stacked unit parameters with ``lax.scan``; here the layers are one
``nn.ModuleList`` in the same order — unit 0's b0…bN, unit 1's, …, then the
tail — and prefill and decode loop over it.

Interface (the reference's, with the weights held by the module):
  DecoderLM(cfg, device=None, seed=0)         weights drawn from ``seed``
  prefill(batch, max_len) -> (logits, cache)  logits (B, V) float32
  decode_step(cache, tokens, pos) -> (logits, cache)  pos an int or a
                                                    0-d device tensor

Only the block kinds ``attn`` and ``local`` are ported (the dense families);
``moe``, ``ssd``, ``rglru``, M-RoPE, precomputed input embeddings and the
training loss raise ``NotImplementedError`` naming their ROADMAP item.
The default device is the card; without one the constructor raises unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device

from . import layers as L

ATTN_KINDS = ("attn", "local")
NOT_PORTED = {
    "moe": "8.3 (MoE)",
    "ssd": "8.4 (Mamba-2 SSD)",
    "rglru": "8.5 (RG-LRU)",
}
LOGIT_CHUNK = 32768  # vocab columns per float32 slice of lm_head in _logits


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item {item})")


def check_config(cfg: ArchConfig) -> None:
    """Raise for what the port's decoder cannot run yet."""
    if cfg.is_encdec:
        raise _not_ported("the encoder-decoder family", "8.7 (enc-dec)")
    for kind in set(cfg.block_pattern):
        if kind in NOT_PORTED:
            raise _not_ported(f"block kind {kind!r}", NOT_PORTED[kind])
        if kind not in ATTN_KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
    if cfg.mrope:
        raise _not_ported("M-RoPE", "8.6 (M-RoPE/VLM)")
    if not cfg.embed_inputs:
        raise _not_ported("precomputed input embeddings (embed_inputs=False)",
                          "8.6 (M-RoPE/VLM)")


def attn_specs(cfg: ArchConfig) -> dict[str, L.AttnSpec]:
    base = dict(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta, mrope=cfg.mrope,
    )
    return {"attn": L.AttnSpec(**base), "local": L.AttnSpec(**base, window=cfg.window)}


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Every layer's kind, in the reference's order: the units, then the tail."""
    return list(cfg.block_pattern) * cfg.n_units + list(cfg.tail_pattern)


class Block(nn.Module):
    """One pre-norm residual layer: ``ln1``, ``mixer`` (attention), ``ln2``,
    ``mlp`` — the reference's per-layer parameter tree."""

    def __init__(self, kind: str, cfg: ArchConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.kind = kind
        self.spec = attn_specs(cfg)[kind]
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.mixer = L.Attention(self.spec, dtype, device, chunk=cfg.attn_chunk)
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, device)


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None, seed: int | None = 0):
        """Weights are allocated on ``device`` (the card by default) in the
        compute dtype (norm scales in float32) and drawn from ``seed``;
        ``seed=None`` leaves them unset, for ``load_state_dict``."""
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        v, d = cfg.padded_vocab, cfg.d_model
        dt = dict(dtype=self.compute_dtype, device=self.device)
        self.token_embedding = L._weight(torch.empty((v, d), **dt))
        self.layers = nn.ModuleList(
            Block(kind, cfg, self.compute_dtype, self.device) for kind in layer_kinds(cfg))
        self.final_norm = L.RMSNorm(d, self.device)
        self.lm_head = L._weight(torch.empty((d, v), **dt))
        if seed is not None:
            self.init(seed)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, seed: int) -> "DecoderLM":
        """Draw every weight from a ``torch.Generator`` on the model's device
        seeded with ``seed``, one tensor at a time (no float32 copy of the
        whole model ever exists): the reference's scales, other numbers."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)

        def draw(w, scale):
            w.copy_(L.normal(gen, w.shape, scale, w.dtype, w.device))

        draw(self.token_embedding, 1.0)
        for layer in self.layers:
            layer.ln1.scale.zero_()
            layer.ln2.scale.zero_()
            L.init_attention(gen, layer.mixer)
            L.init_mlp(gen, layer.mlp)
        self.final_norm.scale.zero_()
        draw(self.lm_head, self.cfg.d_model**-0.5)
        return self

    def loss(self, batch: dict):
        raise _not_ported("the training loss", "8.9 (train/)")

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int) -> list[dict]:
        """One ``{"k", "v"}`` cache per layer, (B, KH, S, Dh) in the compute
        dtype: S = max_len, or the window for a ``local`` layer."""
        return [L.init_attention_cache(layer.spec, batch, max_len,
                                       self.compute_dtype, self.device)
                for layer in self.layers]

    def _embed(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return self.token_embedding[tokens]

    def _prefill_layer(self, layer: Block, h, positions, max_len: int):
        spec = layer.spec
        cache_len = min(max_len, spec.window) if spec.window else max_len
        hn = L.rms_norm(h, layer.ln1.scale)
        mix, cache = L.attention_prefill(layer.mixer, spec, hn, positions, cache_len)
        h = h + mix
        hn = L.rms_norm(h, layer.ln2.scale)
        return h + L.mlp(layer.mlp, hn, self.cfg.mlp_kind), cache

    def _decode_layer(self, layer: Block, h, cache: dict, pos: torch.Tensor):
        hn = L.rms_norm(h, layer.ln1.scale)
        mix, cache = L.attention_decode(layer.mixer, layer.spec, hn, cache, pos)
        h = h + mix
        hn = L.rms_norm(h, layer.ln2.scale)
        return h + L.mlp(layer.mlp, hn, self.cfg.mlp_kind), cache

    def _logits(self, h_last: torch.Tensor) -> torch.Tensor:
        """(B, S, D) -> (B, V) float32 logits of the last position: compute-
        dtype operands, float32 products and sums (the reference's
        ``preferred_element_type``), through float32 slices of ``lm_head``."""
        x = h_last[:, -1].float()
        v = self.lm_head.shape[1]
        out = torch.empty((x.shape[0], v), dtype=torch.float32, device=x.device)
        for v0 in range(0, v, LOGIT_CHUNK):
            out[:, v0:v0 + LOGIT_CHUNK] = x @ self.lm_head[:, v0:v0 + LOGIT_CHUNK].float()
        return out

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int) -> tuple[torch.Tensor, list[dict]]:
        """batch ``{"tokens": (B, S) ints}`` -> (next-token logits (B, V)
        float32, the per-layer caches laid out for ``decode_step``)."""
        x = self._embed(batch["tokens"])
        b, s = x.shape[:2]
        positions = torch.arange(s, device=self.device).expand(b, s)
        h, caches = x, []
        for layer in self.layers:
            h, c = self._prefill_layer(layer, h, positions, max_len)
            caches.append(c)
        h = L.rms_norm(h, self.final_norm.scale)
        return self._logits(h), caches

    @torch.no_grad()
    def decode_step(self, cache: list[dict], tokens, pos) -> tuple:
        """One decode step. tokens (B, 1) ints; pos the position, a 0-d
        integer tensor on the model's device (the reference's traced ``pos``)
        or an int; the caches are updated in place and returned.  Nothing in
        the step reads a device value back to the host, so
        ``serve.engine.make_decode_step`` can capture it in a CUDA graph."""
        h = self._embed(tokens)
        pos = torch.as_tensor(pos, device=self.device)
        new = []
        for layer, c in zip(self.layers, cache):
            h, c = self._decode_layer(layer, h, c, pos)
            new.append(c)
        h = L.rms_norm(h, self.final_norm.scale)
        return self._logits(h), new
