"""Encoder-decoder family (seamless-m4t) — ``repro.models.encdec`` on PyTorch.

The encoder consumes precomputed frame embeddings (B, S_enc, D) — the conv
subsampling frontend is a stub, as in the reference — through bidirectional
self-attention layers (on the card the flash kernel with ``causal=False``).
The decoder is a causal LM whose layers add cross-attention over the
encoder output; the cross K/V is computed once at prefill and read by every
decode step.  Cross-attention is the reference's float32 einsums, with no
RoPE, on every device.

Interface (``DecoderLM``'s; the batch adds ``enc_embeds``):
  EncDecLM(cfg, device=None, seed=0, param_dtype=None)
  loss(params, {"enc_embeds", "tokens", "labels"}) -> (loss, metrics)
  prefill({"enc_embeds": (B, S_enc, D), "tokens": (B, S)}, max_len)
      -> (logits (B, V) float32, caches)
  decode_step(caches, tokens (B, 1), pos) -> (logits, caches)

The parameters carry the reference's names: ``token_embedding``,
``enc_layers.{i}`` (``ln1``, ``mixer``, ``ln2``, ``mlp``; the reference's
stacked ``enc_units``), ``layers.{i}`` (``ln1``, ``mixer``, ``ln_x``,
``cross``, ``ln2``, ``mlp``; its ``units``), ``enc_norm``, ``final_norm``
and ``lm_head``.  Each decoder layer's cache is one flat dict, ``{"k",
"v", "cross_k", "cross_v"}`` (the reference nests the first two under
``"self"``): a decode step writes its token into ``k`` and ``v`` in place
and only reads the cross K/V.

The loss is the reference's: each encoder and each decoder layer is
recomputed in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` over its layer scans), the weights (master weights in
``param_dtype`` for training) cast at each product, and the decoder's cross
entropy is ``lm.chunked_xent``; its ``aux`` is 0.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_model_device

from . import layers as L
from .lm import chunked_xent, head_logits, run_layer


def attn_specs(cfg: ArchConfig) -> tuple[L.AttnSpec, L.AttnSpec, L.AttnSpec]:
    """The encoder's (bidirectional), the decoder's self- and its
    cross-attention specs: no QKV bias, qk-norm or M-RoPE."""
    base = dict(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)
    return L.AttnSpec(**base, causal=False), L.AttnSpec(**base), L.AttnSpec(**base)


def _cross_kv(params: L.Attention, spec: L.AttnSpec, enc_out: torch.Tensor):
    """Project the encoder output to (B, K, S_enc, Dh) cross K/V (no rope)."""
    b, s, _ = enc_out.shape
    k, v = L.linear_group(enc_out, [params.wk, params.wv])
    shape = (b, s, spec.n_kv_heads, spec.head_dim)
    return (k.reshape(shape).transpose(1, 2).contiguous(),
            v.reshape(shape).transpose(1, 2).contiguous())


def _cross_attend(params: L.Attention, spec: L.AttnSpec, x: torch.Tensor, ck, cv):
    """q from decoder states x (B, S, D); K/V (B, K, S_enc, Dh) precomputed.
    q is scaled in the compute dtype; logits, softmax and the PV product run
    in float32."""
    b, s, _ = x.shape
    q = L.linear(x, params.wq).reshape(b, s, spec.n_heads, spec.head_dim)
    kh = spec.n_kv_heads
    g = spec.n_heads // kh
    qh = (q * spec.scale).reshape(b, s, kh, g, spec.head_dim).float()
    logits = torch.einsum("bskgd,bkcd->bskgc", qh, ck.float())
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bskgc,bkcd->bskgd", w, cv.float())
    out = out.reshape(b, s, spec.n_heads * spec.head_dim).to(x.dtype)
    return L.linear(out, params.wo)


class EncoderLayer(nn.Module):
    """``ln1``, ``mixer`` (bidirectional self-attention), ``ln2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, spec: L.AttnSpec, dtype: torch.dtype, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.mixer = L.Attention(spec, dtype, device, chunk=cfg.attn_chunk)
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, device)
        self.mlp_kind = cfg.mlp_kind

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """The layer's training forward: bidirectional self-attention, FFN."""
        h = h + L.attention_forward(self.mixer, self.mixer.attend.spec,
                                    L.rms_norm(h, self.ln1.scale), positions)
        return h + L.mlp(self.mlp, L.rms_norm(h, self.ln2.scale), self.mlp_kind)


class DecoderLayer(nn.Module):
    """``ln1``, ``mixer`` (causal self-attention), ``ln_x``, ``cross``
    (cross-attention: ``wq``, ``wk``, ``wv``, ``wo``), ``ln2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, spec: L.AttnSpec, cross_spec: L.AttnSpec,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.mixer = L.Attention(spec, dtype, device, chunk=cfg.attn_chunk)
        self.ln_x = L.RMSNorm(cfg.d_model, device)
        self.cross = L.Attention(cross_spec, dtype, device, chunk=cfg.attn_chunk)
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, device)
        self.mlp_kind = cfg.mlp_kind

    def forward(self, h: torch.Tensor, positions: torch.Tensor,
                enc_out: torch.Tensor) -> torch.Tensor:
        """The layer's training forward (the reference's ``_dec_layer_train``):
        causal self-attention, cross-attention over ``enc_out``, FFN."""
        h = h + L.attention_forward(self.mixer, self.mixer.attend.spec,
                                    L.rms_norm(h, self.ln1.scale), positions)
        spec = self.cross.attend.spec
        ck, cv = _cross_kv(self.cross, spec, enc_out)
        h = h + _cross_attend(self.cross, spec, L.rms_norm(h, self.ln_x.scale), ck, cv)
        return h + L.mlp(self.mlp, L.rms_norm(h, self.ln2.scale), self.mlp_kind)


class EncDecLM(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None, seed: int | None = 0,
                 param_dtype: str | None = None):
        """Weights on ``device`` (the card by default) in the compute dtype
        (norm scales float32), drawn from ``seed``; ``seed=None`` leaves
        them unset, for ``load_state_dict``; ``param_dtype`` (training:
        ``cfg.param_dtype``) holds them in that dtype instead."""
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError("EncDecLM needs n_enc_layers > 0")
        self.cfg = cfg
        self.device = resolve_model_device(device)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.enc_spec, self.dec_spec, self.cross_spec = attn_specs(cfg)
        v, d = cfg.padded_vocab, cfg.d_model
        dt = getattr(torch, param_dtype) if param_dtype else self.compute_dtype
        dev = self.device
        self.token_embedding = L._weight(torch.empty((v, d), dtype=dt, device=dev))
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, self.enc_spec, dt, dev) for _ in range(cfg.n_enc_layers))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, self.dec_spec, self.cross_spec, dt, dev)
            for _ in range(cfg.n_layers))
        self.enc_norm = L.RMSNorm(d, dev)
        self.final_norm = L.RMSNorm(d, dev)
        self.lm_head = L._weight(torch.empty((d, v), dtype=dt, device=dev))
        if seed is not None:
            self.init(seed)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, seed: int) -> "EncDecLM":
        """Draw every weight from a ``torch.Generator`` on the model's
        device seeded with ``seed``, at the reference's scales (other random
        numbers); norm scales zero."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.token_embedding.copy_(L.normal(gen, self.token_embedding.shape, 1.0,
                                            self.compute_dtype, self.device))
        for layer in [*self.enc_layers, *self.layers]:
            for module in layer.children():
                if isinstance(module, L.RMSNorm):
                    module.scale.zero_()
                elif isinstance(module, L.Attention):
                    L.init_attention(gen, module)
                else:
                    L.init_mlp(gen, module)
        self.enc_norm.scale.zero_()
        self.final_norm.scale.zero_()
        self.lm_head.copy_(L.normal(gen, self.lm_head.shape, self.cfg.d_model**-0.5,
                                    self.compute_dtype, self.device))
        return self

    def loss(self, params: dict, batch: dict):
        """The train forward: ``(nll, {"nll", "aux": 0})`` over
        ``batch["labels"]``; ``params`` as in ``DecoderLM.loss``."""
        dt, dev = self.compute_dtype, self.device
        h = torch.as_tensor(batch["enc_embeds"], device=dev).to(dt)
        b, s = h.shape[:2]
        positions = torch.arange(s, device=dev).expand(b, s)
        for i in range(len(self.enc_layers)):
            h = checkpoint(run_layer, self, f"enc_layers.{i}", params, h, positions,
                           use_reentrant=False, preserve_rng_state=False)
        enc_out = L.rms_norm(h, params["enc_norm.scale"])
        h = self._inputs(batch["tokens"], params["token_embedding"])
        b, s = h.shape[:2]
        positions = torch.arange(s, device=dev).expand(b, s)
        for i in range(len(self.layers)):
            h = checkpoint(run_layer, self, f"layers.{i}", params, h, positions, enc_out,
                           use_reentrant=False, preserve_rng_state=False)
        h = L.rms_norm(h, params["final_norm.scale"])
        labels = torch.as_tensor(batch["labels"], device=dev)
        nll = chunked_xent(params["lm_head"], h, labels, self.cfg.loss_chunk)
        return nll, {"nll": nll, "aux": torch.zeros((), dtype=torch.float32, device=dev)}

    # --------------------------------------------------------------- encoder
    @torch.no_grad()
    def encode(self, enc_embeds) -> torch.Tensor:
        """(B, S_enc, D) frame embeddings -> the normed encoder output, in
        the compute dtype."""
        h = torch.as_tensor(enc_embeds, device=self.device).to(self.compute_dtype)
        b, s, _ = h.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        for layer in self.enc_layers:
            h = h + L.attention_forward(layer.mixer, self.enc_spec,
                                        L.rms_norm(h, layer.ln1.scale), positions)
            h = h + L.mlp(layer.mlp, L.rms_norm(h, layer.ln2.scale), self.cfg.mlp_kind)
        return L.rms_norm(h, self.enc_norm.scale)

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int) -> list[dict]:
        """One flat dict a decoder layer: ``k``, ``v`` (B, KH, max_len, Dh)
        and ``cross_k``, ``cross_v`` (B, KH, max(max_len // enc_subsample,
        1), Dh), zeros in the compute dtype."""
        spec, dt, dev = self.dec_spec, self.compute_dtype, self.device
        s_enc = max(max_len // self.cfg.enc_subsample, 1)
        cross = (batch, self.cross_spec.n_kv_heads, s_enc, self.cross_spec.head_dim)
        return [{**L.init_attention_cache(spec, batch, max_len, dt, dev),
                 "cross_k": torch.zeros(cross, dtype=dt, device=dev),
                 "cross_v": torch.zeros(cross, dtype=dt, device=dev)}
                for _ in self.layers]

    def _inputs(self, tokens, table: torch.Tensor | None = None) -> torch.Tensor:
        """The rows of ``tokens`` in ``table`` (the token embedding by
        default), in the compute dtype."""
        table = self.token_embedding if table is None else table
        return table[torch.as_tensor(tokens, device=self.device).long()].to(self.compute_dtype)

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int) -> tuple[torch.Tensor, list[dict]]:
        """Encode ``enc_embeds``, then run the decoder over ``tokens``;
        returns the next-token logits and each layer's self-KV (``max_len``
        positions) and cross-KV (the encoder's ``S_enc``) caches."""
        enc_out = self.encode(batch["enc_embeds"])
        h = self._inputs(batch["tokens"])
        b, s = h.shape[:2]
        positions = torch.arange(s, device=self.device).expand(b, s)
        caches = []
        for layer in self.layers:
            mix, cache = L.attention_prefill(layer.mixer, self.dec_spec,
                                             L.rms_norm(h, layer.ln1.scale), positions, max_len)
            h = h + mix
            ck, cv = _cross_kv(layer.cross, self.cross_spec, enc_out)
            h = h + _cross_attend(layer.cross, self.cross_spec,
                                  L.rms_norm(h, layer.ln_x.scale), ck, cv)
            h = h + L.mlp(layer.mlp, L.rms_norm(h, layer.ln2.scale), self.cfg.mlp_kind)
            caches.append({**cache, "cross_k": ck, "cross_v": cv})
        h = L.rms_norm(h, self.final_norm.scale)
        return head_logits(self.lm_head, h), caches

    @torch.no_grad()
    def decode_step(self, cache: list[dict], tokens, pos) -> tuple:
        """One decode step over every layer's cache: the token's K/V written
        into ``k`` / ``v`` at ``pos`` in place, the cross K/V read.  ``pos``
        is an int or a 0-d integer tensor on the model's device; nothing
        reads a device value back to the host (a CUDA graph replays it)."""
        h = self._inputs(tokens)
        pos = torch.as_tensor(pos, device=self.device)
        for layer, c in zip(self.layers, cache):
            mix, _ = L.attention_decode(layer.mixer, self.dec_spec,
                                        L.rms_norm(h, layer.ln1.scale), c, pos)
            h = h + mix
            h = h + _cross_attend(layer.cross, self.cross_spec,
                                  L.rms_norm(h, layer.ln_x.scale), c["cross_k"], c["cross_v"])
            h = h + L.mlp(layer.mlp, L.rms_norm(h, layer.ln2.scale), self.cfg.mlp_kind)
        h = L.rms_norm(h, self.final_norm.scale)
        return head_logits(self.lm_head, h), cache
