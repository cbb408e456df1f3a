"""Decoder-only LM — ``repro.models.lm`` on PyTorch: serving and training.

The architecture is the reference's *layer pattern* (``ArchConfig``): a
repeat unit of block kinds, ``n_units`` times, plus a tail.  The reference
scans stacked unit parameters with ``lax.scan``; here the layers are one
``nn.ModuleList`` in the same order — unit 0's b0…bN, unit 1's, …, then the
tail — and prefill and decode loop over it.

Interface (the reference's, with the weights held by the module):
  DecoderLM(cfg, device=None, seed=0, param_dtype=None)
                                              weights drawn from ``seed``
  loss(params, batch) -> (loss, metrics)     the train forward
  prefill(batch, max_len) -> (logits, cache)  logits (B, V) float32
  decode_step(cache, tokens, pos) -> (logits, cache)  pos an int or a
                                                    0-d device tensor
The batch is ``{"tokens": (B, S)}``, or for a config with
``embed_inputs=False`` (the VLM backbone, whose vision frontend is a stub)
``{"embeds": (B, S, D)}`` with M-RoPE ``"positions"`` (B, 3, S); such a
model has no ``token_embedding``, and its decode step takes (B, 1, D)
embeddings in place of tokens.

Every block kind of the reference is ported: ``attn``, ``local`` (the
dense families), ``moe`` (global attention with the MoE block in place of
the FFN), ``ssd`` (the Mamba-2 mixer, no FFN) and ``rglru`` (the Griffin
recurrent mixer and an FFN).  An attention layer's cache is its KV cache; a
recurrent layer's is its state (``conv`` and ``ssm`` or ``h``), written in
place by a decode step as the KV caches are.  Attention takes M-RoPE
(``cfg.mrope``).  The encoder-decoder family is ``encdec.EncDecLM``.
The default device is the card; without one the constructor raises unless
the caller passes ``device="cpu"`` (or ``"meta"``, the dry run: nothing is
allocated or computed).

Training holds master weights in ``cfg.param_dtype`` (``param_dtype=
cfg.param_dtype`` at construction; serving keeps compute-dtype weights) and
:meth:`DecoderLM.loss` casts them at use, as the reference's ``cast_f``:
each checkpointed group of ``scan_unroll`` units casts its own weights to
the compute dtype inside ``torch.utils.checkpoint`` (so no compute-dtype
copy of the whole model exists, and the backward recomputes the group, as
``jax.checkpoint(chunk_fn)`` does), the tail layers cast per product, and
the cross entropy runs over ``loss_chunk`` positions at a time on float32
logits (:func:`chunked_xent`), never all ``(B, S, V)`` at once.
``params`` (names as in ``state_dict``) stands in for the module's own
weights for the call, as the reference's ``loss(params, batch)``, so a
train step runs the loss on the tensors of its state.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_model_device

from . import layers as L

ATTN_KINDS = ("attn", "local", "moe")
KINDS = ATTN_KINDS + ("ssd", "rglru")
LOGIT_CHUNK = 32768  # vocab columns per float32 slice of lm_head in _logits


def check_config(cfg: ArchConfig) -> None:
    """Raise for a block kind the port does not know, or an MoE layer
    without experts."""
    for kind in set(cfg.block_pattern):
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
        if kind == "moe" and not (cfg.n_experts > 0 and 0 < cfg.top_k <= cfg.n_experts):
            raise ValueError(f"a moe layer needs 0 < top_k <= n_experts, got top_k "
                             f"{cfg.top_k} of {cfg.n_experts} experts")


def attn_specs(cfg: ArchConfig) -> dict[str, L.AttnSpec]:
    base = dict(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta, mrope=cfg.mrope,
    )
    return {"attn": L.AttnSpec(**base), "local": L.AttnSpec(**base, window=cfg.window),
            "moe": L.AttnSpec(**base)}


def moe_spec(cfg: ArchConfig) -> L.MoESpec:
    return L.MoESpec(d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
                     top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)


def ssd_spec(cfg: ArchConfig) -> L.SSDSpec:
    return L.SSDSpec(d_model=cfg.d_model, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                     expand=cfg.ssm_expand, conv_width=4, chunk=cfg.ssm_chunk)


def rglru_spec(cfg: ArchConfig) -> L.RGLRUSpec:
    return L.RGLRUSpec(d_model=cfg.d_model, lru_width=cfg.lru_width or cfg.d_model)


def head_logits(lm_head: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, V) float32 logits of the last position: compute-
    dtype operands, float32 products and sums (the reference's
    ``preferred_element_type``), through float32 slices of ``lm_head``."""
    x = h[:, -1].float()
    v = lm_head.shape[1]
    out = torch.empty((x.shape[0], v), dtype=torch.float32, device=x.device)
    for v0 in range(0, v, LOGIT_CHUNK):
        out[:, v0:v0 + LOGIT_CHUNK] = x @ lm_head[:, v0:v0 + LOGIT_CHUNK].float()
    return out


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Every layer's kind, in the reference's order: the units, then the tail."""
    return list(cfg.block_pattern) * cfg.n_units + list(cfg.tail_pattern)


def checkpoint_groups(cfg: ArchConfig) -> list[range]:
    """The layers the loss recomputes together in the backward: ``scan_unroll``
    units a group where that divides ``n_units``, else one unit — the
    reference's ``jax.checkpoint`` over its scan step.  The tail's layers
    follow, unchecked (the reference unrolls the tail outside its scan)."""
    width = len(cfg.block_pattern)
    u = max(cfg.scan_unroll, 1)
    per = (u if u > 1 and cfg.n_units % u == 0 else 1) * width
    return [range(lo, lo + per) for lo in range(0, cfg.n_units * width, per)]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) with float32 products, sums and result from operands
    in the compute dtype — the reference's ``preferred_element_type=
    float32``.  bf16 operands on the card go to cuBLAS with a float32
    output (``torch.mm(..., out_dtype=float32)``, also on ``meta``); on the
    CPU they are widened first (exact)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type in L.KERNEL_DEVICES:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class ChunkXent(torch.autograd.Function):
    """``sum(logsumexp(h @ w) - (h @ w)[label])`` over the rows of one loss
    chunk: ``h (N, D)`` and ``w (D, V)`` in the compute dtype, float32
    logits (:func:`matmul_f32`).  The forward keeps the float32 logits for
    the backward, which turns them in place into ``softmax - onehot`` and
    multiplies that, in the compute dtype, into ``dh`` and ``dw``."""

    @staticmethod
    def forward(ctx, h, w, labels):
        logits = matmul_f32(h, w)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(1, labels[:, None])[:, 0]
        ctx.save_for_backward(h, w, labels, logits, lse)
        return (lse - gold).sum()

    @staticmethod
    def backward(ctx, g):
        h, w, labels, logits, lse = ctx.saved_tensors
        p = logits.sub_(lse[:, None]).exp_()  # softmax, in the logits' buffer
        p[torch.arange(p.shape[0], device=p.device), labels] -= 1.0
        p = p.mul_(g).to(h.dtype)
        return p @ w.t(), h.t() @ p, None


def chunked_xent(lm_head: torch.Tensor, h: torch.Tensor, labels: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Mean cross entropy of ``h (B, S, D)`` against ``labels (B, S)``,
    ``chunk`` positions of every row at a time (the reference's
    ``_chunked_xent``: per step only ``(B, chunk, V)`` float32 logits);
    ``lm_head`` is cast to ``h``'s dtype once."""
    b, s, d = h.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence length {s} is not a multiple of loss_chunk {c}")
    w = lm_head.to(h.dtype)
    labels = labels.long()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, c):
        hc = h[:, c0:c0 + c].reshape(b * c, d)
        total = total + ChunkXent.apply(hc, w, labels[:, c0:c0 + c].reshape(b * c))
    return total / (b * s)


def _cast_floats(params: dict, dtype: torch.dtype) -> dict:
    """The reference's ``cast_f``: every floating weight in ``dtype``."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}


class Block(nn.Module):
    """One pre-norm residual layer: ``ln1``, ``mixer`` (attention, the SSD
    or the RG-LRU mixer by kind), then ``ln2`` and ``mlp`` or, for a ``moe``
    layer, ``moe`` — the reference's per-layer parameter tree.  An ``ssd``
    layer has no ``ln2`` and no FFN."""

    def __init__(self, kind: str, cfg: ArchConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.kind = kind
        self.mlp_kind = cfg.mlp_kind
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        if kind == "ssd":
            self.spec = ssd_spec(cfg)
            self.mixer = L.SSD(self.spec, dtype, device)
            return  # no ln2 and no FFN
        if kind == "rglru":
            self.spec = rglru_spec(cfg)
            self.mixer = L.RGLRU(self.spec, dtype, device)
        else:
            self.spec = attn_specs(cfg)[kind]
            self.mixer = L.Attention(self.spec, dtype, device, chunk=cfg.attn_chunk)
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        if kind == "moe":
            self.moe_spec = moe_spec(cfg)
            self.moe = L.MoE(self.moe_spec, dtype, device)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, device)

    def cache(self, batch: int, max_len: int, dtype: torch.dtype, device) -> dict:
        """This layer's empty decode cache: the KV cache (compute dtype) of
        an attention layer, the reference's zero state of a recurrent one."""
        if self.kind == "ssd":
            return L.init_ssd_state(self.spec, batch, device)
        if self.kind == "rglru":
            return L.init_rglru_state(self.spec, batch, device)
        return L.init_attention_cache(self.spec, batch, max_len, dtype, device)

    def mix_prefill(self, hn, positions, max_len: int):
        """The mixer over the prompt: (its output, this layer's cache)."""
        if self.kind == "ssd":
            return L.ssd_block(self.mixer, self.spec, hn, return_state=True)
        if self.kind == "rglru":
            return L.rglru_block(self.mixer, self.spec, hn, return_state=True)
        window = self.spec.window
        cache_len = min(max_len, window) if window else max_len
        return L.attention_prefill(self.mixer, self.spec, hn, positions, cache_len)

    def mix_decode(self, hn, cache: dict, pos):
        """The mixer's decode step; the cache is updated in place."""
        if self.kind == "ssd":
            return L.ssd_decode(self.mixer, self.spec, hn, cache)
        if self.kind == "rglru":
            return L.rglru_decode(self.mixer, self.spec, hn, cache)
        return L.attention_decode(self.mixer, self.spec, hn, cache, pos)

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        """The layer's FFN on the normed residual: the MoE block or the MLP."""
        if self.kind == "moe":
            return L.moe_block(self.moe, self.moe_spec, x)
        return L.mlp(self.mlp, x, self.mlp_kind)

    def forward(self, h: torch.Tensor, positions: torch.Tensor):
        """The training forward of the layer (the reference's
        ``_apply_layer``): ``(h, aux)``, ``aux`` the MoE block's float32
        load-balancing loss (0 for other kinds)."""
        hn = L.rms_norm(h, self.ln1.scale)
        if self.kind == "ssd":
            mix = L.ssd_block(self.mixer, self.spec, hn)
        elif self.kind == "rglru":
            mix = L.rglru_block(self.mixer, self.spec, hn)
        else:
            mix = L.attention_forward(self.mixer, self.spec, hn, positions)
        h = h + mix
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if self.kind != "ssd":
            hn = L.rms_norm(h, self.ln2.scale)
            h = h + self.ffn(hn)
            if self.kind == "moe":
                aux = L.moe_aux_loss(self.moe, self.moe_spec, hn)
        return h, aux


def _local_params(params: dict, prefix: str) -> dict:
    """``params``' entries under ``prefix.``, named as inside that module."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def run_layer(model: nn.Module, name: str, params: dict, *args):
    """The submodule ``name`` (a dotted name) of ``model`` forward on
    ``args``, its weights taken from ``params``."""
    return functional_call(model.get_submodule(name), _local_params(params, name),
                           args, strict=True)


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None, seed: int | None = 0,
                 param_dtype: str | None = None):
        """Weights are allocated on ``device`` (the card by default) in the
        compute dtype (norm scales in float32) and drawn from ``seed``;
        ``seed=None`` leaves them unset, for ``load_state_dict``.  A config
        with ``embed_inputs=False`` has no ``token_embedding``.
        ``param_dtype`` (training: ``cfg.param_dtype``) holds the weights in
        that dtype instead — master weights the loss casts at use."""
        super().__init__()
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name} is an encoder-decoder (n_enc_layers > 0): "
                             "build it with build_model, which gives an EncDecLM")
        check_config(cfg)
        self.cfg = cfg
        self.device = resolve_model_device(device)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        weight_dtype = getattr(torch, param_dtype) if param_dtype else self.compute_dtype
        v, d = cfg.padded_vocab, cfg.d_model
        dt = dict(dtype=weight_dtype, device=self.device)
        if cfg.embed_inputs:
            self.token_embedding = L._weight(torch.empty((v, d), **dt))
        self.layers = nn.ModuleList(
            Block(kind, cfg, weight_dtype, self.device) for kind in layer_kinds(cfg))
        self.final_norm = L.RMSNorm(d, self.device)
        self.lm_head = L._weight(torch.empty((d, v), **dt))
        if seed is not None:
            self.init(seed)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, seed: int) -> "DecoderLM":
        """Draw every weight from a ``torch.Generator`` on the model's device
        seeded with ``seed``, one tensor at a time (no float32 copy of the
        whole model ever exists): the reference's scales and constants,
        other random numbers."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)

        def draw(w, scale):
            w.copy_(L.normal(gen, w.shape, scale, w.dtype, w.device))

        if self.cfg.embed_inputs:
            draw(self.token_embedding, 1.0)
        for layer in self.layers:
            layer.ln1.scale.zero_()
            if layer.kind == "ssd":
                L.init_ssd(gen, layer.mixer)
                continue
            if layer.kind == "rglru":
                L.init_rglru(gen, layer.mixer, layer.spec.c)
            else:
                L.init_attention(gen, layer.mixer)
            layer.ln2.scale.zero_()
            if layer.kind == "moe":
                L.init_moe(gen, layer.moe)
            else:
                L.init_mlp(gen, layer.mlp)
        self.final_norm.scale.zero_()
        draw(self.lm_head, self.cfg.d_model**-0.5)
        return self

    # -------------------------------------------------------------- training
    def loss(self, params: dict, batch: dict):
        """The train forward: ``(loss, {"nll", "aux"})``, ``loss = nll +
        1e-2 * aux`` (float32 0-d tensors), ``nll`` the mean cross entropy of
        ``batch["labels"]`` and ``aux`` the MoE layers' summed load-balancing
        loss.  ``params`` maps ``state_dict`` names to the weights to use
        (the master weights of a train state)."""
        cfg = self.cfg
        h, positions = self._embed(batch, params.get("token_embedding"))
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for group in checkpoint_groups(cfg):
            h, a = checkpoint(self._run_group, group, h, positions, params,
                              use_reentrant=False, preserve_rng_state=False)
            aux = aux + a
        for i in range(cfg.n_units * len(cfg.block_pattern), len(self.layers)):  # the tail
            h, a = run_layer(self, f"layers.{i}", params, h, positions)
            aux = aux + a
        h = L.rms_norm(h, params["final_norm.scale"])
        labels = torch.as_tensor(batch["labels"], device=self.device)
        nll = chunked_xent(params["lm_head"], h, labels, cfg.loss_chunk)
        return nll + 1e-2 * aux, {"nll": nll, "aux": aux}

    def _run_group(self, group: range, h, positions, params: dict):
        """One checkpointed group of unit layers, their weights cast to the
        compute dtype inside it (so the backward casts them again)."""
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in group:
            local = _cast_floats(_local_params(params, f"layers.{i}"), self.compute_dtype)
            h, a = functional_call(self.layers[i], local, (h, positions), strict=True)
            aux = aux + a
        return h, aux

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int) -> list[dict]:
        """One cache per layer, of the layer's kind: ``{"k", "v"}`` (B, KH, S,
        Dh) in the compute dtype for attention (S = max_len, or the window
        for a ``local`` layer); the reference's zero state for a recurrent
        layer, ``{"conv", "ssm"}`` (``ssd``) or ``{"conv", "h"}``
        (``rglru``), its ``conv`` bf16 at every compute dtype.  At float32
        compute a decode step refuses such a ``conv`` (it cannot widen it in
        place); a prefill's cache holds it in the compute dtype."""
        return [layer.cache(batch, max_len, self.compute_dtype, self.device)
                for layer in self.layers]

    def _inputs(self, tokens, table: torch.Tensor | None = None) -> torch.Tensor:
        """A decode step's or a prompt's inputs in the compute dtype: the
        rows of ``tokens`` in ``table`` (the token embedding by default), or,
        without a token embedding, the embeddings themselves."""
        if self.cfg.embed_inputs:
            tokens = torch.as_tensor(tokens, device=self.device).long()
            table = self.token_embedding if table is None else table
            return table[tokens].to(self.compute_dtype)
        return torch.as_tensor(tokens, device=self.device).to(self.compute_dtype)

    def _embed(self, batch: dict, table: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """The prompt's inputs (``table`` as in :meth:`_inputs`) and RoPE
        positions: ``arange(S)`` for every row, or for M-RoPE the batch's
        ``positions`` (B, 3, S) — where it has none, ``arange(S)`` in all
        three components."""
        x = self._inputs(batch["tokens"] if self.cfg.embed_inputs else batch["embeds"], table)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=self.device).expand(b, s)
        if self.cfg.mrope:
            given = batch.get("positions")
            positions = (positions[:, None, :].expand(b, 3, s) if given is None
                         else torch.as_tensor(given, device=self.device))
        return x, positions

    def _prefill_layer(self, layer: Block, h, positions, max_len: int):
        mix, cache = layer.mix_prefill(L.rms_norm(h, layer.ln1.scale), positions, max_len)
        h = h + mix
        if layer.kind != "ssd":
            h = h + layer.ffn(L.rms_norm(h, layer.ln2.scale))
        return h, cache

    def _decode_layer(self, layer: Block, h, cache: dict, pos: torch.Tensor):
        mix, cache = layer.mix_decode(L.rms_norm(h, layer.ln1.scale), cache, pos)
        h = h + mix
        if layer.kind != "ssd":
            h = h + layer.ffn(L.rms_norm(h, layer.ln2.scale))
        return h, cache

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int) -> tuple[torch.Tensor, list[dict]]:
        """batch ``{"tokens": (B, S) ints}`` (or ``{"embeds": (B, S, D),
        "positions": (B, 3, S)}``, see the module's docstring) -> (next-token
        logits (B, V) float32, the per-layer caches laid out for
        ``decode_step``).  Each layer's activations are released before the
        next layer runs (an SSD layer's chunk mask is about 1 GB at
        mamba2-1.3b's width and 8 × 2,048 tokens)."""
        h, positions = self._embed(batch)
        caches = []
        for layer in self.layers:
            h, c = self._prefill_layer(layer, h, positions, max_len)
            caches.append(c)
        h = L.rms_norm(h, self.final_norm.scale)
        return head_logits(self.lm_head, h), caches

    @torch.no_grad()
    def decode_step(self, cache: list[dict], tokens, pos) -> tuple:
        """One decode step. tokens (B, 1) ints (embeddings (B, 1, D) for a
        config with ``embed_inputs=False``); pos the position, a 0-d
        integer tensor on the model's device (the reference's traced ``pos``)
        or an int; the caches (KV caches and recurrent states) are updated in
        place and returned.  Nothing in
        the step reads a device value back to the host, so
        ``serve.engine.make_decode_step`` can capture it in a CUDA graph."""
        h = self._inputs(tokens)
        pos = torch.as_tensor(pos, device=self.device)
        new = []
        for layer, c in zip(self.layers, cache):
            h, c = self._decode_layer(layer, h, c, pos)
            new.append(c)
        h = L.rms_norm(h, self.final_norm.scale)
        return head_logits(self.lm_head, h), new
