"""A dense decoder's training step, plainly, in float32 with TF32 off: the
published Qwen3 layer (pre-norm RMSNorm with a ``1 + scale`` gain, q, k, v
projections, RMSNorm of each q and k head, rotary embedding of the half-split
form, causal grouped-query softmax attention, the output projection, a
SwiGLU feed-forward), a final RMSNorm, an untied head and the mean cross
entropy; the gradients by autograd, summed over microbatches; then AdamW with
decoupled weight decay on matrices, a global-norm clip and a linear warm-up
into a cosine decay.  Each layer is recomputed in the backward and the loss
is taken in row blocks, so that the reference fits beside its own optimizer
state.

``matmul="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with a per-tensor scale, the step below the bfloat16 products
the configuration states.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
E4M3_MAX = 448.0
LOSS_ROWS = 1024


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a per-tensor scale, its gradient
    passed straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (q - x.detach())


class Decoder:
    """``m`` holds the configuration's keys (``hidden_size``, ...)."""

    def __init__(self, m: dict, params: dict, matmul: str = "float32"):
        if matmul not in ("float32", "fp8"):
            raise ValueError(f"unknown matmul precision {matmul!r}")
        self.m = m
        self.p = params
        self.round = _fp8 if matmul == "fp8" else (lambda x: x)
        self.eps = m["rms_norm_eps"]

    def mm(self, a, b):
        return self.round(a) @ self.round(b)

    def norm(self, x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * (1.0 + scale)

    def rope(self, x, cos, sin):
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def layer(self, i: int, h, cos, sin):
        m, p, pre = self.m, self.p, f"layers.{i}."
        b, s, d = h.shape
        nh, kh, hd = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
        x = self.norm(h, p[pre + "ln1.scale"]).reshape(b * s, d)
        q = self.mm(x, p[pre + "mixer.wq"]).reshape(b, s, nh, hd)
        k = self.mm(x, p[pre + "mixer.wk"]).reshape(b, s, kh, hd)
        v = self.mm(x, p[pre + "mixer.wv"]).reshape(b, s, kh, hd)
        q = self.rope(self.norm(q, p[pre + "mixer.q_norm.scale"]), cos, sin)
        k = self.rope(self.norm(k, p[pre + "mixer.k_norm.scale"]), cos, sin)
        k = k.repeat_interleave(nh // kh, dim=2)
        v = v.repeat_interleave(nh // kh, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (b, heads, s, hd)
        scores = self.mm(q, k.transpose(-1, -2)) * hd ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        attn = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out = self.mm(attn, v).transpose(1, 2).reshape(b * s, nh * hd)
        h = h + self.mm(out, p[pre + "mixer.wo"]).reshape(b, s, d)
        x = self.norm(h, p[pre + "ln2.scale"]).reshape(b * s, d)
        ff = F.silu(self.mm(x, p[pre + "mlp.w_gate"])) * self.mm(x, p[pre + "mlp.w_up"])
        return h + self.mm(ff, p[pre + "mlp.w_down"]).reshape(b, s, d)

    def _head_loss(self, h, labels):
        return F.cross_entropy(self.mm(h, self.p["lm_head"]), labels, reduction="sum")

    def loss(self, tokens, labels):
        """Mean cross entropy of ``labels`` (B, S) given ``tokens`` (B, S)."""
        m = self.m
        b, s = tokens.shape
        half = m["head_dim"] // 2
        freqs = m["rope_theta"] ** (-torch.arange(half, dtype=torch.float64,
                                                   device=tokens.device) / half)
        ang = torch.arange(s, dtype=torch.float64, device=tokens.device)[:, None] * freqs
        cos, sin = (t.to(F32)[None, :, None, :] for t in (torch.cos(ang), torch.sin(ang)))
        h = self.p["token_embedding"][tokens]
        for i in range(m["num_hidden_layers"]):
            h = checkpoint(self.layer, i, h, cos, sin, use_reentrant=False)
        h = self.norm(h, self.p["final_norm.scale"]).reshape(b * s, -1)
        labels = labels.reshape(b * s)
        total = torch.zeros((), dtype=F32, device=h.device)
        for r in range(0, b * s, LOSS_ROWS):
            total = total + checkpoint(self._head_loss, h[r:r + LOSS_ROWS],
                                       labels[r:r + LOSS_ROWS], use_reentrant=False)
        return total / (b * s)


class AdamW:
    """AdamW over a dict of float32 leaves, the configuration's ``optimizer``
    keys: ``lr``, ``beta1``, ``beta2``, ``eps``, ``weight_decay`` (matrices
    only), ``clip_norm`` (global), ``warmup_steps``, ``decay_steps``,
    ``min_lr_ratio``."""

    def __init__(self, params: dict, opt: dict):
        self.opt = opt
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def lr(self, t: int) -> float:
        o = self.opt
        warm = min(t / max(o["warmup_steps"], 1), 1.0)
        frac = min(max((t - o["warmup_steps"]) / max(o["decay_steps"] - o["warmup_steps"], 1),
                       0.0), 1.0)
        cos = 0.5 * (1 + math.cos(math.pi * frac))
        return o["lr"] * warm * (o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * cos)

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """One update in place; returns each leaf's clipped gradient norm."""
        o = self.opt
        self.t += 1
        norms = {k: torch.linalg.vector_norm(g.double()) for k, g in grads.items()}
        total = math.sqrt(sum(float(n) ** 2 for n in norms.values()))
        scale = min(o["clip_norm"] / max(total, 1e-9), 1.0)
        lr = self.lr(self.t)
        c1 = 1 - o["beta1"] ** self.t
        c2 = 1 - o["beta2"] ** self.t
        for k, p in params.items():
            g = grads[k] * scale
            self.mu[k].mul_(o["beta1"]).add_(g, alpha=1 - o["beta1"])
            self.nu[k].mul_(o["beta2"]).addcmul_(g, g, value=1 - o["beta2"])
            delta = (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + o["eps"])
            if p.dim() >= 2:
                delta = delta + o["weight_decay"] * p
            p.sub_(lr * delta)
        return {k: float(n) * scale for k, n in norms.items()}


def train(m: dict, opt: dict, params: dict, batches, microbatches: int,
          matmul: str = "float32") -> dict:
    """Train ``params`` (float32 leaves, updated in place) on ``batches``
    (``(tokens, labels)`` pairs, each split into ``microbatches`` along its
    rows): ``{"losses": [...], "grad_norms": {leaf: first step's clipped
    gradient norm}}``."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = Decoder(m, params, matmul)
        adam = AdamW(params, opt)
        losses, first = [], None
        for tokens, labels in batches:
            for p in params.values():
                p.requires_grad_(True)
                p.grad = None
            total = 0.0
            for tk, lb in zip(tokens.chunk(microbatches), labels.chunk(microbatches)):
                loss = model.loss(tk.long(), lb.long()) / microbatches
                loss.backward()
                total += float(loss.detach())
            grads = {k: p.grad for k, p in params.items()}
            for p in params.values():
                p.requires_grad_(False)
                p.grad = None
            norms = adam.step(params, grads)
            del grads
            losses.append(total)
            first = first if first is not None else norms
        return {"losses": losses, "grad_norms": first}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
