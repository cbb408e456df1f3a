"""Carry the reference package's model weights into the port.

``params_from_reference(cfg, tree)`` takes the tree that the reference's
``DecoderLM(cfg).init(key)`` returns, as numpy arrays (nested dicts), and
gives the port's ``state_dict``: the stacked unit leaves
``units/b{i}/...`` (leading axis ``n_units``) are unstacked into
``layers.{u * len(pattern) + i}...``, the tail's ``tail/b{i}/...`` follow
them, and ``token_embedding``, ``final_norm/scale`` and ``lm_head`` keep
their names (a config with ``embed_inputs=False``, the VLM backbone, has
no ``token_embedding``).  An MoE layer's leaves (``moe/router``, ``moe/expert_gate``,
``moe/expert_up``, ``moe/expert_down``: stacked ``(n_units, E, d, f)``)
unstack on the first axis like the others; a pattern of several kinds
(llama4's ``("attn", "moe")``, recurrentgemma's ``("rglru", "rglru",
"local")`` × 12 and its ``("rglru", "rglru")`` tail at layers 36 and 37)
puts unit ``u``'s ``b{i}`` at layer ``u * len(pattern) + i``.  The
recurrent mixers' leaves (``mixer/w_zx``, ``mixer/conv_kernel``,
``mixer/a_log``, … of an ``ssd`` layer, which has no ``ln2`` and no FFN;
``mixer/w_branch``, ``mixer/w_a``, ``mixer/lambda_``, … of an ``rglru``
layer) map by the same names.  A leaf the port does not use, a missing one,
or one of the wrong shape raises.  The values stay float32:
``load_state_dict`` casts the matmul weights to the model's compute dtype,
as the reference casts them at use, and keeps float32 the leaves the model
holds in float32 (norm scales, ``a_log``, ``dt_bias``, ``d_skip``, ``w_a``,
``b_a``, ``w_x``, ``b_x``, ``lambda_``).  Nothing here imports JAX: callers
hand over numpy.

The encoder-decoder's tree (``repro.models.encdec``) maps the same way:
``enc_units/...`` (stacked over ``n_enc_layers``) to ``enc_layers.{i}...``,
``units/...`` (stacked over ``n_layers``, each with ``ln_x`` and the
``cross`` attention's ``wq``, ``wk``, ``wv``, ``wo``) to ``layers.{i}...``,
and ``token_embedding``, ``enc_norm/scale``, ``final_norm/scale`` and
``lm_head`` keep their names.

``train_state_from_reference(cfg, tree)`` carries a whole train state:
the reference's ``{"params": ..., "opt": {"mu": ..., "nu": ..., "step"}}``
(``repro.train.step.init_train_state`` and the step's output) becomes the
port's, each of ``params``, ``opt/mu`` and ``opt/nu`` mapped as above and
``opt/step`` a 0-d int32 tensor.

A tree that ``repro``'s ``quantize_for_serving`` made holds an int8 record
``{"q": int8 (in, out), "s": bf16 (1, out)}`` in place of each quantized
weight (stacked units: ``(n_units, in, out)`` and ``(n_units, 1, out)``);
its ``q`` stays int8 and its ``s`` becomes float32 holding the bf16 values.
Such a tree loads into a model that ``layers.quantize_for_serving`` has
quantized, whose state names are ``<weight>.q`` and ``<weight>.s``.  The
router and expert tensors are not quantized (their names are not in
``_QUANT_NAMES``): in such a tree they are bf16 leaves, carried as float32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

from .encdec import DecoderLayer, EncoderLayer, attn_specs
from .layers import _QUANT_NAMES
from .lm import Block, check_config, layer_kinds


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _layers(cfg: ArchConfig) -> list[tuple[str, torch.nn.Module]]:
    """(state prefix, an empty layer on the meta device) for every layer of
    the port's model for ``cfg``."""
    dt = torch.float32
    if cfg.is_encdec:
        enc_spec, dec_spec, cross_spec = attn_specs(cfg)
        enc = EncoderLayer(cfg, enc_spec, dt, "meta")
        dec = DecoderLayer(cfg, dec_spec, cross_spec, dt, "meta")
        return ([(f"enc_layers.{i}", enc) for i in range(cfg.n_enc_layers)]
                + [(f"layers.{i}", dec) for i in range(cfg.n_layers)])
    return [(f"layers.{i}", Block(kind, cfg, dt, device="meta"))
            for i, kind in enumerate(layer_kinds(cfg))]


def expected_shapes(cfg: ArchConfig, quantized: bool = False) -> dict[str, tuple[int, ...]]:
    """Every weight name of the port's model for ``cfg`` and its shape;
    ``quantized``: after ``quantize_for_serving`` (``.q`` and ``.s``)."""
    check_config(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    out = {"final_norm.scale": (d,), "lm_head": (d, v)}
    if cfg.embed_inputs:
        out["token_embedding"] = (v, d)
    if cfg.is_encdec:
        out["enc_norm.scale"] = (d,)
    for prefix, layer in _layers(cfg):
        for name, t in layer.state_dict().items():
            if quantized and name.rpartition(".")[2] in _QUANT_NAMES and t.dim() == 2:
                out[f"{prefix}.{name}.q"] = tuple(t.shape)
                out[f"{prefix}.{name}.s"] = (1, t.shape[1])
            else:
                out[f"{prefix}.{name}"] = tuple(t.shape)
    return out


def _tensor(leaf: np.ndarray) -> torch.Tensor:
    if leaf.dtype == np.int8:  # an int8 record's q
        return torch.from_numpy(np.array(leaf))
    return torch.from_numpy(np.array(leaf, np.float32))


def params_from_reference(cfg: ArchConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for ``cfg`` from the reference's numpy tree
    (int8 records of a quantized tree included)."""
    width = len(cfg.block_pattern)
    base = cfg.n_units * width
    out: dict[str, torch.Tensor] = {}

    def unstack(path, leaf, n: int, name_of) -> None:
        if leaf.shape[:1] != (n,):
            raise ValueError(f"{path}: stacked over {leaf.shape[:1]}, want ({n},)")
        for u in range(n):
            out[name_of(u)] = _tensor(leaf[u])

    for path, leaf in _flatten(tree):
        top, _, rest = path.partition(".")
        if cfg.is_encdec and top in ("enc_units", "units"):
            n, prefix = ((cfg.n_enc_layers, "enc_layers") if top == "enc_units"
                         else (cfg.n_layers, "layers"))
            unstack(path, leaf, n, lambda u: f"{prefix}.{u}.{rest}")
        elif top == "units":
            blk, _, name = rest.partition(".")
            i = int(blk[1:])
            unstack(path, leaf, cfg.n_units, lambda u: f"layers.{u * width + i}.{name}")
        elif top == "tail":
            blk, _, name = rest.partition(".")
            out[f"layers.{base + int(blk[1:])}.{name}"] = _tensor(leaf)
        else:
            out[path] = _tensor(leaf)
    quantized = any(path.endswith((".q", ".s")) for path in out)
    want = expected_shapes(cfg, quantized)
    extra, missing = sorted(set(out) - set(want)), sorted(set(want) - set(out))
    if extra or missing:
        raise ValueError(f"reference tree does not match {cfg.name}: leaves the "
                         f"port does not use {extra}, missing {missing}")
    bad = {k: (tuple(t.shape), want[k]) for k, t in out.items() if tuple(t.shape) != want[k]}
    if bad:
        raise ValueError(f"leaves of the wrong shape (got, want): {bad}")
    return out


def train_state_from_reference(cfg: ArchConfig, tree: dict) -> dict:
    """The port's train state (``train.step``) from the reference's numpy
    train state: params and both AdamW moments through
    :func:`params_from_reference`, the step count as a 0-d int32 tensor."""
    opt = tree["opt"]
    return {"params": params_from_reference(cfg, tree["params"]),
            "opt": {"mu": params_from_reference(cfg, opt["mu"]),
                    "nu": params_from_reference(cfg, opt["nu"]),
                    "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32)}}
