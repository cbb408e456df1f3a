"""Carry the reference package's decoder weights into the port.

``params_from_reference(cfg, tree)`` takes the tree that the reference's
``DecoderLM(cfg).init(key)`` returns, as numpy arrays (nested dicts), and
gives the port's ``state_dict``: the stacked unit leaves
``units/b{i}/...`` (leading axis ``n_units``) are unstacked into
``layers.{u * len(pattern) + i}...``, the tail's ``tail/b{i}/...`` follow
them, and ``token_embedding``, ``final_norm/scale`` and ``lm_head`` keep
their names.  A leaf the port does not use, a missing one, or one of the
wrong shape raises.  The values stay float32: ``load_state_dict`` casts the
matmul weights to the model's compute dtype, as the reference casts them at
use.  Nothing here imports JAX: callers hand over numpy.

A tree that ``repro``'s ``quantize_for_serving`` made holds an int8 record
``{"q": int8 (in, out), "s": bf16 (1, out)}`` in place of each quantized
weight (stacked units: ``(n_units, in, out)`` and ``(n_units, 1, out)``);
its ``q`` stays int8 and its ``s`` becomes float32 holding the bf16 values.
Such a tree loads into a model that ``layers.quantize_for_serving`` has
quantized, whose state names are ``<weight>.q`` and ``<weight>.s``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

from .layers import _QUANT_NAMES
from .lm import Block, check_config, layer_kinds


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def expected_shapes(cfg: ArchConfig, quantized: bool = False) -> dict[str, tuple[int, ...]]:
    """Every weight name of the port's decoder for ``cfg`` and its shape;
    ``quantized``: after ``quantize_for_serving`` (``.q`` and ``.s``)."""
    check_config(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    out = {"token_embedding": (v, d), "final_norm.scale": (d,), "lm_head": (d, v)}
    for idx, kind in enumerate(layer_kinds(cfg)):
        block = Block(kind, cfg, torch.float32, device="meta")
        for name, t in block.state_dict().items():
            if quantized and name.rpartition(".")[2] in _QUANT_NAMES and t.dim() == 2:
                out[f"layers.{idx}.{name}.q"] = tuple(t.shape)
                out[f"layers.{idx}.{name}.s"] = (1, t.shape[1])
            else:
                out[f"layers.{idx}.{name}"] = tuple(t.shape)
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
    for path, leaf in _flatten(tree):
        top, _, rest = path.partition(".")
        if top == "units":
            blk, _, name = rest.partition(".")
            i = int(blk[1:])
            if leaf.shape[:1] != (cfg.n_units,):
                raise ValueError(f"{path}: stacked over {leaf.shape[:1]}, want "
                                 f"({cfg.n_units},) units")
            for u in range(cfg.n_units):
                out[f"layers.{u * width + i}.{name}"] = _tensor(leaf[u])
            continue
        if top == "tail":
            blk, _, name = rest.partition(".")
            path = f"layers.{base + int(blk[1:])}.{name}"
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
