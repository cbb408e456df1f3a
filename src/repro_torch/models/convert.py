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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

from .lm import Block, check_config, layer_kinds


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def expected_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """Every weight name of the port's decoder for ``cfg`` and its shape."""
    check_config(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    out = {"token_embedding": (v, d), "final_norm.scale": (d,), "lm_head": (d, v)}
    for idx, kind in enumerate(layer_kinds(cfg)):
        block = Block(kind, cfg, torch.float32, device="meta")
        for name, t in block.state_dict().items():
            out[f"layers.{idx}.{name}"] = tuple(t.shape)
    return out


def params_from_reference(cfg: ArchConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for ``cfg`` from the reference's numpy tree."""
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
                out[f"layers.{u * width + i}.{name}"] = torch.from_numpy(
                    np.array(leaf[u], np.float32))
            continue
        if top == "tail":
            blk, _, name = rest.partition(".")
            path = f"layers.{base + int(blk[1:])}.{name}"
        out[path] = torch.from_numpy(np.array(leaf, np.float32))
    want = expected_shapes(cfg)
    extra, missing = sorted(set(out) - set(want)), sorted(set(want) - set(out))
    if extra or missing:
        raise ValueError(f"reference tree does not match {cfg.name}: leaves the "
                         f"port does not use {extra}, missing {missing}")
    bad = {k: (tuple(t.shape), want[k]) for k, t in out.items() if tuple(t.shape) != want[k]}
    if bad:
        raise ValueError(f"leaves of the wrong shape (got, want): {bad}")
    return out
