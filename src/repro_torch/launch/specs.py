"""Meta-device stand-ins and partition specs for every dry-run cell — the
port of ``repro.launch.specs``.

The reference's ``ShapeDtypeStruct`` stand-ins are tensors on the ``meta``
device here, of the reference's shapes and dtypes: nothing is allocated.
``*_shardings`` translate the logical annotations into the port's
``NamedSharding`` (a spec on a ``DeviceMesh``) under ``mesh``'s axis rules.
``train_state_shardings`` is ``train.sharded``'s (it takes the parameters,
not the state).

The port keeps no stacked ``units`` leaves: a model's cache is a list of
per-layer dicts, so :func:`cache_partition_specs` walks that list, and each
spec is the reference's with the stack dimension dropped.
:func:`shard_inputs` and :func:`shard_cache` cut this rank's part of a
batch and of a cache by those specs, as the dry run and the decode-SP path
take them.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.distributed.partitioning import (
    NamedSharding,
    PartitionSpec,
    distribute,
    local_view,
    logical_spec,
    mesh_axis_rules,
    params_partition_specs,
)
from repro_torch.train.sharded import train_state_shardings  # noqa: F401

P = PartitionSpec
META = torch.device("meta")


def sds(shape, dtype: torch.dtype) -> torch.Tensor:
    """A stand-in: a ``meta`` tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(arch: str, shape: str) -> dict:
    """Stand-ins for every model input of a dry-run cell; nothing is
    allocated.  For train cells this is the training batch; for prefill,
    the request batch; for decode, ``{tokens, pos}`` (the KV cache's come
    from :func:`cache_shapes`)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    sh = SHAPES[shape]
    if sh.kind == "train":
        return train_batch_shapes(cfg, sh)
    if sh.kind == "prefill":
        return prefill_batch_shapes(cfg, sh)
    return {
        "tokens": decode_token_shapes(cfg, sh),
        "pos": sds((), torch.int32),
    }


# ------------------------------------------------------------------ inputs
def train_batch_shapes(cfg: ArchConfig, sh: ShapeSpec) -> dict:
    b, s = sh.global_batch, sh.seq_len
    batch: dict[str, Any] = {"labels": sds((b, s), torch.int32)}
    if cfg.is_encdec:
        batch["enc_embeds"] = sds((b, s // cfg.enc_subsample, cfg.d_model), torch.bfloat16)
        batch["tokens"] = sds((b, s), torch.int32)
    elif cfg.embed_inputs:
        batch["tokens"] = sds((b, s), torch.int32)
    else:
        batch["embeds"] = sds((b, s, cfg.d_model), torch.bfloat16)
        if cfg.mrope:
            batch["positions"] = sds((b, 3, s), torch.int32)
    return batch


def prefill_batch_shapes(cfg: ArchConfig, sh: ShapeSpec) -> dict:
    batch = train_batch_shapes(cfg, sh)
    batch.pop("labels")
    return batch


def decode_token_shapes(cfg: ArchConfig, sh: ShapeSpec) -> torch.Tensor:
    b = sh.global_batch
    if cfg.embed_inputs or cfg.is_encdec:
        return sds((b, 1), torch.int32)
    return sds((b, 1, cfg.d_model), torch.bfloat16)


def batch_specs(batch_shapes) -> Any:
    """Each input split over the batch axes on dim 0 (under the active rules)."""
    def one(x):
        return logical_spec("batch", *([None] * (x.dim() - 1)), shape=tuple(x.shape))

    if isinstance(batch_shapes, dict):
        return {k: one(v) for k, v in batch_shapes.items()}
    return one(batch_shapes)


def batch_shardings(mesh, batch_shapes) -> Any:
    with mesh_axis_rules(mesh):
        specs = batch_specs(batch_shapes)
    if isinstance(specs, dict):
        return {k: NamedSharding(mesh, v) for k, v in specs.items()}
    return NamedSharding(mesh, specs)


# ------------------------------------------------------------------ params
def param_shapes(model, dtype: str | None = None) -> dict[str, torch.Tensor]:
    """Stand-ins for the model's weights by ``state_dict`` name (int8
    records as their ``.q`` / ``.s`` buffers); ``dtype`` recasts the
    floating ones."""
    dt = getattr(torch, dtype) if dtype else None
    return {k: sds(v.shape, dt if dt is not None and v.is_floating_point() else v.dtype)
            for k, v in model.state_dict(keep_vars=True).items()}


def param_shardings(mesh, shapes) -> dict[str, NamedSharding]:
    with mesh_axis_rules(mesh):
        specs = params_partition_specs(shapes)
    return {k: NamedSharding(mesh, s) for k, s in specs.items()}


def train_state_shapes(model, cfg: ArchConfig) -> dict:
    p = param_shapes(model, cfg.param_dtype)
    return {
        "params": p,
        "opt": {
            "mu": {k: sds(v.shape, v.dtype) for k, v in p.items()},
            "nu": {k: sds(v.shape, v.dtype) for k, v in p.items()},
            "step": sds((), torch.int32),
        },
    }


# ------------------------------------------------------------------- cache
def cache_shapes(model, cfg: ArchConfig, sh: ShapeSpec) -> list[dict]:
    """The model's decode caches at the cell's batch and length, as
    stand-ins: ``model`` must live on ``meta``."""
    if model.device.type != "meta":
        raise ValueError(f"cache_shapes takes a model on meta, not on {model.device}")
    return model.init_cache(sh.global_batch, sh.seq_len)


_CACHE_AXES = {
    # decode KV caches are sequence-sharded (decode-SP): ring writes stay
    # shard-local and the partial-softmax combine replaces cache gathers
    "k": ("batch", None, "kv_seq", None),
    "v": ("batch", None, "kv_seq", None),
    "cross_k": ("batch", "kv_heads", "kv_seq", None),
    "cross_v": ("batch", "kv_heads", "kv_seq", None),
    "ssm": ("batch", "heads", None, None),
    "conv": ("batch", None, "mlp"),
    "h": ("batch", "mlp"),
}


def cache_partition_specs(cache_shapes_tree) -> list[dict]:
    """Each layer's cache leaves' specs under the active rules: the
    reference's ``_CACHE_AXES`` by leaf name (unknown leaves whole)."""
    out = []
    for layer in cache_shapes_tree:
        specs = {}
        for name, leaf in layer.items():
            axes = _CACHE_AXES.get(name)
            shape = tuple(leaf.shape)
            specs[name] = (P(*([None] * len(shape))) if axes is None
                           else logical_spec(*axes, shape=shape))
        out.append(specs)
    return out


def cache_shardings(mesh, cache_shapes_tree) -> list[dict]:
    with mesh_axis_rules(mesh):
        specs = cache_partition_specs(cache_shapes_tree)
    return [{k: NamedSharding(mesh, s) for k, s in layer.items()} for layer in specs]


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# ------------------------------------------------------------- this rank's
def shard_inputs(mesh, batch: dict) -> dict:
    """This rank's rows of each input (a view), by :func:`batch_shardings`."""
    shardings = batch_shardings(mesh, batch)
    return {k: local_view(v, mesh, shardings[k].placements) for k, v in batch.items()}


def shard_cache(mesh, cache: list[dict]) -> list[dict]:
    """This rank's part of each layer's cache, as the port's decode step
    takes it under ``mesh``'s rules: ``k`` and ``v`` as ``DTensor``s placed
    by :func:`cache_shardings` (the rank's batch rows and, where the rules
    split it, its chunk of ring slots: decode-SP); every other leaf (the
    cross K/V, the recurrent states) the rank's batch rows whole — the port
    computes those whole for its rows, where the reference leaves their
    placement to GSPMD."""
    shardings = cache_shardings(mesh, cache)
    out = []
    for layer, sh in zip(cache, shardings):
        part = {}
        for name, leaf in layer.items():
            if name in ("k", "v"):
                part[name] = distribute(leaf, sh[name])
            else:
                rows = NamedSharding(mesh, P(sh[name].spec[0] if sh[name].spec else None))
                part[name] = local_view(leaf, mesh, rows.placements).clone()
        out.append(part)
    return out
