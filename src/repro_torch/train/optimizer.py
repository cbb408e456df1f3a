"""AdamW with global-norm clipping — the port of ``repro.train.optimizer``.

Pure-function optimizer as the reference's: ``adamw_init`` builds the moment
tree, ``adamw_update`` applies one step — here in place, on the tensors of
the state it is given (the reference returns new arrays and donates the old
buffers; at full width a second copy of the state would not fit the card).
Trees are dicts (nested or flat) of tensors.  ZeRO-1 comes from placement,
not algorithm: ``opt_state_specs`` gives each moment the parameter's TP spec
plus the ``zero`` (data) axis on its first shardable dimension, and the
sharded train step (``train.sharded``) updates each rank's slice of the
moments there.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.partitioning import (
    PartitionSpec,
    current_mesh_shape,
    current_rules,
    params_partition_specs,
)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio·lr (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(params) -> dict:
    """Zero moments shaped and typed as ``params``, and a 0-d int32 step, on
    the params' device."""
    leaves = _leaves(params)
    device = leaves[0].device if leaves else None
    return {
        "mu": _map(torch.zeros_like, params),
        "nu": _map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum(x²))`` over every leaf, in float32."""
    sq = [torch.linalg.vector_norm(x, dtype=torch.float32) ** 2 for x in _leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def _update_leaf(p, g, mu, nu, scale, lr, c1, c2, cfg: AdamWConfig) -> None:
    """One leaf's AdamW step, the reference's arithmetic: moment math in
    float32, stored back in the moment's dtype; decoupled decay on matrices
    (``ndim >= 2``) only.  A float32 moment or parameter is updated in
    place; another is computed in float32 and copied back."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.float() * scale
    mu_f = mu if mu.dtype == torch.float32 else mu.float()
    nu_f = nu if nu.dtype == torch.float32 else nu.float()
    mu_f.mul_(b1).add_((1 - b1) * g)
    nu_f.mul_(b2).add_(((1 - b2) * g).mul_(g))
    del g
    delta = (mu_f / c1).div_(torch.sqrt(nu_f / c2).add_(cfg.eps))
    if p.dim() >= 2:  # decoupled weight decay on matrices only
        delta.add_(cfg.weight_decay * p.float())
    if p.dtype == torch.float32:
        p.sub_(delta.mul_(lr))
    else:
        p.copy_((p.float() - lr * delta).to(p.dtype))
    if mu_f is not mu:
        mu.copy_(mu_f)
    if nu_f is not nu:
        nu.copy_(nu_f)


@torch.no_grad()
def _step_scalars(grads, step, cfg: AdamWConfig, gnorm=None) -> tuple:
    """``(step + 1, grad_norm, clip scale, lr, c1, c2)`` of an update from
    the whole gradient tree (or its norm ``gnorm``, where given) and the
    step count before it."""
    step = step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    c1 = 1 - cfg.beta1 ** step.to(torch.float32)
    c2 = 1 - cfg.beta2 ** step.to(torch.float32)
    return step, gnorm, scale, lr, c1, c2


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, applied in place to ``params`` and ``state``'s
    moments. Returns (params, state, metrics), the same trees."""
    step, gnorm, scale, lr, c1, c2 = _step_scalars(grads, state["step"], cfg)
    for p, g, mu, nu in zip(_leaves(params), _leaves(grads), _leaves(state["mu"]),
                            _leaves(state["nu"])):
        _update_leaf(p, g, mu, nu, scale, lr, c1, c2, cfg)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _with_zero_axis(spec: PartitionSpec, shape: tuple[int, ...]) -> PartitionSpec:
    """Add the ZeRO ('zero' rule) axes to the first unsharded, divisible dim.

    FSDP-sharded weights already consume the data axis — those moments are
    left as-is (they are already fully sharded); the zero axis only lands on
    leaves (biases, norm scales, vectors) the FSDP rules skipped.
    """
    rules = current_rules() or {}
    zero = rules.get("zero")
    if not zero:
        return spec
    used: set[str] = set()
    for e in spec:
        if e is None:
            continue
        for a in (e if isinstance(e, (tuple, list)) else (e,)):
            used.add(a)
    zero = tuple(a for a in zero if a not in used)
    if not zero:
        return spec
    sizes = current_mesh_shape()
    n = 1
    for a in zero:
        n *= sizes.get(a, 1)
    if n <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for d, e in enumerate(entries):
        if e is None and shape[d] % n == 0 and shape[d] > 0:
            entries[d] = zero if len(zero) > 1 else zero[0]
            return PartitionSpec(*entries)
    return spec


def opt_state_specs(params) -> dict:
    """Partition specs for the optimizer state (ZeRO-1 over the data axis):
    ``{"mu": {name: spec}, "nu": ..., "step": PartitionSpec()}`` for a flat
    parameter dict (tensors, or shapes).  The reference's stacked vectors
    (``units/b0/ln1/scale``, ``(n_units, d)``) take the zero axis on the
    stack dimension where the data axes divide the layer count; a port leaf
    is one layer's and has no such dimension, so the axis falls on its own
    first divisible one, as the reference places its unstacked tail."""
    moments = {k: _with_zero_axis(s, tuple(getattr(params[k], "shape", params[k])))
               for k, s in params_partition_specs(params).items()}
    return {"mu": moments, "nu": dict(moments), "step": PartitionSpec()}
