"""The train step over a ``DeviceMesh`` — the port of the reference's
``jax.jit(make_train_step(...), in_shardings=..., out_shardings=...)``.

The reference leaves the placement of compute to GSPMD; here it is stated.
Between steps the state is ``DTensor``s: each parameter placed by
``params_partition_specs`` (tensor-parallel over ``model``, FSDP over
``data``), each AdamW moment by ``opt_state_specs`` (ZeRO-1: the ``data``
axis also on the leaves FSDP left whole), the step count replicated.  A
step

1. gathers every parameter to a plain tensor once (``full_tensor()``);
2. runs the model's loss and backward (``step.loss_and_grads``) on this
   rank's share of each of the reference's global microbatches
   (``step.microbatches``) — no kernel ever sees a ``DTensor``;
3. all-reduces the float32 gradient sums over the ``data`` group with
   ``tree_psum_compressed`` (``"none"``; ``grad_dtype="bfloat16"``:
   ``"bf16"``) and divides them by the data ranks;
4. takes the global norm and the clip on the whole reduced gradient, which
   is the same on every rank;
5. updates each rank's slice of every parameter, gradient and moment at the
   moments' placement (``optimizer._update_leaf``, in place), and
   redistributes the parameter's slice to the parameter's own placement —
   ZeRO-1's all-gather over ``data`` for the leaves FSDP left whole — into
   the state's tensors.

Ranks along ``model`` compute their data shard whole: tensor-parallel
products are not part of the port.  A config with MoE layers is refused
once there is more than one data rank: the MoE block's capacity and
auxiliary loss are taken over the whole microbatch, which would then span
ranks.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import tree_psum_compressed
from repro_torch.distributed.partitioning import (
    NamedSharding,
    PartitionSpec,
    distribute,
    from_local,
    local_view,
    mesh_axis_rules,
)

from .optimizer import AdamWConfig, _step_scalars, _update_leaf
from .step import loss_and_grads, microbatches, train_state_specs

MESH_AXES = ("data", "model")


def train_state_shardings(mesh, params) -> dict:
    """Where each leaf of a train state lies on ``mesh``: ``{"params":
    {name: NamedSharding}, "opt": {"mu": ..., "nu": ..., "step": ...}}``,
    from ``train_state_specs`` under ``mesh``'s axis rules."""
    with mesh_axis_rules(mesh):
        specs = train_state_specs(params)

    def on_mesh(tree):
        if isinstance(tree, PartitionSpec):
            return NamedSharding(mesh, tree)
        return {k: on_mesh(v) for k, v in tree.items()}

    return on_mesh(specs)


def _place(tree, shardings):
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    return distribute(tree, shardings)


def shard_train_state(state: dict, mesh) -> dict:
    """``state`` (``step.init_train_state``'s, whole on every rank) placed
    on ``mesh`` by :func:`train_state_shardings`; each rank keeps its slice
    (a rank that holds a leaf whole keeps the tensor itself)."""
    return _place(state, train_state_shardings(mesh, state["params"]))


def make_sharded_train_step(
    model,
    opt_cfg: AdamWConfig,
    mesh=None,
    grad_accum: int = 1,
    grad_dtype: str | None = None,  # "bfloat16" => compressed DP all-reduce
) -> Callable:
    """``(state, batch) -> (state, metrics)`` over ``mesh``, a ``(data,
    model)`` ``DeviceMesh`` (by default ``launch.mesh.host_device_mesh()``:
    the process group's world on the card).  ``state`` is
    :func:`shard_train_state`'s, updated in place; every rank passes the
    same global ``batch``."""
    if mesh is None:
        from repro_torch.launch.mesh import host_device_mesh

        mesh = host_device_mesh()
    if tuple(mesh.mesh_dim_names) != MESH_AXES:
        raise ValueError(f"the sharded step takes a {MESH_AXES} mesh, "
                         f"not {mesh.mesh_dim_names}")
    if model.device.type != mesh.device_type:
        raise ValueError(f"model on {model.device}, mesh on {mesh.device_type}")
    n_data = mesh.size(0)
    if n_data > 1 and model.cfg.n_experts:
        raise ValueError(f"{model.cfg.name} has MoE layers, whose capacity and aux loss "
                         "span the data ranks: their data-sharded forms are ROADMAP item "
                         "8.12(b); use one data rank")
    mode = "bf16" if grad_dtype == "bfloat16" else "none"
    group = mesh.get_group("data")
    rank = mesh.get_local_rank("data")

    def mean_over_data(x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x / n_data if n_data > 1 else x

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt = state["params"], state["opt"]
        with torch.no_grad():
            full = {k: p.full_tensor().detach() for k, p in params.items()}
        loss, metrics, grads = loss_and_grads(
            model, full, microbatches(batch, grad_accum, n_data, rank))
        for t in full.values():
            t.requires_grad_(False)
        grads, _ = tree_psum_compressed(grads, None, group, mode)
        if n_data > 1:
            for g in grads.values():
                g.div_(n_data)
        if grad_dtype is not None:
            grads = {k: g.to(getattr(torch, grad_dtype)) for k, g in grads.items()}
        metrics = {k: mean_over_data(v) for k, v in {"loss": loss, **metrics}.items()}
        with torch.no_grad():
            count = opt["step"].to_local()
            step, gnorm, scale, lr, c1, c2 = _step_scalars(grads, count, opt_cfg)
            for k, p in params.items():
                mu, nu = opt["mu"][k], opt["nu"][k]
                place = mu.placements
                part = local_view(full.pop(k), mesh, place)
                _update_leaf(part, local_view(grads.pop(k), mesh, place), mu.to_local(),
                             nu.to_local(), scale, lr, c1, c2, opt_cfg)
                p.to_local().copy_(from_local(part.contiguous(), mesh, place, p.shape)
                                   .redistribute(mesh, p.placements).to_local())
            count.copy_(step)
        return state, {**metrics, "grad_norm": gnorm, "lr": lr}

    return train_step
