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
products are not part of the port.  The loss runs under the mesh's axis
rules (``partitioning.mesh_axis_rules``), so an MoE layer takes the
reference's sharded forms (``models.layers.moe_block``): its experts split
over ``model``, its capacity and auxiliary loss over the global
microbatch.  The mesh is ``(data, model)`` or the multi-pod ``(pod, data,
model)``, whose batch goes over ``(pod, data)`` as ``MULTI_POD_RULES``
says: "the data ranks" are then both axes' ranks.  Every collective is
reported to an active roofline count (``roofline.analysis``): the
all-gathers of ``full_tensor()`` and of the redistribution, the data
group's all-reduces.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.distributed.collectives import all_reduce, tree_psum_compressed
from repro_torch.distributed.partitioning import (
    NamedSharding,
    PartitionSpec,
    axis_group,
    axis_index,
    axis_size,
    distribute,
    from_local,
    local_view,
    mesh_axis_rules,
    rules_for_mesh,
)
from repro_torch.roofline.analysis import record_collective

from . import optimizer
from .optimizer import AdamWConfig, _step_scalars, _update_leaf
from .step import loss_and_grads, microbatches, train_state_specs

MESH_AXES = (("data", "model"), ("pod", "data", "model"))


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


def _is_expert(name: str) -> bool:
    """An MoE layer's expert tensor (``layers.{i}.moe.expert_*``)."""
    return ".moe.expert_" in name


def _gather(mesh, place, to, local_bytes: int) -> None:
    """Report the all-gather that takes a tensor from placements ``place`` to
    ``to`` (``Shard`` to ``Replicate`` on some mesh dimensions), whose
    output on this rank is ``local_bytes``, over those dimensions' ranks."""
    n = 1
    for m, (a, b) in enumerate(zip(place, to)):
        if isinstance(a, Shard) and isinstance(b, Replicate):
            n *= mesh.size(m)
    if n > 1:
        record_collective("all-gather", local_bytes, n)


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
    model)`` or ``(pod, data, model)`` ``DeviceMesh`` (by default
    ``launch.mesh.host_device_mesh()``: the process group's world on the
    card).  ``state`` is :func:`shard_train_state`'s, updated in place;
    every rank passes the same global ``batch``.  A model on ``meta`` (the
    dry run) takes a mesh of any device type."""
    if mesh is None:
        from repro_torch.launch.mesh import host_device_mesh

        mesh = host_device_mesh()
    if tuple(mesh.mesh_dim_names) not in MESH_AXES:
        raise ValueError(f"the sharded step takes a mesh of axes {' or '.join(map(str, MESH_AXES))}, "
                         f"not {mesh.mesh_dim_names}")
    if model.device.type not in (mesh.device_type, "meta"):
        raise ValueError(f"model on {model.device}, mesh on {mesh.device_type}")
    batch_axes = rules_for_mesh(mesh)["batch"]
    n_data = axis_size(mesh, batch_axes)
    mode = "bf16" if grad_dtype == "bfloat16" else "none"
    group = axis_group(mesh, batch_axes)
    rank = axis_index(mesh, batch_axes)

    expert_axes = rules_for_mesh(mesh)["expert"]
    n_expert = axis_size(mesh, expert_axes) if model.cfg.n_experts else 1
    e_local = model.cfg.n_experts // n_expert if n_expert > 1 else 0

    def global_norm(grads: dict) -> torch.Tensor:
        """The whole gradient's norm.  Under the MoE block's expert-parallel
        forms (more than one expert rank) each rank holds the gradients of
        its own experts only: their squares are summed over the expert
        group, the rest (alike on every rank) added once."""
        if n_expert == 1:
            return optimizer.global_norm(grads)
        shard = axis_index(mesh, expert_axes) * e_local
        sq = [torch.linalg.vector_norm(g[shard:shard + e_local] if _is_expert(k) else g,
                                       dtype=torch.float32) ** 2 for k, g in grads.items()]
        mine = torch.stack([q for (k, _), q in zip(grads.items(), sq) if _is_expert(k)]).sum()
        rest = torch.stack([q for (k, _), q in zip(grads.items(), sq) if not _is_expert(k)])
        return torch.sqrt(rest.sum() + all_reduce(mine, axis_group(mesh, expert_axes)))

    def mean_over_data(x: torch.Tensor) -> torch.Tensor:
        x = all_reduce(x.clone(), group)
        return x / n_data if n_data > 1 else x

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt = state["params"], state["opt"]
        with torch.no_grad():
            full = {}
            for k, p in params.items():
                full[k] = p.full_tensor().detach()
                _gather(mesh, p.placements, (Replicate(),) * mesh.ndim,
                        full[k].numel() * full[k].element_size())
        with mesh_axis_rules(mesh):
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
            step, gnorm, scale, lr, c1, c2 = _step_scalars(grads, count, opt_cfg,
                                                           global_norm(grads))
            for k, p in params.items():
                mu, nu = opt["mu"][k], opt["nu"][k]
                place = mu.placements
                part = local_view(full.pop(k), mesh, place)
                _update_leaf(part, local_view(grads.pop(k), mesh, place), mu.to_local(),
                             nu.to_local(), scale, lr, c1, c2, opt_cfg)
                local = p.to_local()
                local.copy_(from_local(part.contiguous(), mesh, place, p.shape)
                            .redistribute(mesh, p.placements).to_local())
                _gather(mesh, place, p.placements, local.numel() * local.element_size())
            count.copy_(step)
        return state, {**metrics, "grad_norm": gnorm, "lr": lr}

    return train_step
