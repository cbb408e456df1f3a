"""Train-step factory — the port of ``repro.train.step``.

``make_train_step`` closes over the model and optimizer config and returns
``(state, batch) -> (state, metrics)``.  The state is ``{"params": {name:
tensor}, "opt": adamw_init(params)}`` (names as in the model's
``state_dict``; :func:`init_train_state` takes the model's own parameters,
so serving the model serves the trained weights).  Gradient accumulation
runs the loss over ``grad_accum`` microbatches (the batch split along its
first dimension, as the reference's reshape) and sums each parameter's
gradient into float32 as soon as autograd has it, then divides by
``grad_accum``; ``grad_dtype`` casts the gradients before the update (the
reference's compressed DP all-reduce flag).  The update is in place
(``optimizer.adamw_update``).  ``train_state_specs`` and ``batch_specs``
give the state's and the batch's partition specs under the active axis
rules; ``train.sharded`` runs the step over a ``DeviceMesh`` with them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed.partitioning import logical_spec, params_partition_specs
from repro_torch.tracing import span

from .optimizer import AdamWConfig, adamw_init, adamw_update, opt_state_specs


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    step: int = 0


def _accumulate(params: dict, acc: dict) -> list:
    """Hooks that move each parameter's gradient, once autograd has
    accumulated it, into ``acc`` (float32), freeing ``.grad``."""
    def hook_for(name):
        def hook(t):
            g, t.grad = t.grad, None
            if name in acc:
                acc[name].add_(g)
            else:
                acc[name] = g if g.dtype == torch.float32 else g.float()
        return hook
    return [t.register_post_accumulate_grad_hook(hook_for(k)) for k, t in params.items()]


def microbatches(batch: dict, grad_accum: int, n_data: int = 1, rank: int = 0) -> list[dict]:
    """Data rank ``rank``'s share of each of the batch's ``grad_accum``
    microbatches: the reference splits the batch along its first dimension
    into ``grad_accum`` microbatches (``reshape((grad_accum, B /
    grad_accum))``) and each of ``n_data`` ranks takes its slice of each,
    rows ``i·B/ga + rank·B/(ga·n_data)`` on.  One rank and one microbatch:
    the batch itself."""
    if grad_accum == 1 and n_data == 1:
        return [batch]
    b = next(iter(batch.values())).shape[0]
    if b % (grad_accum * n_data):
        raise ValueError(f"batch of {b} rows does not split into {grad_accum} "
                         f"microbatches over {n_data} data ranks")
    size = b // (grad_accum * n_data)
    starts = [i * (b // grad_accum) + rank * size for i in range(grad_accum)]
    return [{k: v[s:s + size] for k, v in batch.items()} for s in starts]


def loss_and_grads(model, params: dict, mbs: list[dict]) -> tuple:
    """``(loss, metrics, grads)`` of ``model.loss`` over the microbatches
    ``mbs`` at ``params`` (plain tensors, made the leaves that require
    grad): the mean loss (one microbatch: its metrics too; several: none,
    as the reference's scan), and each parameter's float32 gradient summed
    by post-accumulate hooks as autograd produces it, then divided by the
    number of microbatches (zeros for a weight the loss does not reach, as
    ``jax.grad`` gives)."""
    for t in params.values():
        t.requires_grad_(True)
        t.grad = None
    acc: dict = {}
    hooks = _accumulate(params, acc)
    try:
        if len(mbs) == 1:
            with span("rm::train.forward"):
                loss, metrics = model.loss(params, mbs[0])
            with span("rm::train.backward"):
                loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            loss, metrics = 0.0, {}
            for mb in mbs:
                with span("rm::train.forward"):
                    micro, _ = model.loss(params, mb)
                with span("rm::train.backward"):
                    micro.backward()
                loss = loss + micro.detach()
            loss = loss / len(mbs)
    finally:
        for h in hooks:
            h.remove()
    grads = {}
    for k, t in params.items():
        g = acc.pop(k, None)
        if g is None:  # a weight the loss does not reach: jax.grad's zeros
            g = torch.zeros_like(t, dtype=torch.float32)
        elif len(mbs) > 1:
            g.div_(len(mbs))
        grads[k] = g
    return loss, metrics, grads


def make_train_step(
    model,
    opt_cfg: AdamWConfig,
    grad_accum: int = 1,
    grad_dtype: str | None = None,  # "bfloat16" => compressed DP all-reduce
) -> Callable:
    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt = state["params"], state["opt"]
        loss, metrics, grads = loss_and_grads(model, params, microbatches(batch, grad_accum))
        if grad_dtype is not None:
            grads = {k: g.to(getattr(torch, grad_dtype)) for k, g in grads.items()}
        with span("rm::train.update"):
            params, opt, opt_metrics = adamw_update(params, grads, opt, opt_cfg)
        return {"params": params, "opt": opt}, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def init_train_state(model) -> dict:
    """The model's own parameters (by ``state_dict`` name; build the model
    with ``param_dtype=cfg.param_dtype`` for master weights) and zero AdamW
    moments."""
    params = dict(model.state_dict(keep_vars=True))
    return {"params": params, "opt": adamw_init(params)}


def train_state_specs(params) -> dict:
    """Partition specs for the full train state (params TP + FSDP, moments
    ZeRO-1) of a flat parameter dict (tensors, or shapes)."""
    return {"params": params_partition_specs(params), "opt": opt_state_specs(params)}


def batch_specs(batch) -> dict:
    """Data batches are sharded over the batch axes on dim 0."""
    def spec(x):
        shape = tuple(getattr(x, "shape", x))
        return logical_spec("batch", *([None] * (len(shape) - 1)), shape=shape)

    return {k: spec(v) for k, v in batch.items()}
