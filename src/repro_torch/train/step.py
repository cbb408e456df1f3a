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
(``optimizer.adamw_update``).  The reference's ``train_state_specs`` and
``batch_specs`` wait for the port's sharding rules (ROADMAP queue 1 item
8.12).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .optimizer import AdamWConfig, adamw_init, adamw_update


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


def make_train_step(
    model,
    opt_cfg: AdamWConfig,
    grad_accum: int = 1,
    grad_dtype: str | None = None,  # "bfloat16" => compressed DP all-reduce
) -> Callable:
    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt = state["params"], state["opt"]
        for t in params.values():
            t.requires_grad_(True)
            t.grad = None
        acc: dict = {}
        hooks = _accumulate(params, acc)
        try:
            if grad_accum == 1:
                loss, metrics = model.loss(params, batch)
                loss.backward()
                loss = loss.detach()
                metrics = {k: v.detach() for k, v in metrics.items()}
            else:
                loss, metrics = 0.0, {}
                for i in range(grad_accum):
                    mb = {k: v[i * (v.shape[0] // grad_accum):(i + 1) * (v.shape[0] // grad_accum)]
                          for k, v in batch.items()}
                    micro, _ = model.loss(params, mb)
                    micro.backward()
                    loss = loss + micro.detach()
                loss = loss / grad_accum
        finally:
            for h in hooks:
                h.remove()
        grads = {}
        for k, t in params.items():
            g = acc.pop(k, None)
            if g is None:  # a weight the loss does not reach: jax.grad's zeros
                g = torch.zeros_like(t, dtype=torch.float32)
            elif grad_accum > 1:
                g.div_(grad_accum)
            grads[k] = g if grad_dtype is None else g.to(getattr(torch, grad_dtype))
        params, opt, opt_metrics = adamw_update(params, grads, opt, opt_cfg)
        return {"params": params, "opt": opt}, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def init_train_state(model) -> dict:
    """The model's own parameters (by ``state_dict`` name; build the model
    with ``param_dtype=cfg.param_dtype`` for master weights) and zero AdamW
    moments."""
    params = dict(model.state_dict(keep_vars=True))
    return {"params": params, "opt": adamw_init(params)}
