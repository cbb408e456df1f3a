"""Compressed cross-replica gradient reduction — the port of
``repro.distributed.collectives``.

Two compression levels for the data-parallel all-reduce, both standard
large-cluster tricks:

* **bf16** — cast before the all-reduce (2× fewer bytes on the wire).
* **int8 + error feedback** — per-tensor scale quantization with a residual
  carried between steps, so quantization error is re-injected instead of
  lost.

Each reduces over a ``torch.distributed`` process group with
``all_reduce``: a CUDA tensor over an NCCL group, a CPU tensor over gloo
(the group's backend decides; nothing falls back from one to the other).
The reference's ``axis_name`` is the group here.

Below them, the collectives of the model's sharded forms (decode-SP, the
MoE block's expert-parallel forms, the aux loss over the batch ranks) and
of the sharded step: :func:`all_reduce`, :func:`all_gather` and
:func:`reduce_scatter` on plain tensors, and four autograd forms whose
backward is stated — the reference gets them from ``shard_map``'s
transposes:

* :func:`sum_replicated` — all-reduce forward, the gradient handed on as
  it is: partial sums that every rank then uses alike (Megatron's *g*);
* :func:`enter_partial` — the identity forward, its gradient all-reduced: a
  value every rank holds alike, which each then uses differently (*f*);
* :func:`sum_partial` — all-reduce forward and backward: a sum that each
  rank then uses differently;
* :func:`gather_partial` — all-gather forward, reduce-scatter backward.

Every call reports its wire bytes to an active roofline count
(``roofline.analysis.record_collective``), by the group's size.  Over a
group of one rank the sharded forms' collectives move nothing and return
their input (an all-gather or reduce-scatter of one part is that part):
no call is made.  The compressed reductions above always call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.roofline.analysis import record_collective


def group_size(group) -> int:
    return dist.get_world_size(group)


def _reduce_op(op: str):
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]


def psum_bf16(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce in bf16, the sum returned in float32."""
    y = x.to(torch.bfloat16)
    _all_reduce(y, group)
    return y.float()


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``scale = max(max|x|, 1e-12) / 127`` (float32, 0-d),
    ``q = clip(round(x / scale), ±127)`` as int8, ties rounded to even as
    ``jnp.round`` does."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def psum_int8_ef(x: torch.Tensor, residual: torch.Tensor, group=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce: returns (reduced, new_residual).

    The residual (same shape as x) carries this step's quantization error
    into the next step's gradient.  As in the reference, the sum itself is
    of the dequantized float32 values (an int8 sum would overflow).
    """
    comp = x + residual
    q, scale = quantize_int8(comp)
    deq = dequantize_int8(q, scale)
    new_residual = comp - deq
    _all_reduce(deq, group)
    return deq, new_residual


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def tree_psum_compressed(grads, residuals, group=None, mode: str = "bf16"):
    """Leaf-wise reduction of a gradient tree (nested dicts of tensors):
    ``(reduced, residuals)``.  ``"none"`` reduces each leaf in place (the
    float32 sum), ``"bf16"`` through :func:`psum_bf16`, ``"int8_ef"``
    through :func:`psum_int8_ef` with ``residuals`` (a tree like
    ``grads``), whose new values it returns."""
    if mode == "none":
        def exact(g):
            return _all_reduce(g, group)
        return _map(exact, grads), residuals
    if mode == "bf16":
        return _map(lambda g: psum_bf16(g, group), grads), residuals
    if mode == "int8_ef":
        out = _zip_map(lambda g, r: psum_int8_ef(g, r, group), grads, residuals)
        return _map(lambda pair: pair[0], out), _map(lambda pair: pair[1], out)
    raise ValueError(f"unknown compression mode {mode!r}")


def _all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``dist.all_reduce`` in place, reported (called over any group)."""
    record_collective("all-reduce", x.numel() * x.element_size(), group_size(group))
    dist.all_reduce(x, op=_reduce_op(op), group=group)
    return x


# ------------------------------------------------ the sharded forms' collectives
def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` in place (``"sum"`` or ``"max"``), returned."""
    return x if group_size(group) == 1 else _all_reduce(x, group, op)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (the
    reference's ``lax.all_gather(..., tiled=True)``)."""
    n = group_size(group)
    x = x.contiguous()
    if n == 1:
        return x
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    record_collective("all-gather", out.numel() * out.element_size(), n)
    dist.all_gather_into_tensor(out, x, group=group)
    if dim == 0:
        return out
    return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim=dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` summed over ``group``, this rank's part along ``dim`` (the
    reference's ``lax.psum_scatter(..., tiled=True)``)."""
    n = group_size(group)
    if n == 1:
        return x
    parts = torch.cat(x.chunk(n, dim=dim), dim=0) if dim else x.contiguous()
    out = parts.new_empty((parts.shape[0] // n,) + tuple(parts.shape[1:]))
    record_collective("reduce-scatter", out.numel() * out.element_size(), n)
    dist.reduce_scatter_tensor(out, parts.contiguous(), group=group)
    return out


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _SumPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group, ctx.dim), None, None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's partial ``x``, which every rank
    then uses alike: its gradient is handed to each rank once (an autograd
    all-reduce would hand on the group's sum of equal gradients)."""
    if _needs_grad(x):
        return _SumReplicated.apply(x, group)
    return all_reduce(x.clone(), group)


def enter_partial(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (alike on every rank of ``group``), which each rank then uses
    differently: its gradient is the sum of the ranks' gradients."""
    if _needs_grad(x):
        return _EnterPartial.apply(x, group)
    return x


def sum_partial(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's partial ``x``, which each rank
    then uses differently: the gradient is summed over the group too."""
    if _needs_grad(x):
        return _SumPartial.apply(x, group)
    return all_reduce(x.clone(), group)


def gather_partial(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, which each rank then uses
    differently: the gradient of each rank's part is the group's sum
    (a reduce-scatter)."""
    if _needs_grad(x):
        return _GatherPartial.apply(x, group, dim)
    return all_gather(x, group, dim)
