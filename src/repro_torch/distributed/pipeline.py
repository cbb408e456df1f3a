"""GPipe pipeline parallelism over one mesh axis — the port of
``repro.distributed.pipeline``.

Each rank along ``axis`` is one stage and holds its slice of the stacked
stage parameters; ``n_microbatches`` microbatches stream through the stages
with the standard skew of ``n_stages - 1`` ticks.  At tick ``t`` stage
``s`` runs microbatch ``t - s`` (when there is one) and sends its output to
stage ``s + 1`` (``send`` / ``recv`` over the axis's process group); the
last stage's outputs, gathered over the ticks, are broadcast to every stage.
The reference's ring also runs the stages on zeros during the fill and
drain ticks and throws those results away; here a stage idles then, which
gives the same outputs.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.roofline.analysis import record_collective


def _stage_leaf(leaf, stage: int):
    """This stage's slice of a stacked leaf: a ``DTensor`` sharded on dim 0
    over the axis holds just this stage's; a plain tensor holds every
    stage's."""
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    return leaf[stage]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipeline_apply(
    fn: Callable,  # (stage_params, x) -> x  : one stage's layer stack
    mesh,
    n_microbatches: int,
    axis: str = "pod",
) -> Callable:
    """Wrap a per-stage function into a GPipe forward over ``axis`` of
    ``mesh`` (a ``DeviceMesh``).

    ``stage_params`` is stacked stage-major on dim 0 (a tensor or a dict
    tree of them); ``x`` is split on dim 0 into ``n_microbatches`` slices
    and every stage sees it whole (replicated over the axis).  The result,
    ``fn`` of every stage in turn on each microbatch, is on every rank.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))

    @torch.no_grad()
    def wrapped(stage_params, x):
        stage = mesh.get_local_rank(axis)
        group = mesh.get_group(axis)
        params = _map(lambda leaf: _stage_leaf(leaf, stage), stage_params)
        mb = x.reshape((n_microbatches, -1) + tuple(x.shape[1:]))
        out = torch.zeros_like(mb)
        inflight = None
        for t in range(n_microbatches + n_stages - 1):
            m = t - stage  # the microbatch this stage runs at tick t
            y = None
            if 0 <= m < n_microbatches:
                y = fn(params, mb[m] if stage == 0 else inflight)
                if stage == n_stages - 1:
                    out[m] = y
            # stage s + 1 takes at t + 1 what stage s made at t
            ops = []
            if y is not None and stage < n_stages - 1:
                record_collective("collective-permute", y.numel() * y.element_size(), 2)
                ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                      dist.get_global_rank(group, stage + 1), group))
            if stage > 0 and 0 <= t + 1 - stage < n_microbatches:
                inflight = torch.empty_like(mb[0])
                ops.append(dist.P2POp(dist.irecv, inflight,
                                      dist.get_global_rank(group, stage - 1), group))
            for req in dist.batch_isend_irecv(ops) if ops else ():
                req.wait()
        if n_stages > 1:
            # a broadcast moves the output once over each rank's link
            record_collective("collective-permute", out.numel() * out.element_size(), 2)
            dist.broadcast(out, src=dist.get_global_rank(group, n_stages - 1), group=group)
        return out.reshape((-1,) + tuple(out.shape[2:]))

    return wrapped
