"""Logical axis rules — the port of ``repro.distributed.partitioning``.

Model code names array dimensions by *logical* axes (``batch``, ``heads``,
``embed``, ``mlp``, ``vocab``, ``expert``, ``kv_seq`` …); the launcher
installs a mapping from logical names to the axes of a
``torch.distributed.device_mesh.DeviceMesh`` — the single-pod ``(data,
model)`` mesh, the multi-pod ``(pod, data, model)`` mesh (``pod`` folded
into the batch axes) — and with no rules installed nothing is constrained.

A :class:`PartitionSpec` holds one entry a tensor dimension, as JAX's ``P``
does: ``None``, a mesh axis name, or a tuple of names.  :func:`placements`
turns a spec into DTensor placements (``Shard(d)`` on each mesh dimension
that tensor dimension ``d`` names, ``Replicate()`` on the rest) and
:func:`distribute` places a tensor that every rank holds whole by taking
this rank's slice — no communication.  Divisibility is checked per array,
as the reference's: a dimension that a mesh axis does not divide is left
whole, so every shard a spec names is even.

Parameters are named by the port's flat ``state_dict`` names:
``layers.{i}.mixer.wq`` (and ``.q`` / ``.s`` of an int8 record) stands for
the reference's stacked ``units/b{j}/mixer/wq`` with the stack dimension
dropped — the inverse of ``models.convert.params_from_reference``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_state = threading.local()

# Default rule sets for the production meshes, as the reference's.
SINGLE_POD_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("data",),
    "model": ("model",),  # generic TP dim for weight matrices
    "expert": ("model",),
    "expert_ff": ("data",),  # per-expert hidden dim: weights-stationary FSDP
    "heads": ("model",),
    "kv_heads": ("model",),  # dropped per-array when not divisible
    "mlp": ("model",),
    "vocab": ("model",),
    "kv_seq": ("model",),  # decode-time KV sequence sharding (SP)
    "fsdp": ("data",),  # weight-matrix sharding over the batch axes (ZeRO-3)
    "zero": ("data",),  # ZeRO-1 optimizer-state axis (non-FSDP leaves)
}
MULTI_POD_RULES = dict(SINGLE_POD_RULES, batch=("pod", "data"), fsdp=("pod", "data"))


class PartitionSpec(tuple):
    """One entry a tensor dimension: ``None`` (whole), a mesh axis name, or
    a tuple of names (the dimension split over all of them, the first
    major) — entry for entry what JAX's ``PartitionSpec`` holds."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def set_axis_rules(
    rules: Mapping[str, Sequence[str]] | None,
    mesh_shape: Mapping[str, int] | None = None,
    mesh=None,
) -> None:
    _state.rules = None if rules is None else {k: tuple(v) for k, v in rules.items()}
    _state.mesh_shape = dict(mesh_shape) if mesh_shape else {}
    _state.mesh = mesh


def current_rules() -> dict[str, tuple[str, ...]] | None:
    return getattr(_state, "rules", None)


def current_mesh_shape() -> dict[str, int]:
    return getattr(_state, "mesh_shape", {}) or {}


def current_mesh():
    """The ``DeviceMesh`` of the active rules (:func:`mesh_axis_rules`), or
    ``None`` — the counterpart of the reference's ``compat.set_mesh``: the
    sharded forms of the model take their process groups from it."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(
    rules: Mapping[str, Sequence[str]] | None,
    mesh_shape: Mapping[str, int] | None = None,
    mesh=None,
):
    prev = current_rules(), current_mesh_shape(), current_mesh()
    set_axis_rules(rules, mesh_shape, mesh)
    try:
        yield
    finally:
        set_axis_rules(*prev)


def rules_for_mesh(mesh) -> dict[str, tuple[str, ...]]:
    """The rule set for ``mesh``'s axis names (``mesh_dim_names``)."""
    names = set(mesh.mesh_dim_names)
    base = MULTI_POD_RULES if "pod" in names else SINGLE_POD_RULES
    return {k: tuple(a for a in v if a in names) for k, v in base.items()}


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_axis_rules(mesh):
    """``axis_rules`` for ``mesh``: its rule set and its axis sizes, and
    ``mesh`` itself as :func:`current_mesh`."""
    return axis_rules(rules_for_mesh(mesh), mesh_shape(mesh), mesh)


def _axes(axes: str | Sequence[str]) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(mesh, axes: str | Sequence[str]) -> int:
    """This rank's row-major index over the mesh axes ``axes`` (the first
    major) — the reference's ``lax.axis_index(axes)``; 0 over no axes."""
    index = 0
    for a in _axes(axes):
        index = index * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
    return index


def axis_group(mesh, axes: str | Sequence[str]):
    """The process group of this rank over the mesh axes ``axes``, ranks in
    :func:`axis_index` order: one axis's own group, or for several (the
    multi-pod ``("pod", "data")``) the group of their flattened sub-mesh —
    where the reference names the axes of ``lax.psum``."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten("_".join(axes)).get_group()


def axis_size(mesh, axes: str | Sequence[str]) -> int:
    """The number of ranks over the mesh axes ``axes``."""
    n = 1
    for a in _axes(axes):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def _axes_size(phys: Sequence[str]) -> int:
    sizes = current_mesh_shape()
    total = 1
    for a in phys:
        total *= sizes.get(a, 1)
    return total


def logical_spec(*names: str | None, shape: Sequence[int] | None = None) -> PartitionSpec:
    """Translate logical axis names to a PartitionSpec under the active rules.

    A mesh axis is used at most once per spec (first logical name wins):
    e.g. a KV cache (batch, kv_heads, kv_seq, d) with both ``kv_heads`` and
    ``kv_seq`` mapping to ``model`` shards heads when divisible and falls
    back to sequence sharding for narrow-KV GQA.  An entry whose axes do not
    divide ``shape`` is dropped.
    """
    rules = current_rules()
    if rules is None:
        return P()
    out = []
    used: set[str] = set()
    for d, n in enumerate(names):
        phys = rules.get(n) if n is not None else None
        if phys:
            phys = tuple(a for a in phys if a not in used)
        if not phys:
            out.append(None)
            continue
        if shape is not None and shape[d] % max(_axes_size(phys), 1) != 0:
            out.append(None)
            continue
        used.update(phys)
        out.append(phys if len(phys) > 1 else phys[0])
    return P(*out)


def lsc(x, *names: str | None):
    """Logical sharding constraint: a ``DTensor`` redistributed to the spec
    of ``names``; a plain tensor, or any tensor with no rules active, is
    returned as it is."""
    if current_rules() is None or not isinstance(x, DTensor):
        return x
    spec = logical_spec(*names, shape=x.shape)
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


# --------------------------------------------------------------- parameters
_COL_NAMES = ("wq", "w_in", "w_gate", "w_up", "w_x", "w_a", "w_branch",
              "w_bcdt", "w_zx")
# KV projections are deliberately NOT column-sharded: with GQA KV narrower
# than the model axis, sharding k·hd columns forces an all-gather of K/V
# activations every layer.  The matrices are small — FSDP row-sharding alone
# holds the memory — and replicated columns mean every device computes its
# full K/V locally.
_KV_NAMES = ("wk", "wv")
_ROW_NAMES = ("wo", "w_out", "w_down")


def _path(name: str) -> tuple[str, ...]:
    """The reference's path inside one layer for a port name: the
    ``layers.{i}`` / ``enc_layers.{i}`` prefix dropped (a stacked unit's
    stack dimension and block are not in the port's leaf)."""
    parts = tuple(name.split("."))
    if parts[0] in ("layers", "enc_layers") and len(parts) > 2:
        return parts[2:]
    return parts


def param_partition_spec(name: str, shape: Sequence[int]) -> PartitionSpec:
    """Partition spec for the parameter ``name`` (a ``state_dict`` name) of
    ``shape``: TP over ``model`` + FSDP over the batch axes (``fsdp``
    rule), the reference's table:

      token_embedding      (vocab, embed)        -> (vocab, fsdp)
      lm_head              (embed, vocab)        -> (fsdp, vocab)
      q/k/v/in/gate/up w   (embed, tp-dim)       -> (fsdp, model)
      out/down w           (tp-dim, embed)       -> (model, fsdp)
      expert tensors       (expert, in, out)     -> (expert, fsdp, None)
      int8 records .q/.s                         -> TP only
      biases / norm scales / conv kernels        -> replicated
    """
    rules = current_rules()
    if rules is None:
        return P()
    shape = tuple(shape)
    path = _path(name)
    leaf = path[-1]
    joined = "/".join(path)

    def ok(dim: int, logical: str, used: set | None = None) -> Any:
        phys = rules.get(logical)
        if phys and used:
            phys = tuple(a for a in phys if a not in used)
        if phys and shape[dim] % max(_axes_size(phys), 1) == 0:
            if used is not None:
                used.update(phys)
            return phys if len(phys) > 1 else phys[0]
        return None

    if "token_embedding" in leaf and len(shape) == 2:
        used: set[str] = set()
        v = ok(0, "vocab", used)
        return P(v, ok(1, "fsdp", used))
    if leaf == "lm_head" and len(shape) == 2:
        used = set()
        v = ok(1, "vocab", used)
        return P(ok(0, "fsdp", used), v)
    if "expert" in joined and len(shape) == 3:
        used = set()
        e = ok(0, "expert", used)
        return P(e, ok(1, "fsdp", used), None)
    # int8-quantized serving weights {"q","s"}: TP-only, never FSDP
    if leaf in ("q", "s") and len(path) >= 2:
        wname = path[-2]
        if leaf == "s" or len(shape) == 2:
            if wname in _ROW_NAMES and leaf == "q":
                return P(ok(0, "model", set()), None)
            if wname in _ROW_NAMES:  # row-weight scale: out dim is d_model
                return P(None, None)
            if wname in _KV_NAMES:
                return P(None, None)
            return P(None, ok(1, "model", set()))
        return P(*([None] * len(shape)))
    if len(shape) == 2:
        if leaf in _KV_NAMES:
            return P(ok(0, "fsdp", set()), None)
        if any(leaf == c or leaf.startswith(c) for c in _COL_NAMES):
            used = set()
            m = ok(1, "model", used)
            return P(ok(0, "fsdp", used), m)
        if any(leaf == r or leaf.startswith(r) for r in _ROW_NAMES):
            used = set()
            m = ok(0, "model", used)
            return P(m, ok(1, "fsdp", used))
    return P(*([None] * len(shape)))


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def params_partition_specs(params: Mapping[str, Any]) -> dict[str, PartitionSpec]:
    """``{name: spec}`` for a flat parameter dict (tensors, or shapes)."""
    return {k: param_partition_spec(k, _shape(v)) for k, v in params.items()}


# ------------------------------------------------------------------ placing
def placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` — the counterpart of the
    reference's ``named_sharding``: ``Shard(d)`` on each mesh dimension that tensor
    dimension ``d`` names, ``Replicate()`` on the rest.  A dimension split
    over several axes names them in mesh order (the first major), as
    DTensor nests them."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec {spec}: axes {axes} not in the order of mesh {names}")
        for m in where:
            out[m] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where each rank's slice of a tensor lies."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def local_slices(shape: Sequence[int], mesh, place: Sequence) -> tuple[slice, ...]:
    """This rank's slice of a tensor of ``shape`` under ``place`` (one
    placement a mesh dimension).  A dimension split over several mesh
    dimensions is split by the first, then each part by the next
    (DTensor's order).  An uneven split raises: every spec of this module
    names only dimensions its axes divide."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    parts = [1] * len(shape)
    index = [0] * len(shape)
    for m, p in enumerate(place):
        if isinstance(p, Shard):
            size = mesh.size(m)
            index[p.dim] = index[p.dim] * size + coord[m]
            parts[p.dim] *= size
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} is neither Shard nor Replicate")
    out = []
    for d, n in enumerate(parts):
        if shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not split in {n}")
        step = shape[d] // n
        out.append(slice(index[d] * step, (index[d] + 1) * step))
    return tuple(out)


def local_view(full: torch.Tensor, mesh, place: Sequence) -> torch.Tensor:
    """This rank's part of ``full`` under ``place``: a view, no copy."""
    return full[local_slices(full.shape, mesh, place)]


def distribute(full: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """A ``DTensor`` placed by ``sharding`` from ``full``, which every rank
    holds whole: each rank keeps its own slice, a contiguous copy (the
    tensor itself where the slice is all of it); no communication."""
    place = sharding.placements
    local = local_view(full, sharding.mesh, place)
    if local.numel() != full.numel():
        local = local.clone(memory_format=torch.contiguous_format)
    return from_local(local, sharding.mesh, place, full.shape)


def from_local(local: torch.Tensor, mesh, place: Sequence, shape: Sequence[int]) -> DTensor:
    """The ``DTensor`` of global ``shape`` (row-major) whose part on this
    rank is ``local``; every rank's part is of the even size
    :func:`local_slices` gives, so nothing is exchanged to learn it."""
    stride, step = [], 1
    for n in reversed(tuple(shape)):
        stride.append(step)
        step *= n
    return DTensor.from_local(local, mesh, tuple(place), run_check=False,
                              shape=torch.Size(shape), stride=tuple(reversed(stride)))
