"""Three-term roofline on H100 figures, from the operations the port counts
as it runs — the port of ``repro.roofline.analysis``.

    compute term    = FLOPs      / peak FLOP/s
    memory term     = HBM bytes  / HBM rate
    collective term = wire bytes / link rate

All three numerators are one rank's counts (every rank of an SPMD step runs
the same program on its own share), over one card's rates.

The reference parses the optimized HLO of a compiled step.  The port has no
HLO: eager PyTorch runs each operation as it comes, with no fusion and no
loop to weight by its trip count, so :func:`count_step` counts each one as
it runs, in three parts:

* a ``TorchDispatchMode`` (:class:`_CountMode`) sees every ATen operation
  below autograd — the backward's too — and counts

  - FLOPs: ``2 × |out| × contraction`` for every product (``mm``,
    ``addmm``, ``bmm``, ``baddbmm``, ``addbmm``, ``dot``, ``mv``); other
    operations are not counted (elementwise work is bound by bytes), as the
    reference's convention;
  - HBM bytes: operand plus output bytes of every operation except those
    that move no data (:data:`_NO_DATA_OPS`: views and reshapes, ``detach``,
    ``as_strided``, allocations that write nothing, scalar reads), the
    reference's ``_NO_DATA_OPS``.  With no fusion, every elementwise
    operation reads and writes memory: the count is what eager PyTorch
    moves, which is more than a fused program would;

* the hand-written kernels launch through ``ctypes`` and are invisible to a
  dispatch mode: each wrapper in ``kernels/_cuda.py`` reports its own
  operations and bytes (:func:`record_kernel`) by the work formulas below
  (:func:`flash_work`, :func:`flash_backward_work`, :func:`w8_work`,
  :func:`moe_work`, :func:`rglru_scan_work`), the same ones
  ``chip_smoke.py`` takes each kernel's bound from;

* collectives are reported by the port's own call sites
  (:func:`record_collective`: ``distributed/collectives.py``, the sharded
  step's reductions and DTensor redistributions, the decode-SP and MoE
  reductions), each by the ring model of :func:`wire_bytes` with the size
  of its group.

On a ``meta`` tensor (the dry run) nothing is computed: the operations
still dispatch, with their shapes, so they are counted; the kernel wrappers
return outputs of the right shape and report their work without running.

Not ported, on purpose: the HLO text parser (``hlo_stats``,
``_parse_module``, trip-count weighting, fusion bytes,
``compiled_hlo_text``) — there is no HLO — and XLA's ``memory_analysis``:
:func:`analyze_step` reports only what the port can count.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


# ----------------------------------------------------------- hardware model
@dataclasses.dataclass(frozen=True)
class Hardware:
    """One NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates)."""

    name: str = "h100-sxm"
    peak_flops: float = 989e12  # bf16 FLOP/s on the tensor cores
    fp32_flops: float = 67e12  # float32 FLOP/s outside the tensor cores
    hbm_bw: float = 3.35e12  # HBM3 bytes/s
    link_bw: float = 450e9  # NVLink bytes/s, one direction of the 900 GB/s total
    hbm_bytes: float = 80e9


HW = Hardware()

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def wire_bytes(kind: str, out_bytes: int, n: int) -> int:
    """One rank's wire bytes of a collective whose output is ``out_bytes``
    over a group of ``n`` ranks, by the ring model: all-gather and
    all-to-all ``out·(n−1)/n``, reduce-scatter ``out·(n−1)`` (its output is
    the scattered part), all-reduce ``2·out·(n−1)/n``; a point-to-point copy
    (``collective-permute``) ``out``; nothing over a group of one."""
    if kind == "collective-permute":
        return out_bytes
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    if n <= 1:
        return 0
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind == "all-reduce":
        return 2 * out_bytes * (n - 1) // n
    return out_bytes * (n - 1) // n


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    hw: Hardware = HW,
) -> dict[str, float]:
    return {
        "compute": flops_per_device / hw.peak_flops,
        "memory": bytes_per_device / hw.hbm_bw,
        "collective": collective_bytes_per_device / hw.link_bw,
    }


# ------------------------------------------------- the kernels' work formulas
def ops_rate(elem_bytes: int, hw: Hardware = HW) -> float:
    """The rate of a kernel's operations on inputs of ``elem_bytes``: bf16
    on the tensor cores, float32 outside them."""
    return hw.peak_flops if elem_bytes == 2 else hw.fp32_flops


def bound_ms(ops: float, nbytes: float, elem_bytes: int, ties: str = "operations",
             hw: Hardware = HW) -> tuple[float, str]:
    """The least time of work of ``ops`` operations on ``elem_bytes`` inputs
    that moves ``nbytes``: the larger of the two times, in ms, and which it
    is (``ties`` names the winner of a tie)."""
    t_ops = ops / ops_rate(elem_bytes, hw)
    t_bytes = nbytes / hw.hbm_bw
    if t_ops == t_bytes:
        by = ties
    else:
        by = "operations" if t_ops > t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by


def flash_pairs(s: int, causal: bool, window: int | None) -> int:
    """Unmasked (query, key) pairs of one head."""
    w = s if window is None else window
    i = np.arange(s, dtype=np.int64)
    if causal:
        return int(np.minimum(i + 1, w).sum())
    return int((np.minimum(i + w - 1, s - 1) - np.maximum(i - w + 1, 0) + 1).sum())


def flash_work(b: int, s: int, h: int, kh: int, d: int, causal: bool,
               window: int | None, elem_bytes: int) -> tuple[int, int]:
    """The attention forward's least work: 4·B·H·D operations an unmasked
    pair (QK and PV, a multiply and an add each), Q, K, V and O moved once."""
    ops = 4 * b * h * d * flash_pairs(s, causal, window)
    nbytes = (2 * b * s * h * d + 2 * b * s * kh * d) * elem_bytes
    return ops, nbytes


# a flash backward does at least 5 products a pair (QK recomputed, dV, dP,
# dQ, dK) where the forward does 2: 2.5 times the forward's operations (the
# two-pass forms do 7: the bound is the least work, not the kernel's)
FLASH_BACKWARD_OPS = 2.5


def flash_backward_work(b: int, s: int, h: int, kh: int, d: int, causal: bool,
                        window: int | None, elem_bytes: int) -> tuple[int, int]:
    """The attention backward's least work: ``FLASH_BACKWARD_OPS`` times the
    forward's operations; q, k, v, out, dout and the float32 lse read once,
    dq, dk and dv written once."""
    ops, _ = flash_work(b, s, h, kh, d, causal, window, elem_bytes)
    nbytes = (5 * b * s * h * d + 4 * b * s * kh * d) * elem_bytes + 4 * b * h * s
    return int(FLASH_BACKWARD_OPS * ops), nbytes


def w8_work(m: int, k: int, ns, elem_bytes: int) -> tuple[int, int]:
    """``x (m, k) @ dequant(q (k, n), s)`` for each ``n`` of ``ns``, a group
    that shares x: 2·m·k·n operations a record; the int8 weights, the bf16
    scales, x (once) and the outputs moved once."""
    ops = sum(2 * m * k * n for n in ns)
    nbytes = sum(k * n + 2 * n + m * n * elem_bytes for n in ns) + m * k * elem_bytes
    return ops, nbytes


def moe_work(touched: int, e: int, cap: int, d: int, f: int, elem_bytes: int
             ) -> tuple[int, int]:
    """The expert FFN: the touched experts' kept rows' products (at most
    ``cap`` a touched expert, 6·d·f operations a row); the touched experts'
    three weights, the buffer and the output moved once."""
    ops = touched * cap * 6 * d * f
    nbytes = (touched * 3 * d * f + 2 * e * cap * d) * elem_bytes
    return ops, nbytes


def rglru_scan_work(b: int, s: int, w: int) -> tuple[int, int]:
    """The RG-LRU recurrence: a multiply and an add an element; a and x
    read once, h written once (float32)."""
    return 2 * b * s * w, 3 * b * s * w * 4


def rglru_scan_backward_work(b: int, s: int, w: int) -> tuple[int, int]:
    """The recurrence's gradient: the reverse scan and ``da = g · h_{t-1}``;
    a, h and dh read once, da and dx written once (float32)."""
    return 3 * b * s * w, 5 * b * s * w * 4


# ------------------------------------------------------------------ counter
@dataclasses.dataclass
class Counts:
    """What :func:`count_step` counted: product FLOPs, HBM bytes (ATen
    operations and kernel reports), collective wire bytes and calls by
    kind, ATen calls by operation, and each hand-written kernel's
    launches, operations and bytes."""

    flops: int = 0
    hbm_bytes: int = 0
    collectives: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    op_counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    aten: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict[str, Any]:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collectives": {**self.collectives, "total": sum(self.collectives.values())},
                "op_counts": dict(self.op_counts), "aten_calls": sum(self.aten.values()),
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


_ACTIVE: list[Counts] = []


def counting() -> bool:
    """Whether a :func:`count_step` is running (the wrappers report only then)."""
    return bool(_ACTIVE)


def record_kernel(name: str, flops: int, nbytes: int) -> None:
    """A hand-written kernel's launch: its operations and bytes."""
    for c in _ACTIVE:
        k = c.kernels.setdefault(name, {"launches": 0, "flops": 0, "bytes": 0})
        k["launches"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        c.flops += int(flops)
        c.hbm_bytes += int(nbytes)


def record_collective(kind: str, out_bytes: int, n: int) -> None:
    """A collective of ``kind`` whose output is ``out_bytes`` on this rank,
    over a group of ``n`` ranks."""
    for c in _ACTIVE:
        c.collectives[kind] += wire_bytes(kind, int(out_bytes), n)
        c.op_counts[kind] += 1


_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "addbmm", "dot", "vdot", "mv", "addmv",
             "_addmm_activation"}
# operations that move no data: allocations that write nothing, aliases and
# views (checked by the overload's schema too), scalar reads and metadata
_NO_DATA_OPS = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "detach_", "alias", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
    "as_strided", "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "slice", "select", "narrow", "split", "split_with_sizes",
    "unbind", "chunk", "diagonal", "unfold", "view_as", "_reshape_alias", "resize_",
    "set_", "is_same_size", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "record_stream", "_has_compatible_shallow_copy_type", "scalar_tensor",
}


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree of lists, tuples and dicts.  An explicit stack,
    not a recursive closure: a closure that refers to itself is a cycle,
    and the tensors it holds would live until the cyclic collector runs
    (tens of GB in a train step)."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def product_flops(name: str, args) -> int:
    """``2 × |out| × contraction`` of the product ``name`` on ``args``."""
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
    elif name in ("addmm", "baddbmm", "addbmm", "addmv", "_addmm_activation"):
        a, b = args[1], args[2]
    elif name in ("dot", "vdot"):
        return 2 * args[0].numel()
    elif name == "mv":
        return 2 * args[0].numel()
    else:
        return 0
    if name in ("addmv",):
        return 2 * a.numel()
    k = a.shape[-1]
    if name == "addbmm":
        return 2 * a.shape[0] * a.shape[1] * b.shape[2] * k
    out = 1
    for n in a.shape[:-1]:
        out *= n
    return 2 * out * b.shape[-1] * k


class _CountMode(TorchDispatchMode):
    """Counts every ATen operation's product FLOPs and bytes into ``counts``.
    An operation on a ``DTensor`` is left to its call site (its local
    operations and collectives are reported there); other namespaces
    (``c10d``, ``_c10d_functional``) are collectives, reported by their call
    sites."""

    def __init__(self, counts: Counts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        ins = _tensors((args, kwargs))
        if any(type(t) is not torch.Tensor and not isinstance(t, torch.nn.Parameter)
               for t in ins):
            return out
        name = func.overloadpacket.__name__
        c = self.counts
        c.aten[name] = c.aten.get(name, 0) + 1
        if name in _NO_DATA_OPS or func.is_view:
            return out
        if name in _PRODUCTS:
            c.flops += product_flops(name, args)
        c.hbm_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in _tensors(out))
        return out


def count_step(fn: Callable, *args, **kwargs) -> tuple[Any, dict[str, Any]]:
    """Run ``fn(*args, **kwargs)`` with every operation counted: ``(its
    result, {"flops", "hbm_bytes", "collectives", "op_counts", "aten_calls",
    "kernels", "seconds"})`` — product FLOPs, HBM bytes, collective wire
    bytes by kind (and ``total``) and calls by kind, ATen calls, each
    hand-written kernel's launches, operations and bytes, and the run's
    wall seconds (the count's own cost included)."""
    counts = Counts()
    _ACTIVE.append(counts)
    t0 = time.perf_counter()
    try:
        with _CountMode(counts):
            result = fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(counts)
    out = counts.as_dict()
    out["seconds"] = time.perf_counter() - t0
    return result, out


# ------------------------------------------------------------------ report
@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective: dict[str, Any]
    memory: dict[str, Any]
    model_flops: float  # 6·N·D (or 6·N_active·D) for the whole step
    kernels: dict[str, Any] | None = None
    status: str = "ok"

    def terms(self, hw: Hardware = HW) -> dict[str, float]:
        return roofline_terms(
            self.flops_per_device, self.bytes_per_device,
            self.collective.get("total", 0), hw,
        )

    def summary(self, hw: Hardware = HW) -> dict[str, Any]:
        t = self.terms(hw)
        dominant = max(t, key=t.get)
        useful = (
            self.model_flops / (self.flops_per_device * self.n_devices)
            if self.flops_per_device else 0.0
        )
        bound = max(t.values())
        return {
            **t,
            "dominant": dominant,
            "useful_flops_ratio": useful,
            "roofline_fraction": (t["compute"] / bound) if bound else 0.0,
            "step_time_lower_bound_s": bound,
        }


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree (a ``DTensor`` by its local part)."""
    total = 0
    for t in _tensors(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        total += _nbytes(local)
    return total


def analyze_step(counts: dict[str, Any], *, arch: str, shape: str, mesh_name: str,
                 n_devices: int, model_flops: float, state_bytes: int,
                 batch_bytes: int) -> CellResult:
    """A :class:`CellResult` from :func:`count_step`'s counts of one rank's
    step.  ``memory`` holds what the port can count: this rank's argument
    bytes (``state_bytes`` and ``batch_bytes``, by the specs), and
    ``peak_bytes`` null — a meta run allocates nothing, so no peak of live
    bytes is tracked; nothing stands in for XLA's ``memory_analysis``."""
    memory = {"argument_bytes": state_bytes + batch_bytes, "state_bytes": state_bytes,
              "batch_bytes": batch_bytes, "peak_bytes": None}
    return CellResult(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=float(counts["flops"]),
        bytes_per_device=float(counts["hbm_bytes"]),
        collective={**counts["collectives"], "op_counts": counts["op_counts"]},
        memory=memory, model_flops=model_flops, kernels=counts["kernels"],
    )
