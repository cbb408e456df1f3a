"""Atomic checkpoint save/restore — the port of ``repro.ckpt.checkpoint``.

Layout: one ``.npy`` per tree leaf (path-encoded filename) plus a
``manifest.json`` carrying the step, the tree structure, and bookkeeping.
Writes go to ``<dir>.tmp`` and are published with an atomic ``os.replace`` —
a preempted writer never corrupts the latest checkpoint.

A tree is nested dicts, lists and tuples of tensors, numpy arrays or
scalars.  Its leaves are named and ordered as the reference names JAX's
pytree paths (dict keys sorted, sequence indices, joined by ``/``), and a
leaf is written as the reference writes it: numpy cannot hold bf16 or fp8,
so those go to disk as raw ``uint16`` / ``uint8`` bytes under the dtype
names ``"bfloat16"``, ``"float8_e4m3fn"``, ``"float8_e5m2"`` (torch's own
``view``; no ``ml_dtypes``).  The same tree gives the same file names,
``.npy`` bytes and manifest (apart from ``time``) in both packages, so a
checkpoint written by either restores in the other.  ``restore`` puts each
leaf on the device of ``like``'s leaf, in its dtype, or, given
``shardings`` (a tree like ``like`` of ``distributed.partitioning
.NamedSharding``), places it on that mesh as a ``DTensor``: the elastic
restore, onto whatever mesh the restart got.

In a process group a ``DTensor`` leaf is written as its full tensor: every
rank gathers it (the same leaves in the same order), rank 0 writes, and all
ranks meet at a barrier before ``save_checkpoint`` returns.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.partitioning import distribute
from repro_torch.kernels.common import resolve_device

# numpy can't hold bf16 and fp8; round-trip them as raw integer views:
# name -> (torch dtype, the integer dtype torch and numpy both view it as,
# the integer dtype written to disk)
_VIEW_DTYPES = {
    "bfloat16": (torch.bfloat16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, np.uint8),
}
_TORCH_INT = {np.int16: torch.int16, np.uint8: torch.uint8}


def _savable(leaf) -> tuple[np.ndarray, str]:
    """The array written for ``leaf`` and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in _VIEW_DTYPES:
            _, raw, disk = _VIEW_DTYPES[name]
            return t.view(_TORCH_INT[raw]).numpy().view(disk), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _restore_view(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy()  # keeps a 0-d array 0-d
    if dtype_name in _VIEW_DTYPES:
        dtype, raw, _ = _VIEW_DTYPES[dtype_name]
        return torch.from_numpy(arr.view(raw)).view(dtype)
    return torch.from_numpy(arr)


def _flatten(tree, prefix: tuple = ()):
    """``[(path, leaf)]`` in JAX's flatten order: dict keys sorted, sequence
    indices; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, sub in enumerate(tree) for kv in _flatten(sub, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(tree, leaves: dict, prefix: tuple = ()):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_unflatten(v, leaves, prefix + (str(i),)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return leaves["/".join(prefix)]


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the
    process itself outside one."""
    return not _in_group() or dist.get_rank() == 0


def save_checkpoint(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomically write ``tree`` under ``directory/step_<n>``; returns the path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    writer = _writer()
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    names = {}
    dtypes = {}
    for i, (key, leaf) in enumerate(sorted(_flatten(tree), key=lambda kv: kv[0])):
        if isinstance(leaf, DTensor):  # a collective: every rank, in this order
            leaf = leaf.full_tensor()
        if not writer:
            continue
        fname = f"leaf_{i:05d}.npy"
        arr, dtype_name = _savable(leaf)
        np.save(os.path.join(tmp, fname), arr)
        names[key] = fname
        dtypes[key] = dtype_name
    if writer:
        _publish(tmp, final, step, names, dtypes, extra)
    if _in_group():
        dist.barrier()
    return final


def _publish(tmp: str, final: str, step: int, names: dict, dtypes: dict,
             extra: dict | None) -> None:
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": names,
        "dtypes": dtypes,
        "extra": extra or {},
        "format": 1,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like, step: int | None = None,
                       shardings=None) -> tuple[int, object]:
    """Restore into the structure of ``like`` (a tree of tensors): each leaf
    in the dtype and on the device of ``like``'s leaf, or, with
    ``shardings``, a ``DTensor`` placed by the leaf's ``NamedSharding``.

    Missing checkpoints raise; structural mismatches raise with the offending
    path (a config change between runs is a hard error, not silent reuse).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like = dict(_flatten(like))
    if set(manifest["leaves"]) != set(leaves_like):
        missing = set(leaves_like) ^ set(manifest["leaves"])
        raise ValueError(f"checkpoint/model structure mismatch at {sorted(missing)[:5]}")
    placed = dict(_flatten(shardings)) if shardings is not None else {}
    if shardings is not None and set(placed) != set(leaves_like):
        raise ValueError("shardings do not match the checkpoint's tree at "
                         f"{sorted(set(placed) ^ set(leaves_like))[:5]}")
    restored = {}
    for key, want in leaves_like.items():
        arr = np.load(os.path.join(path, manifest["leaves"][key]))
        t = _restore_view(arr, manifest.get("dtypes", {}).get(key, str(arr.dtype)))
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(
                f"shape mismatch at {key}: ckpt {tuple(t.shape)} vs model {tuple(want.shape)}"
            )
        if shardings is None:
            restored[key] = t.to(device=want.device, dtype=want.dtype)
            continue
        sharding = placed[key]
        device = resolve_device(sharding.mesh.device_type)
        restored[key] = distribute(t.to(device=device, dtype=want.dtype), sharding)
    return step, _unflatten(like, restored)


class CheckpointManager:
    """Retention + cadence policy around save/restore."""

    def __init__(self, directory: str, keep: int = 3, every_steps: int = 100):
        self.directory = directory
        self.keep = keep
        self.every_steps = every_steps
        os.makedirs(directory, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every_steps == 0

    def save(self, step: int, tree, extra: dict | None = None) -> str:
        path = save_checkpoint(self.directory, step, tree, extra)
        if _writer():
            self._gc()
        return path

    def restore(self, like, shardings=None):
        return restore_checkpoint(self.directory, like, shardings=shardings)

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))
