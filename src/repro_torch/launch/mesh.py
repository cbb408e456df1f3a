"""Mesh builders — the port of ``repro.launch.mesh``: a
``torch.distributed.device_mesh.DeviceMesh`` over the process group's ranks.

Both need the default process group to be initialised first (``torchrun``
plus ``torch.distributed.init_process_group``: NCCL for the card, gloo for
``device_type="cpu"``), and on the card each rank's device set
(``torch.cuda.set_device``).  They run on the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.kernels.common import resolve_device


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the process group's ranks
    (row-major: rank ``r`` at the coordinates of ``r`` in ``shape``)."""
    resolve_device(device_type)  # no card: raises, unless asked for the CPU
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def host_device_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """A ``(data, model)`` mesh over the process group's world, as
    ``(world // model_axis, model_axis)``; a model axis that does not divide
    the world (a world of one without a process group) raises."""
    resolve_device(device_type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"a model axis of {model_axis} does not divide the world of "
                         f"{world} process(es)")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group "
                           "first (torchrun sets its address)")
    return make_mesh((world // model_axis, model_axis), ("data", "model"), device_type)
