"""Mesh builders — the port of ``repro.launch.mesh``: a
``torch.distributed.device_mesh.DeviceMesh`` over the process group's ranks.

``make_mesh`` and ``host_device_mesh`` need the default process group to
be initialised first (``torchrun`` plus
``torch.distributed.init_process_group``: NCCL for the card, gloo for
``device_type="cpu"``), and on the card each rank's device set
(``torch.cuda.set_device``).  They run on the card unless the caller asks
for the CPU.  ``make_production_mesh`` is the one builder that needs no
card: it places the production meshes over a fake process group, for the
dry run.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.kernels.common import resolve_device

PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


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


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks), the
    reference's shapes and axis names, over a *fake* process group
    (``torch.testing._internal.distributed.fake_pg``: this process is rank
    0 of 256 or 512, and every collective returns at once without moving
    data).  It needs no card and no other process — the counterpart of the
    reference's dry run on 512 placeholder host devices — and serves only
    a step on ``meta`` tensors, whose operations are counted, never run.
    The default process group must be absent or a fake one (replaced when
    its size differs); it is left initialised."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is initialised; the "
                               "production mesh needs a fake one")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)
