"""Device meshes for distributed counting, on ``torch.distributed``.

A copy of the JAX package's ``launch/mesh.py`` over
``torch.distributed.device_mesh``: a mesh is a ``DeviceMesh`` whose
dimension names are the reference's axes, ``("data", "model")`` or
``("pod", "data", "model")``, and whose dimensions carry one process
group each (``mesh.get_group("data")``). Single pod: 16x16 = 256 ranks
(data, model); multi-pod: 2x16x16 = 512 (pod, data, model), the pod axis
carrying independent color-coding iterations.

Every rank of the default process group calls :func:`make_mesh` with the
same arguments, after ``torch.distributed.init_process_group``: NCCL on
the cards (the default device, ``"cuda"``), gloo with ``device="cpu"``.
Nothing here touches the process group at import.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_mesh", "MESH_AXES"]

# the axes DistributedPgbsc runs on (the reference asserts the same)
MESH_AXES = (("data", "model"), ("pod", "data", "model"))


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` over the default process group, its
    dimensions named ``axes``. ``device=None`` is CUDA (one card a rank;
    ``RuntimeError`` without one); ``"cpu"`` puts the mesh on gloo
    ranks."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if axes not in MESH_AXES:
        raise ValueError(f"mesh axes must be one of {MESH_AXES}, got {axes}")
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} does not match axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group (nccl on cards, gloo on "
            "the CPU) with this rank's rank and the world size first")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} has {math.prod(shape)} ranks, the "
                         f"process group {dist.get_world_size()}")
    dev = resolve_device(device)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, MESH_AXES[int(multi_pod)], device=device)
