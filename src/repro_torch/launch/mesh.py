"""Production mesh construction — the port of the reference's
`launch/mesh.py`.

A mesh is a `DeviceMesh` over the default process group, which the caller
initialises first (`torch.distributed.init_process_group`, e.g. from
torchrun's environment), one process per device.  It is built on the
card (`"cuda"`, NCCL) unless the caller passes `device_type="cpu"` (gloo,
as the CPU tests do).  The world size must equal the mesh's product: a
mesh is never shrunk to fit.
"""

from __future__ import annotations

import math


def _mesh(shape, axes, device_type: str):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device_type=\"cpu\" for a "
            "mesh of CPU processes (gloo)")
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialised process group of "
            f"{math.prod(shape)} ranks (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"the mesh {dict(zip(axes, shape))} has {math.prod(shape)} "
            f"devices but the process group has world size {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16).  Multi-pod: (pod=2, data=16,
    model=16); the leading axis carries only the data-parallel gradient
    reduction (or the pipeline's boundary activations)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Tiny mesh with the same axis names for distributed tests over 8
    ranks."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A mesh of any shape over the default process group (the 1 x 1 mesh
    of a single card, the (2, 2) mesh of a test)."""
    return _mesh(tuple(shape), tuple(axes), device_type)
