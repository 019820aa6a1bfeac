"""The device mesh: one "data" axis over the ranks of the process group.

Port of `step_tpu/parallel/mesh.py::create_mesh`. A rank is one process
with one card, so the mesh is `torch.distributed.device_mesh.DeviceMesh`
over the ranks, and its size is the world's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from step_tpu_torch.parallel.distributed import default_backend


def create_mesh(mesh_shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("data",), device_type: str = "cuda"):
    """A `DeviceMesh` of `mesh_shape` (default: every rank on one "data"
    axis) on `device_type` ranks (the card unless the caller asks for
    "cpu"). A process outside any group gets a one-rank group (gloo, and
    NCCL where there is a card) with no network, so a single process gets a
    one-rank mesh. A shape larger than the world is refused, as the JAX
    package refuses one larger than its device count; so is one smaller:
    a rank outside the mesh would have no work in its collectives."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the mesh runs on CUDA cards and none is available; "
                           "pass device_type='cpu' for a CPU mesh")
    if not dist.is_initialized():
        dist.init_process_group(default_backend(), store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    if mesh_shape is None:
        mesh_shape = (world,)
    n = math.prod(mesh_shape)
    if n > world:
        raise ValueError(f"mesh {tuple(mesh_shape)} needs {n} ranks, have {world}")
    if n < world:
        raise ValueError(f"mesh {tuple(mesh_shape)} covers {n} of {world} ranks; a "
                         "process-per-card mesh spans every rank")
    return init_device_mesh(device_type, tuple(mesh_shape),
                            mesh_dim_names=tuple(axis_names))


def mesh_device(mesh) -> torch.device:
    """This rank's device in `mesh`: its card (`cuda:LOCAL_RANK`, as
    `init_distributed` set it), or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_group(mesh):
    """(the "data" axis's process group, this rank's index on it, its size)."""
    return mesh.get_group(0), mesh.get_local_rank(0), mesh.size(0)
