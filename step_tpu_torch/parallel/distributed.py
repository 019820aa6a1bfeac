"""Process bootstrap, the per-process slice of a dataset, the rank's batch
on its card, and the collectives the parallel paths share.

Port of `step_tpu/parallel/distributed.py`. A process that runs under
`torchrun` (or with `MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE` and
`LOCAL_RANK` set by hand) joins the process group; a single process with
none of them set stays alone, and every helper degrades to the local path,
as the JAX package's do (`distributed.py:11-13`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def default_backend() -> str:
    """gloo for host tensors, and NCCL for CUDA tensors where there is a
    card: the paths issue their host-side collectives (a preemption flag,
    gathered detections) on CPU tensors."""
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group → (process_index, process_count).

    The arguments default from torchrun's environment: `MASTER_ADDR` and
    `MASTER_PORT` for the coordinator (`host:port`), `WORLD_SIZE` and
    `RANK`. Where there is a card, the process takes `cuda:LOCAL_RANK`.
    With no coordinator the process stays alone and gets (0, 1); a group
    that exists already is kept. `backend` defaults to `default_backend()`.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if torch.cuda.is_available():
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id or 0))
                              % torch.cuda.device_count())
    if coordinator_address is None:
        return 0, 1
    dist.init_process_group(backend or default_backend(),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes if num_processes is not None else 1,
                            rank=process_id or 0)
    return dist.get_rank(), dist.get_world_size()


def process_shard(n: int, process_count: int, process_index: int) -> np.ndarray:
    """The process's strided slice of range(n), cut so that every process
    gets the same count (a shorter process would wait forever in the next
    collective)."""
    per = n // process_count
    idx = np.arange(n)
    return idx[process_index::process_count][:per]


def make_global_batch(local_batch: dict, mesh) -> dict:
    """The rank's rows of the global batch (its loader's batch) as tensors
    on the rank's device (`mesh_device(mesh)`); other leaves ("meta") pass
    through."""
    from step_tpu_torch.parallel.mesh import mesh_device

    device = mesh_device(mesh)

    def put(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(device)
        return x.to(device) if torch.is_tensor(x) else x

    return {k: put(v) for k, v in local_batch.items()}


def shard_rows(n: int, world: int, rank: int) -> slice:
    """The rank's rows of a batch of `n` (a multiple of `world`) in sharded
    evaluation: the rank-th of `world` equal blocks, as GSPMD places a
    batch-sharded array."""
    if n % world:
        raise ValueError(f"batch {n} does not divide over {world} ranks; pad it "
                         "with pad_batch_to")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group's ranks, differentiable: the gradient of each
    rank's input is the sum of every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over `group`'s ranks, under autograd."""
    return _AllReduceSum.apply(x, group)


def host_all_reduce(values, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A float64 CPU tensor of `values` reduced over `group` through its
    host backend (gloo): no sync with the card."""
    t = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_tensors(tensors, group, src_rank: int = 0) -> None:
    """Overwrite `tensors` (in place) with the group's rank `src_rank`'s."""
    src = dist.get_global_rank(group, src_rank)
    for t in tensors:
        dist.broadcast(t, src=src, group=group)
