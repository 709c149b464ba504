"""Multi-process runtime on torch.distributed (port of
hlod_gaussians_tpu/parallel/distributed.py:34-93).

The reference's multi-GPU story is a SLURM job a chunk with `sacct`
polling and a filesystem hand-off (scripts/full_train.py:79-236). The JAX
package makes it one SPMD program over a process-spanning mesh; here it is
one torch.distributed world:

  * every process calls :func:`initialize` (``env://`` by default, as
    ``torchrun`` sets it; NCCL for a CUDA rank, Gloo on the CPU);
  * :func:`make_global_mesh` lays the world onto a ``(data, gauss)``
    DeviceMesh, rank-major, so a ``data`` slice is a block of whole ranks;
  * a rank's own views are its shard of the global batch
    (:func:`global_view_batch`); `data_parallel`'s step reduces across
    ranks itself, and `chunk_parallel`'s chunks need no traffic at all.

The collectives of this package go through :func:`all_reduce`,
:func:`all_gather` and :func:`broadcast`, which also serve a world of one
process without a process group.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

# one rank's failure ends the world within this time instead of hanging it
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT,
               device=torch.device("cuda")) -> None:
    """Join the torch.distributed world (idempotent).

    With no ``init_method`` the rendezvous is ``env://`` (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK, as torchrun sets them); a test rig
    passes e.g. ``file:///tmp/rdv``, the world size and its rank. The
    backend is NCCL when ``device`` is a CUDA device, else Gloo; a CUDA rank
    binds its device first."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=timeout)


def is_multi_process() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """All ranks meet (a no-op in a world of one process)."""
    if is_multi_process():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def make_global_mesh(n_data: Optional[int] = None, n_gauss: int = 1):
    """A ``(data, gauss)`` DeviceMesh over every rank of the world.

    Ranks are laid out rank-major (rank = data index * n_gauss + gauss
    index), so a ``data`` slice is a block of whole ranks and a rank's
    local batch is its own shard."""
    n = world_size()
    if n_data is None:
        n_data = n // n_gauss
    if n_data * n_gauss != n:
        raise ValueError(f"mesh ({n_data}, {n_gauss}) does not cover a "
                         f"world of {n}")
    from hlod_gaussians_torch.parallel.data_parallel import make_mesh
    return make_mesh(n_data, n_gauss)


def global_view_batch(mesh, local_arrays,
                      device=torch.device("cuda")) -> torch.Tensor:
    """A rank's own views [B_local, ...] as its shard of the global batch
    (each SLURM job reading its own chunk's images): on a torch.distributed
    world the shard IS the local tensor, so this only places it on the
    rank's device. ``mesh`` is unused and kept for the JAX signature."""
    del mesh
    return torch.as_tensor(local_arrays, device=device)


def replicate(mesh, x, device=torch.device("cuda")) -> torch.Tensor:
    """Rank 0's ``x`` on every rank (a broadcast over the world, which
    every mesh of this package spans)."""
    del mesh
    return broadcast(torch.as_tensor(x, device=device).clone(), src=0)


def process_chunk_assignment(n_chunks: int) -> List[int]:
    """The chunk indices this rank trains: a block partition, ceil(n /
    world) chunks a rank (the reference's job array,
    scripts/full_train.py:161-214)."""
    p, n = rank(), world_size()
    per = -(-n_chunks // n)
    return list(range(p * per, min((p + 1) * per, n_chunks)))


# ---- collectives -------------------------------------------------------
# Gloo's allreduce, allgather and broadcast take CUDA tensors, so a Gloo
# world whose ranks share one card reduces card tensors directly; no
# compute leaves the card.

def _group_size(group) -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` ("sum" or "max"); a
    group of one leaves it as it is. Returns ``t``."""
    if _group_size(group) > 1:
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes) in group-rank order."""
    n = _group_size(group)
    if n == 1:
        return [t]
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In place: ``t`` takes the value of group rank ``src``'s."""
    if _group_size(group) > 1:
        dist.broadcast(t, src=dist.get_global_rank(group, src)
                       if group is not None else src, group=group)
    return t
