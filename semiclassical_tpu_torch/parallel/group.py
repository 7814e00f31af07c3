# coding: utf-8
"""A process group for one trajectory batch across devices: the port's
counterpart of the JAX package's `traj` mesh
(semiclassical_tpu.parallel.mesh).

The JAX package shards the ensemble over the devices of one program and
lets its reductions lower to `psum`s. The PyTorch idiom is one process per
device in a `torch.distributed` group (NCCL on CUDA devices, gloo on the
CPU), so here every rank draws the whole batch from the same generator,
keeps its own rows (`shard_rows`) and propagates them, and the batch sums
are added over the group at the end of every scan segment (`group_sum`).

Every collective of the port goes through this module: `group_sum` (the
one all-reduce, counted in `ALL_REDUCES`), `ring_shift` (the neighbour
exchange of the ring pair sum) and `barrier`. `None` in place of a group
means a single process everywhere; a group of one rank runs every
collective too.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch

__all__ = ["Group", "init_group", "destroy_group", "pad_to_multiple",
           "shard_rows", "group_sum", "ring_shift", "barrier", "is_leader",
           "world_of", "rank_path", "ALL_REDUCES"]

# the all-reduces `group_sum` has issued in this process (the launch
# counters of the kernels, for the collectives)
ALL_REDUCES = 0


@dataclass(frozen=True)
class Group:
    """This process's place in the group: its rank, the number of ranks
    and the device it propagates on."""

    rank: int
    world: int
    device: torch.device


def init_group(coordinator, num_processes, process_id, device="cuda",
               timeout=1800.0):
    """Join the group of `num_processes` processes as rank `process_id`
    and return its `Group`.

    `coordinator` is rank 0's `host:port` (a `tcp://` store), or any
    `torch.distributed` init URL (`file://...`, `env://`). The backend
    follows the device: NCCL for CUDA, one process per card, each on
    `cuda:{local rank}` (LOCAL_RANK when the launcher sets it, else the
    rank modulo the visible cards) unless the device names its index;
    gloo for the CPU. A CUDA device on a machine without one raises: the
    group never moves to the CPU. `timeout` (seconds) bounds every
    collective."""
    import torch.distributed as dist

    num_processes, process_id = int(num_processes), int(process_id)
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(
            f"a process group needs --num-processes >= 1 and 0 <= "
            f"--process-id < --num-processes, got {num_processes} and "
            f"{process_id}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a process group on 'cuda' was asked for, but CUDA is not "
                "available; pass device 'cpu' (--device cpu) for a gloo "
                "group on the CPU")
        if device.index is None:
            local = os.environ.get("LOCAL_RANK")
            local = (int(local) if local is not None
                     else process_id % torch.cuda.device_count())
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    init_method = (coordinator if "://" in coordinator
                   else f"tcp://{coordinator}")
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout),
        device_id=device if backend == "nccl" else None)
    return Group(rank=process_id, world=num_processes, device=device)


def destroy_group(group):
    """Leave the group (a no-op for None)."""
    import torch.distributed as dist

    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n."""
    return ((n + k - 1) // k) * k


def world_of(group):
    """The number of ranks (1 for a single process)."""
    return 1 if group is None else group.world


def is_leader(group):
    """True on the rank that writes results and logs progress (rank 0, or
    the single process)."""
    return group is None or group.rank == 0


def shard_rows(n, group):
    """(a, b): the rows a:b of a batch of n that this rank propagates. n
    must be a multiple of the group's size (`pad_to_multiple`)."""
    if group is None:
        return 0, n
    if n % group.world:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{group.world} ranks")
    n_loc = n // group.world
    return group.rank * n_loc, (group.rank + 1) * n_loc


def group_sum(tensors, group):
    """Each tensor of `tensors` summed over the group, as a list of
    tensors of the same dtypes and shapes: ONE all-reduce of their float64
    packing (complex tensors as their real and imaginary parts; integer
    and boolean tensors as exact float64 counts). The tensors of a single
    process come back as they are."""
    if group is None:
        return list(tensors)
    import torch.distributed as dist

    global ALL_REDUCES
    flat = [(torch.view_as_real(t.to(torch.complex128)) if t.is_complex()
             else t.to(torch.float64)).reshape(-1) for t in tensors]
    buf = torch.cat(flat)
    dist.all_reduce(buf)
    ALL_REDUCES += 1
    out, start = [], 0
    for t, f in zip(tensors, flat):
        part = buf[start:start + f.numel()]
        start += f.numel()
        if t.is_complex():
            part = torch.view_as_complex(part.reshape(-1, 2))
        out.append(part.reshape(t.shape).to(t.dtype))
    return out


def ring_shift(tensors, group):
    """Send each tensor one rank on around the ring and return the ones
    the previous rank sent (same dtypes and shapes), in one batch of
    point-to-point operations."""
    import torch.distributed as dist

    send = [torch.view_as_real(t) if t.is_complex() else t
            for t in (t.contiguous() for t in tensors)]
    recv = [torch.empty_like(t) for t in send]
    nxt = (group.rank + 1) % group.world
    prv = (group.rank - 1) % group.world
    ops = ([dist.P2POp(dist.isend, t, nxt) for t in send]
           + [dist.P2POp(dist.irecv, t, prv) for t in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [torch.view_as_complex(r) if t.is_complex() else r
            for t, r in zip(tensors, recv)]


def barrier(group):
    """Wait for every rank (a no-op for a single process)."""
    if group is not None:
        import torch.distributed as dist

        dist.barrier()


def rank_path(filename, rank):
    """`filename` with `.rank{rank}` before its extension: the file of one
    rank of a group or of an accumulation-mode process (`rank` None: the
    file itself; an empty name stays empty)."""
    if not filename or rank is None:
        return filename
    root, ext = os.path.splitext(filename)
    return f"{root}.rank{rank}{ext}"
