"""Data parallelism over torch.distributed — the port's counterpart of the
JAX package's `parallel/mesh.py` (the `data` axis of the mesh) and
`parallel/collectives.py` (its explicit specification: per-shard
gradients, their mean across the axis, BatchNorm statistics averaged over
it, metrics summed over it).

One process drives one card. torchrun starts the processes and sets
`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`;
`process_group` reads them and brings the group up over NCCL on
`cuda:LOCAL_RANK`, or over gloo when the caller runs on the CPU (never
gloo on the card). A process that torchrun did not start (no
`WORLD_SIZE`) runs without a group: world size 1, nothing exchanged.

- The gradient mean is `DistributedDataParallel`'s all-reduce (`wrap`),
  with `broadcast_buffers=False`: the BN statistics are already global and
  equal on every rank (`models/batchnorm.py`), so a per-forward broadcast
  of the buffers would be a collective that computes nothing.
- Every rank holds the same number of samples a step (the loader pads each
  rank's shard to whole batches), so the mean of the ranks' means is the
  global batch's mean.
- `sum_across` sums a tensor of counts (or of per-rank means, divided
  afterwards) across the ranks: the train step's loss and top-k counts,
  the eval's sums.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn


def env_world() -> Tuple[int, int, int]:
    """(rank, world size, local rank) as torchrun sets them; (0, 1, 0)
    in a process it did not start."""
    env = os.environ
    return (int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1)),
            int(env.get("LOCAL_RANK", 0)))


def launched() -> bool:
    """Whether torchrun (or a caller setting its variables) started this
    process: then it joins a process group, even a world of one."""
    return "WORLD_SIZE" in os.environ


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_primary() -> bool:
    """Rank 0: the one rank that prints and writes records and
    checkpoints."""
    return rank() == 0


def backend() -> str:
    """The group's backend (nccl, gloo), or "off" without a group."""
    return dist.get_backend() if initialized() else "off"


def group() -> Optional[dist.ProcessGroup]:
    """The world group when one is up (the ResNet BNs' group), else None."""
    return dist.group.WORLD if initialized() else None


def barrier() -> None:
    if initialized():
        dist.barrier()


def agree(value) -> bool:
    """Whether every rank holds the same (picklable) `value`."""
    if not initialized():
        return True
    got = [None] * world_size()
    dist.all_gather_object(got, value)
    return all(g == value for g in got)


def local_device(device: torch.device) -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK` for a CUDA `device` in a
    process torchrun started, else `device`."""
    if device.type == "cuda" and launched():
        return torch.device("cuda", env_world()[2])
    return device


@contextlib.contextmanager
def process_group(device: torch.device) -> Iterator[torch.device]:
    """Within the block this process is in torchrun's group (when torchrun
    started it: NCCL on its own card, made current, or gloo on the CPU)
    and the yielded device is its own; the group is torn down on the way
    out, whatever ends the block."""
    device = local_device(device)
    if not launched():
        yield device
        return
    rank_, world, _ = env_world()
    addr = os.environ.get("MASTER_ADDR", "localhost")
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{addr}:{os.environ['MASTER_PORT']}",
        rank=rank_, world_size=world, **kw)
    try:
        yield device
    finally:
        dist.destroy_process_group()


def wrap(model: nn.Module, device: torch.device) -> nn.Module:
    """`model` under DistributedDataParallel over the world group (the
    gradient all-reduce), with `broadcast_buffers=False`."""
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False)


def sum_across(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks, in place (`t` itself without a group)."""
    if initialized():
        dist.all_reduce(t)
    return t
