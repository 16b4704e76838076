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
- Explicit pods (`cli/train.py --multihost`) do not come from torchrun:
  `parallel/fleet.py::initialize_with_retry` rendezvouses from the
  ``FLEET_*`` variables and brings the group up through `init_group`.
- `init_group` also makes the control plane's group: a second group over
  gloo on the same ranks, which carries the fleet's small host
  collectives (`parallel/fleet.py`) as CPU tensors, so they never
  interleave with NCCL's stream of gradients and BN statistics.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Callable, Iterator, Optional, Tuple

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


def local_device(device: torch.device) -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK` for a CUDA `device` in a
    process torchrun started, else `device`."""
    if device.type == "cuda" and launched():
        return torch.device("cuda", env_world()[2])
    return device


# the control plane's gloo group (`init_group`), None below two ranks
_CONTROL: Optional[dist.ProcessGroup] = None


def control_group() -> dist.ProcessGroup:
    """The gloo group the fleet's host collectives run on."""
    if _CONTROL is None:
        raise RuntimeError("no control group: the world has fewer than "
                           "two ranks")
    return _CONTROL


def init_group(device: torch.device, init_method: str, world: int,
               rank_: int, timeout_s: Optional[float] = None) -> None:
    """Join the world group at `init_method` (NCCL on the card, gloo on
    the CPU), then, over more than one rank, make the control plane's
    gloo group on the same ranks (a world of one exchanges nothing)."""
    global _CONTROL
    kw = {}
    if device.type == "cuda":
        kw["device_id"] = device
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init_method,
        rank=rank_, world_size=world, **kw)
    _CONTROL = dist.new_group(backend="gloo") if world > 1 else None


def shutdown() -> None:
    """Tear the groups down (a no-op without them)."""
    global _CONTROL
    if initialized():
        dist.destroy_process_group()
    _CONTROL = None


@contextlib.contextmanager
def process_group(device: torch.device,
                  rendezvous: Optional[Callable[[torch.device], None]] = None
                  ) -> Iterator[torch.device]:
    """Within the block this process is in its group and the yielded
    device is its own (its card made current); the group is torn down on
    the way out, whatever ends the block. The group is torchrun's, when
    torchrun started the process, or the one `rendezvous(device)` brings
    up through `init_group` (`--multihost`: the fleet's retrying
    rendezvous from the ``FLEET_*`` variables); else there is none."""
    device = local_device(device)
    if rendezvous is None and not launched():
        yield device
        return
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        if rendezvous is not None:
            rendezvous(device)
        else:
            rank_, world, _ = env_world()
            addr = os.environ.get("MASTER_ADDR", "localhost")
            init_group(device, f"tcp://{addr}:{os.environ['MASTER_PORT']}",
                       world, rank_)
        yield device
    finally:
        shutdown()


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
