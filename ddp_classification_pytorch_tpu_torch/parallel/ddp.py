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
- Gradient accumulation runs the first K − 1 microbatches of a step under
  DDP's `no_sync()` (`train/steps.py::_microbatches`): one all-reduce a
  step, of the summed gradients (JAX's deferred reduction).
- The bf16 gradient wire (`parallel.grad_reduce_dtype`, JAX
  `steps.py:356-417`) is `bf16_wire_hook`, a comm hook of the port's own
  (torch's stock `bf16_compress_hook` refuses gloo), registered only over
  more than one rank: at world 1 the JAX wire is the identity, and a
  hook there would round the gradients.
- `sum_across` sums a tensor of counts (or of per-rank means, divided
  afterwards) across the ranks (or the ranks of a group: the data group
  under a model axis): the train step's loss and top-k counts, the
  eval's sums.
- Under a model axis (`parallel/mesh.py`) DDP, ZeRO-1 and the bf16 wire
  run over the data group only; `sum_model_partials` sums, over the
  model group, the gradients of the replicated parameters whose shards
  saw different tokens (a token-sharded ViT's, everything before its
  pool). The other replicated parameters saw the same values on every
  model rank and hold the whole gradient already.
- A pipelined ViT's stages (`ops/pipeline.py`, on the pipe group or, on
  a (data, model) mesh, the model group) hand DDP each block parameter's
  gradient once a backward (the schedule's `autograd.Function` returns
  the M microbatches' sum), so DDP and ZeRO-1 run over the data group as
  above. `sum_stage_partials` then sums over the stage group the
  gradients of the tensors that only stage 0 consumes (the patch
  embedding and the position table; the other stages' are zeros); the
  final LayerNorm, `fc`, the embedding and the margin take the
  republished outputs on every stage and hold the whole gradient.
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

from ..models.pipeline_vit import gpipe_vit


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


def bf16_wire_hook(group, bucket):
    """DDP comm hook of the bf16 wire (`group`, a process group or None
    for the world; `bucket`, a `dist.GradBucket`; unannotated, as DDP
    checks the annotations it finds): the f32 bucket cast to bf16, one
    all-reduce (sum) of the bf16 copy, divided by the world size in bf16
    and copied back into the f32 bucket — JAX's cast, bf16 `pmean`, cast
    back. Half the bytes of the f32 all-reduce; one bf16 rounding of each
    gradient (and of the sum, then exact at a power-of-two world)."""
    buf = bucket.buffer()
    world = dist.get_world_size(group)
    wire = buf.to(torch.bfloat16)
    fut = dist.all_reduce(wire, group=group, async_op=True).get_future()

    def back(f: torch.futures.Future) -> torch.Tensor:
        buf.copy_(f.value()[0].div_(world))
        return buf

    return fut.then(back)


def wrap(model: nn.Module, device: torch.device,
         grad_reduce_dtype: str = "float32",
         group: Optional[dist.ProcessGroup] = None) -> nn.Module:
    """`model` under DistributedDataParallel over `group` (the world by
    default; the data group under a model axis: the gradient
    all-reduce), with `broadcast_buffers=False`; with `grad_reduce_dtype`
    bfloat16 over more than one rank of it, the all-reduce goes through
    `bf16_wire_hook`."""
    from torch.nn.parallel import DistributedDataParallel

    net = DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False, process_group=group)
    ranks = dist.get_world_size(group) if group is not None else world_size()
    if grad_reduce_dtype == "bfloat16" and ranks > 1:
        net.register_comm_hook(group, bf16_wire_hook)
    return net


def sum_across(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
               ) -> torch.Tensor:
    """`t` summed over the ranks of `group` (the world by default), in
    place (`t` itself without a process group)."""
    if initialized():
        dist.all_reduce(t, group=group)
    return t


def sum_model_partials(model: nn.Module, mesh) -> None:
    """Sum over the model group, in place, the gradients of `model`'s
    token-sharded parameters (`models/vit.py::ViT.token_sharded_params`)
    — one all-reduce of their flattened gradients. A no-op without a
    model axis."""
    if mesh is None or mesh.mp <= 1:
        return
    _sum_grads([p.grad for m in model.modules()
                if hasattr(m, "token_sharded_params")
                for p in m.token_sharded_params() if p.grad is not None],
               mesh.model_group)


def _sum_grads(grads, group: dist.ProcessGroup) -> None:
    """`grads` summed over `group` in place: one all-reduce of their
    concatenation (nothing without a gradient)."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def sum_stage_partials(model: nn.Module) -> None:
    """Sum over the stage group, in place, the gradients of a pipelined
    ViT's stage-0 inputs (`patch`, `pos_embed`) — one all-reduce. A
    no-op without a pipelined ViT split over stages."""
    pipe = gpipe_vit(model)
    if pipe is None or pipe.group is None or dist.get_world_size(
            pipe.group) <= 1:
        return
    _sum_grads([p.grad for p in pipe.stage_inputs() if p.grad is not None],
               pipe.group)
