"""The model axis's collectives over a process group — what `shard_map`
gives the JAX package for free (`jax.lax.axis_index`, `psum`, `pmax`,
`all_gather`, `ppermute`), each with the autograd rule the port's layout
needs. Nothing else in the port talks to torch.distributed for the model
axis. They run over NCCL on the card and gloo on the CPU, whichever
backend the group has; a group of None (or of one rank) is the one-shard
axis, where each is the identity.

The port's rule for gradients along the model axis: every model rank
holds the whole loss (its value is replicated over the group), so a
value that is replicated before a collective has the same cotangent on
every rank. Hence

- `psum` (a partial sum → the replicated total): all-reduce forward,
  identity backward — each rank's partial receives the total's cotangent
  (Megatron's "g");
- `copy_to` (a replicated value entering a sharded computation): identity
  forward, all-reduce backward — the shards' partial cotangents summed
  into the replicated input's (Megatron's "f"; JAX's transpose of an
  unmapped shard_map input);
- `all_gather` (shards → the replicated whole): its backward takes this
  rank's slice of the whole's cotangent;
- `psum_batch` (the batch axis's sum, whose ranks each hold their own
  loss and whose gradients DDP averages): all-reduce both ways, so the
  average over the batch group gives the global batch's gradient;
- `pmax` carries no gradient (JAX's `stop_gradient` before its `pmax`);
- `ppermute` is a plain exchange (torch's point-to-point ops have no
  gradient): the ring's own `autograd.Function` runs its backward ring;
- `hop` is the GPipe stages' one-way exchange (JAX's `ppermute` with
  perm i → i + 1, which does not wrap), and with `reverse` the backward's
  i → i − 1; the pipeline's own `autograd.Function` runs its backward
  ticks over it. The pipeline's republish of the last stage's outputs is
  `psum` (forward sum, identity backward): every stage's loss is the
  whole loss, so the last stage's outputs take the total's cotangent
  once.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def axis_size(group: Group) -> int:
    """The number of shards on the axis (1 without a group)."""
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group: Group) -> int:
    """This rank's index on the axis (`jax.lax.axis_index`)."""
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group: Group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _PsumBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.index, ctx.size = axis_index(group), x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(axis_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Σ over the axis; the gradient passes through unchanged."""
    return x if axis_size(group) == 1 else _Psum.apply(x, group)


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    """`x` as it is; its gradient summed over the axis."""
    return x if axis_size(group) == 1 else _CopyTo.apply(x, group)


def psum_batch(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Σ over the batch axis; the gradient summed over it too."""
    return x if axis_size(group) == 1 else _PsumBatch.apply(x, group)


def pmax(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise max over the axis, detached."""
    x = x.detach()
    if axis_size(group) == 1:
        return x
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The shards concatenated along `dim` in axis order; the gradient is
    this rank's slice of the whole's."""
    if axis_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim % x.dim())


def ppermute(tensors: Sequence[torch.Tensor], group: Group
             ) -> List[torch.Tensor]:
    """Each tensor sent to the next rank along the axis, and the previous
    rank's received (`jax.lax.ppermute` with perm i → i + 1, the ring's);
    no gradient."""
    n = axis_size(group)
    if n == 1:
        return list(tensors)
    me = axis_index(group)
    dst = dist.get_global_rank(group, (me + 1) % n)
    src = dist.get_global_rank(group, (me - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group))
        ops.append(dist.P2POp(dist.irecv, o, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def hop(t: Optional[torch.Tensor], like: Optional[torch.Tensor],
        group: Group, reverse: bool = False) -> Optional[torch.Tensor]:
    """One neighbour hop along the axis that does not wrap: `t` goes to
    rank i + 1 (i − 1 under `reverse`), and what rank i − 1 (i + 1) sent
    in the same hop is received into a tensor shaped like `like`. None
    sends or expects nothing; the first rank (the last under `reverse`)
    has no sender and must expect nothing. The sends and receives of a hop
    are posted together and waited for; no gradient."""
    n, me = axis_size(group), axis_index(group)
    step = -1 if reverse else 1
    ops, out = [], None
    if t is not None:
        if not 0 <= me + step < n:
            raise ValueError(f"rank {me} of {n} has no neighbour at "
                             f"{me + step}: the hop does not wrap")
        ops.append(dist.P2POp(dist.isend, t.contiguous(),
                              dist.get_global_rank(group, me + step), group))
    if like is not None:
        if not 0 <= me - step < n:
            raise ValueError(f"rank {me} of {n} has no neighbour at "
                             f"{me - step}: the hop does not wrap")
        out = torch.empty_like(like)
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, me - step), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out
