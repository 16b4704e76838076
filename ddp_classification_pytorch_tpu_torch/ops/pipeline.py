"""GPipe over a stage group — the port of the JAX package's
`ops/pipeline.py` (`:51-126`).

Each rank of the stage group (the mesh's pipe group, or its model group on
a (data, model) mesh) holds the blocks of one stage, L/S consecutive
blocks of the L-block stack, and this rank's batch splits into M equal
microbatches (contiguous rows, JAX's reshape). M + S − 1 ticks drain the
pipe: at tick t stage s applies its blocks to microbatch t − s when that
is in range, stage 0 takes the microbatch itself and every later stage
the activation its predecessor handed on in the tick before
(`parallel/collectives.py::hop`, i → i + 1, which does not wrap); the
last stage keeps each microbatch's output. One `psum` over the group
then republishes the outputs to every stage (the others contribute
zeros), JAX's `where` + `psum`.

torch's point-to-point ops have no gradient, so the ticks are one
`autograd.Function` (`_GPipe`) whose inputs are the embedded tokens and
this stage's block parameters. Its forward keeps each microbatch's input
and output graph; its backward runs the ticks in reverse (JAX's scan
transpose): stage s takes microbatch t − s's output cotangent (the last
stage from the republished outputs' cotangent, the others from the stage
after them, over `hop(..., reverse=True)`), back-propagates it through
its blocks, hands the input cotangent to the stage before it and sums
its blocks' gradients over the M microbatches. So each parameter takes
its gradient once a backward, as DistributedDataParallel's reducer
expects. Stage 0 returns the embedded tokens' cotangent and every other
stage zeros: their patch embedding and position table take a gradient on
stage 0 alone (summed over the group afterwards,
`parallel/ddp.py::sum_stage_partials`). The gradient equals the
sequential stack's, not S times it: `psum`'s backward is the identity,
so the last stage's outputs take the loss's cotangent once.

Every rank posts its sends and receives in the same tick order: stage 0
receives nothing, the last stage sends nothing, and the backward's ticks
mirror the forward's. With a group of one (S = 1) the stack runs
sequentially and `microbatches` is ignored (JAX `:69-70`). Without
gradients the same ticks run with no graph kept.

The stages' bodies are generators that yield, each tick, what they hand
on and whether they expect something, so one body runs two ways: over the
group (`gpipe`) and in lockstep over S stage lists held by one process
(`gpipe_shards`, the seam `chip_smoke.py` and the tests reach; no CLI
path does, and nothing falls back to it).
"""

from __future__ import annotations

from typing import (Any, Callable, Generator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch
import torch.nn as nn

from ..parallel.collectives import Group, axis_index, axis_size, hop, psum
from ..parallel.mesh import check_stages

BlockFn = Callable[[nn.Module, torch.Tensor], torch.Tensor]
Body = Generator[Tuple[Optional[torch.Tensor], bool],
                 Optional[torch.Tensor], List[Optional[torch.Tensor]]]


def ticks(stages: int, microbatches: int) -> int:
    """The forward's tick count, M + S − 1 (the backward runs as many)."""
    return microbatches + stages - 1


def check_batch(batch: int, microbatches: int, shards: int = 1) -> None:
    """JAX's refusal (`:75-80`): the batch must split into `microbatches`
    on each of its `shards` (the product of the mesh's other axes above
    1). `batch` is the global batch, as JAX's executor sees it."""
    if batch % (microbatches * shards):
        raise ValueError(
            f"batch {batch} not divisible by microbatches×data "
            f"({microbatches}×{shards})")


def stage_apply(block_fn: BlockFn, blocks: Sequence[nn.Module],
                x: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """This stage's blocks in order (JAX `_stage_apply`). `remat`: while
    gradients are on, each block is recomputed whole in the backward
    (JAX wraps the block in plain `jax.checkpoint`)."""
    recompute = remat and torch.is_grad_enabled()
    for block in blocks:
        if recompute:
            from torch.utils.checkpoint import checkpoint

            x = checkpoint(block_fn, block, x, use_reentrant=False)
        else:
            x = block_fn(block, x)
    return x


def _params(blocks: Sequence[nn.Module]) -> List[torch.Tensor]:
    return [p for block in blocks for p in block.parameters()]


class _Stage:
    """One stage's blocks over the microbatches of one forward; with
    `keep` each microbatch's input and output graph stay for its
    backward, whose parameter gradients sum into `grads`."""

    def __init__(self, block_fn: BlockFn, blocks: Sequence[nn.Module],
                 params: Sequence[torch.Tensor], remat: bool, keep: bool):
        self.block_fn, self.blocks, self.remat = block_fn, blocks, remat
        self.params, self.keep = list(params), keep
        self.saved: dict = {}
        self.grads: List[Optional[torch.Tensor]] = [None] * len(self.params)

    def forward(self, h: torch.Tensor, mb: int) -> torch.Tensor:
        if not self.keep:
            with torch.no_grad():
                return stage_apply(self.block_fn, self.blocks, h)
        h = h.detach().requires_grad_()
        with torch.enable_grad():
            y = stage_apply(self.block_fn, self.blocks, h, self.remat)
        self.saved[mb] = (h, y)
        return y.detach()

    def backward(self, g: torch.Tensor, mb: int) -> torch.Tensor:
        h, y = self.saved.pop(mb)
        out = torch.autograd.grad(y, [h, *self.params], g.to(y.dtype),
                                  allow_unused=True)
        for i, d in enumerate(out[1:]):
            if d is not None:
                self.grads[i] = d if self.grads[i] is None else self.grads[i] + d
        return out[0]

    def param_grads(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(self.params, self.grads)]


def _forward_body(stage: _Stage, mbs: Sequence[torch.Tensor], index: int,
                  size: int) -> Body:
    """Stage `index`'s forward ticks; returns the outputs of the M
    microbatches on the last stage (Nones elsewhere)."""
    m = len(mbs)
    outs: List[Optional[torch.Tensor]] = [None] * m
    inp = None
    for t in range(ticks(size, m)):
        mb, send = t - index, None
        if 0 <= mb < m:
            y = stage.forward(mbs[mb] if index == 0 else inp, mb)
            if index == size - 1:
                outs[mb] = y
            else:
                send = y
        # the next tick's microbatch comes from the stage before
        inp = yield send, index > 0 and 0 <= mb + 1 < m
    return outs


def _backward_body(stage: _Stage, g_mbs: Optional[Sequence[torch.Tensor]],
                   index: int, size: int, m: int) -> Body:
    """Stage `index`'s backward ticks, the forward's in reverse; returns
    the input cotangents of the M microbatches on stage 0."""
    dxs: List[Optional[torch.Tensor]] = [None] * m
    inp = None
    for u in range(ticks(size, m)):
        mb, send = ticks(size, m) - 1 - u - index, None
        if 0 <= mb < m:
            dx = stage.backward(g_mbs[mb] if index == size - 1 else inp, mb)
            if index == 0:
                dxs[mb] = dx
            else:
                send = dx
        # the next tick's cotangent comes from the stage after
        inp = yield send, index < size - 1 and 0 <= mb - 1 < m
    return dxs


def _drive(body: Body, group: Group, like: torch.Tensor,
           reverse: bool) -> List[Optional[torch.Tensor]]:
    """Run one stage's body over the group, one `hop` a tick."""
    try:
        send, expect = next(body)
        while True:
            got = hop(send, like if expect else None, group, reverse)
            send, expect = body.send(got)
    except StopIteration as stop:
        return stop.value


def _drive_lockstep(bodies: Sequence[Body], reverse: bool
                    ) -> Tuple[List[List[Optional[torch.Tensor]]], int]:
    """Run S stages' bodies in one process, tick by tick: stage i takes
    what stage i − 1 (i + 1 under `reverse`) handed on. Returns their
    results and the tick count."""
    n = len(bodies)
    msgs = [next(b) for b in bodies]
    results: List[Any] = [None] * n
    count = 1
    while True:
        incoming = []
        for i, (_, expect) in enumerate(msgs):
            j = i + 1 if reverse else i - 1
            got = msgs[j][0] if expect else None
            if expect and got is None:
                raise RuntimeError(f"stage {i} expects from stage {j}, "
                                   "which handed nothing on")
            incoming.append(got)
        done = 0
        for i, body in enumerate(bodies):
            try:
                msgs[i] = body.send(incoming[i])
            except StopIteration as stop:
                results[i], msgs[i] = stop.value, (None, False)
                done += 1
        if done:
            if done != n:
                raise RuntimeError("the stages ran different tick counts")
            return results, count
        count += 1


class _Run(NamedTuple):
    block_fn: BlockFn
    blocks: Sequence[nn.Module]
    group: Group
    microbatches: int
    remat: bool


class _GPipe(torch.autograd.Function):
    """The ticks over the stage group: forward ticks, backward ticks."""

    @staticmethod
    def forward(ctx, x, run: _Run, *params):
        index, size = axis_index(run.group), axis_size(run.group)
        mbs = x.chunk(run.microbatches)
        stage = _Stage(run.block_fn, run.blocks, params, run.remat, True)
        outs = _drive(_forward_body(stage, mbs, index, size), run.group,
                      mbs[0], reverse=False)
        ctx.stage, ctx.run = stage, run
        ctx.like = torch.empty_like(mbs[0])
        if index == size - 1:
            return torch.cat(outs)
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        stage, run = ctx.stage, ctx.run
        ctx.stage = None
        index, size = axis_index(run.group), axis_size(run.group)
        m = run.microbatches
        g_mbs = g.chunk(m) if index == size - 1 else None
        dxs = _drive(_backward_body(stage, g_mbs, index, size, m),
                     run.group, ctx.like, reverse=True)
        if index == 0:
            dx = torch.cat(dxs)
        else:
            dx = ctx.like.new_zeros((ctx.like.shape[0] * m,
                                     *ctx.like.shape[1:]))
        return (dx, None, *stage.param_grads())


def gpipe(block_fn: BlockFn, stage_blocks: Sequence[nn.Module],
          x: torch.Tensor, group: Group, microbatches: int,
          batch: Optional[int] = None, shards: int = 1,
          remat: bool = False) -> torch.Tensor:
    """Run this rank's (B, T, C) `x` through the L-block stack pipelined
    over `group`: this rank holds `stage_blocks`, the blocks of its stage
    (`parallel/mesh.py::block_stage`), and every rank of the group gets
    the stack's output. `block_fn(block, h)` applies one block. `batch`
    (default B) is the global batch JAX's check reads and `shards` the
    product of the mesh's other axes above 1 (JAX's "data"). With a
    group of one, the blocks in order, M ignored."""
    size = axis_size(group)
    if size <= 1:
        return stage_apply(block_fn, stage_blocks, x, remat)
    check_batch(x.shape[0] if batch is None else batch, microbatches,
                shards)
    params = _params(stage_blocks)
    run = _Run(block_fn, stage_blocks, group, microbatches, remat)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(p.requires_grad for p in params)):
        out = _GPipe.apply(x, run, *params)
    else:
        index = axis_index(group)
        mbs = x.chunk(microbatches)
        outs = _drive(_forward_body(_Stage(block_fn, stage_blocks, params,
                                           False, False), mbs, index, size),
                      group, mbs[0], reverse=False)
        out = torch.cat(outs) if index == size - 1 else torch.zeros_like(x)
    return psum(out, group)  # the last stage's outputs, republished


class ShardsRun(NamedTuple):
    """`gpipe_shards`' result: the stack's output; with an output
    cotangent also the input's and each stage's parameter gradients (in
    `block.parameters()` order, block after block); the tick count of
    the forward (the backward ran as many)."""

    out: torch.Tensor
    dx: Optional[torch.Tensor]
    grads: Optional[List[List[torch.Tensor]]]
    ticks: int


def gpipe_shards(block_fn: BlockFn, stages: Sequence[Sequence[nn.Module]],
                 x: torch.Tensor, microbatches: int,
                 g_out: Optional[torch.Tensor] = None,
                 remat: bool = False) -> ShardsRun:
    """The pipeline over S stage lists held by this one process, the
    stages in lockstep: the same bodies, ticks and microbatches as `gpipe`
    over a group of S ranks, the activations and cotangents handed
    between the lists instead of sent. With `g_out`, the output's
    cotangent, the backward ticks run too."""
    s = len(stages)
    depth = sum(len(b) for b in stages)
    check_stages(depth, s)
    if any(len(b) != depth // s for b in stages):
        raise ValueError(f"stages of {[len(b) for b in stages]} blocks: "
                         f"each holds {depth // s}")
    check_batch(x.shape[0], microbatches)
    mbs = x.chunk(microbatches)
    keep = g_out is not None
    runs = [_Stage(block_fn, blocks, _params(blocks), remat, keep)
            for blocks in stages]
    outs, count = _drive_lockstep(
        [_forward_body(runs[i], mbs, i, s) for i in range(s)], reverse=False)
    out = torch.cat(outs[-1])
    if not keep:
        return ShardsRun(out, None, None, count)
    g_mbs = g_out.chunk(microbatches)
    dxs, back = _drive_lockstep(
        [_backward_body(runs[i], g_mbs, i, s, microbatches)
         for i in range(s)], reverse=True)
    if back != count:
        raise RuntimeError(f"backward ran {back} ticks, forward {count}")
    return ShardsRun(out, torch.cat(dxs[0]),
                     [r.param_grads() for r in runs], count)
