"""Rematerialization (`model.remat`, `--remat`) — the port of flax's
`nn.remat` as the JAX package applies it:

- `remat_whole(fn, *args)`: the ResNets' `nn.remat(block_cls)` (JAX
  `models/resnet.py:155`, no policy): nothing inside the block is kept
  for the backward but its inputs; the backward runs the block's forward
  again.
- `remat_dots(fn, *args)`: the ViT's `nn.remat(Block,
  policy=checkpoint_dots)` (JAX `models/vit.py:196-206`): the outputs of
  the matrix products (`mm`, `addmm`, `bmm`, `baddbmm`, in any overload:
  `F.linear`, the dense attention's and the experts' einsums all dispatch
  to them) are kept, everything else is recomputed in the backward — the
  LayerNorms, the GELU, and the flash forward K2, whose launch is no
  product the policy sees (JAX's `checkpoint_dots` does not save a
  `pallas_call`'s output either).

Both are `torch.utils.checkpoint.checkpoint` in its non-reentrant form.
Its recompute runs under `recomputing()`, which a forward with a side
effect reads: the BNs' running-statistics update (`models/batchnorm.py`)
is made by the forward and skipped by the recompute, so a remat step
leaves the statistics a plain step leaves. Randomness is an input: the
ViT draws its dropout masks before the checkpointed call.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten
# the products whose outputs checkpoint_dots keeps
_DOTS = frozenset((_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm))
_recompute_depth = 0


def recomputing() -> bool:
    """Whether a checkpointed region's backward recompute is running."""
    return _recompute_depth > 0


@contextlib.contextmanager
def _recompute():
    global _recompute_depth
    _recompute_depth += 1
    try:
        yield
    finally:
        _recompute_depth -= 1


def _whole_contexts():
    return contextlib.nullcontext(), _recompute()


def remat_whole(fn: Callable[..., Any], *args: Any) -> Any:
    """`fn(*args)`, recomputed whole in the backward."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_whole_contexts)


def _checkpoint_dots(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    if func.overloadpacket in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _recompute_under(mode):
    with mode, _recompute():
        yield


def _dots_contexts():
    fwd, rec = create_selective_checkpoint_contexts(_checkpoint_dots)
    return fwd, _recompute_under(rec)


def remat_dots(fn: Callable[..., Any], *args: Any) -> Any:
    """`fn(*args)` with the products' outputs kept and the rest recomputed
    in the backward."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_dots_contexts)
