"""Class-sharded ArcFace cross-entropy, the "partial-FC" scale path — the
port of the JAX package's `ops/sharded_head.py`.

The exact mean softmax-CE over arc-margin logits with the class dim
sharded over a model group, no (B, C) tensor on any rank:

- each rank holds a (C/N, D) slice of the margin weight and computes its
  (B, C/N) cosine / margin block, the margin only on rows whose label
  falls in its slice (`_local_margin_logits`, the dense op's
  `margin_splice`);
- the softmax denominator: the rows' max by `pmax` (no gradient: the
  shift is gradient-neutral), then the shifted exponential sums by
  `psum`;
- the target logit lives on one shard a row: a masked local sum, `psum`;
- top-1 / top-k by the true label's rank, `#{c : logit_c ≥ target} − 1`
  summed over the shards by one `psum` (the dense metric's ties-against
  convention); a row with any non-finite logit counts as a miss;
- `valid` (0/1 a row) masks the loader's wrap padding (eval): masked rows
  leave the loss's numerator and the counts, and the denominator is
  Σ valid;
- over a `batch_group` the sums run over the global batch.

The body is a generator yielding ("max" | "sum", tensor) and receiving
the reduced tensor, so one body serves the group (`pmax` / `psum` of
`parallel/collectives.py`, the features entering through `copy_to`) and
N shards held by one process (`arc_margin_ce_shards`, the in-process seam
of `chip_smoke.py` and the tests, whose reductions are differentiable
sums over the shards' tensors).
"""

from __future__ import annotations

from typing import Any, Generator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import (
    Group,
    axis_index,
    axis_size,
    copy_to,
    pmax,
    psum,
    psum_batch,
)
from .arcface import _l2_normalize, margin_splice


def _local_margin_logits(features: torch.Tensor, w_local: torch.Tensor,
                         labels: torch.Tensor, offset: int, s: float,
                         m: float, easy_margin: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C_local) arc-margin logits of one class shard, and the one-hot
    of the labels that fall in [offset, offset + C_local)."""
    cosine = _l2_normalize(features.float(), 1) @ _l2_normalize(
        w_local.float(), 1).T
    c_local = w_local.shape[0]
    local = labels.long() - offset
    owned = (local >= 0) & (local < c_local)
    one_hot = (F.one_hot(local.clamp(0, c_local - 1), c_local).float()
               * owned[:, None].float())
    return margin_splice(cosine, one_hot, s, m, easy_margin), one_hot


Body = Generator[Tuple[str, torch.Tensor], torch.Tensor, Any]


def _ce_body(features, w_local, labels, valid, index: int, s: float,
             m: float, easy_margin: bool, topk: int) -> Body:
    """One shard's partial-FC CE; returns (loss_sum, top1, topk, n) of its
    rows (summed over the class axis, not yet over the batch axis)."""
    logits, one_hot = _local_margin_logits(
        features, w_local, labels, index * w_local.shape[0], s, m,
        easy_margin)
    mx = yield "max", logits.amax(dim=1)
    sumexp = yield "sum", torch.exp(logits - mx[:, None]).sum(dim=1)
    lse = torch.log(sumexp) + mx
    target = yield "sum", (logits * one_hot).sum(dim=1)
    loss_sum = ((lse - target) * valid).sum()
    counts = torch.stack([
        (logits >= target.detach()[:, None]).sum(dim=1),
        (~torch.isfinite(logits)).sum(dim=1)]).float()
    counts = yield "sum", counts
    rank, bad = counts[0] - 1, counts[1]
    ok = valid * (bad == 0).float()
    return (loss_sum, ((rank < 1).float() * ok).sum(),
            ((rank < topk).float() * ok).sum(), valid.sum())


def _run(body: Body, reduce) -> Any:
    try:
        kind, x = next(body)
        while True:
            kind, x = body.send(reduce(kind, x))
    except StopIteration as stop:
        return stop.value


def _finish(loss_sum, top1, topn, n):
    return loss_sum / torch.clamp_min(n, 1.0), top1, topn


def arc_margin_ce_sharded(features: torch.Tensor, w_local: torch.Tensor,
                          labels: torch.Tensor, group: Group,
                          batch_group: Group = None, s: float = 30.0,
                          m: float = 0.5, easy_margin: bool = False,
                          topk: int = 3,
                          valid: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(loss, top1_count, topk_count) over the global batch, replicated:
    the values of the dense `CE(arc_margin_logits(...))` and its rank
    counts, with this rank's (C/N, D) slice `w_local` of the margin
    weight over the model `group`. features (B, D) and labels (B,) are
    this data shard's rows; `valid` (B,) 0/1 masks rows (eval, with m 0:
    the s·cosθ scores). Over `batch_group` the loss is the global batch's
    mean and its gradient, averaged over that group (DDP), is the global
    one."""
    if valid is None:
        valid = torch.ones(labels.shape[0], device=features.device)
    valid = valid.float()
    feats = copy_to(features, group)

    def reduce(kind: str, x: torch.Tensor) -> torch.Tensor:
        return pmax(x, group) if kind == "max" else psum(x, group)

    loss_sum, top1, topn, n = _run(
        _ce_body(feats, w_local, labels, valid, axis_index(group), s, m,
                 easy_margin, topk), reduce)
    if axis_size(batch_group) > 1:
        loss_sum = psum_batch(loss_sum, batch_group)
        top1, topn, n = psum_batch(torch.stack([top1, topn, n]).detach(),
                                   batch_group)
    return _finish(loss_sum, top1, topn, n)


def arc_margin_ce_shards(features: torch.Tensor,
                         w_shards: Sequence[torch.Tensor],
                         labels: torch.Tensor, s: float = 30.0,
                         m: float = 0.5, easy_margin: bool = False,
                         topk: int = 3,
                         valid: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`arc_margin_ce_sharded` over N class shards held by this one
    process, the shards' bodies in lockstep: each "max" the shards'
    detached max, each "sum" their sum (differentiable, so a backward
    through the loss gives every shard its gradient)."""
    if valid is None:
        valid = torch.ones(labels.shape[0], device=features.device)
    valid = valid.float()
    bodies = [_ce_body(features, w, labels, valid, i, s, m, easy_margin, topk)
              for i, w in enumerate(w_shards)]
    msgs = [next(b) for b in bodies]
    while True:
        kind = msgs[0][0]
        xs = [x for _, x in msgs]
        red = (torch.stack([x.detach() for x in xs]).amax(dim=0)
               if kind == "max" else torch.stack(xs).sum(dim=0))
        try:
            msgs = [b.send(red) for b in bodies]
        except StopIteration as stop:
            # the bodies end at one step on the same sums: shard 0's
            # values carry the graph of every shard's logits
            return _finish(*stop.value)
