"""Classifier heads — the port of the JAX package's `models/heads.py`, with
the flax submodule names (`fc`, `fc1`, `fc2`, `weight`) so that
`models/convert.py` maps the weights one to one. Every head computes in
f32 from f32 weights, whatever the backbone's compute dtype. (The JAX
module's `FCHead` has no caller there or here: the fc head is the
backbone's own classifier, `factory.py::ClassifierModel`.)

- `ArcEmbedding`: the ARCFACE tail, features → 512 → ReLU →
  `arc_embed_dim` (arc_main.py:223-231), with the reference's LogSoftmax on
  the embedding only under `log_softmax_quirk` (:230).
- `ArcMarginHead`: ArcMarginProduct (arc_main.py:130-176), an f32 (C, D)
  `weight` (xavier-uniform at init, `train/state.py::init_weights_`).
- `NetClassifier`: the bias-free linear classifier (NESTED/model/
  model.py:64-76).
- `ClassShardedLinear`: an `nn.Linear` whose (C, D) weight holds this
  rank's C/N class rows over a model group (the fc heads and the nested
  classifier when `--mp` > 1, `models/factory.py::class_shard_`).

Over a model group (`group`, set by `class_shard_`) the class-dim matrices
hold their C/N shard, and a head's logits come whole through an
all-gather, so the plain losses compute what JAX's GSPMD program
computes: the features enter through `copy_to` (their gradient is the sum
of every shard's), each rank forms its (B, C/N) block, `all_gather`
concatenates the blocks (its backward hands each shard its own slice),
and the replicated bias is added to the whole.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.arcface import arc_margin_logits, cosine_logits, margin_splice
from ..parallel.collectives import Group, all_gather, copy_to


class ArcEmbedding(nn.Module):
    """features → `dims[0]` → ReLU → `dims[1]` (JAX `heads.py:36-50`)."""

    def __init__(self, in_features: int, dims=(512, 256),
                 log_softmax_quirk: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(in_features, dims[0])
        self.fc2 = nn.Linear(dims[0], dims[1])
        self.log_softmax_quirk = log_softmax_quirk

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc2(F.relu(self.fc1(x.float())))
        if self.log_softmax_quirk:
            x = F.log_softmax(x, dim=-1)
        return x


class ArcMarginHead(nn.Module):
    """`forward(features, labels)` → (B, C) scaled margin logits for the
    CE; `labels=None` → s·cosθ, the inference scores (JAX
    `heads.py:53-81`)."""

    def __init__(self, num_classes: int, in_features: int, s: float = 30.0,
                 m: float = 0.5, easy_margin: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_classes, in_features))
        self.s, self.m, self.easy_margin = s, m, easy_margin
        self.group: Group = None  # the class axis, when `weight` is sharded

    def forward(self, features: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.group is not None:
            cosine = all_gather(cosine_logits(copy_to(features, self.group),
                                              self.weight), self.group, 1)
            if labels is None:
                return cosine * self.s
            one_hot = F.one_hot(labels.long(), cosine.shape[1]).float()
            return margin_splice(cosine, one_hot, self.s, self.m,
                                 self.easy_margin)
        if labels is None:
            return cosine_logits(features, self.weight) * self.s
        return arc_margin_logits(features, self.weight, labels, self.s,
                                 self.m, self.easy_margin)


class NetClassifier(nn.Module):
    """Bias-free linear classifier on (possibly masked) features."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.fc = nn.Linear(in_features, num_classes, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x.float())


class ClassShardedLinear(nn.Linear):
    """`nn.Linear` over a model group: `weight` (C/N, D) this rank's class
    rows, `bias` (C,) whole; the logits (…, C) whole on every rank. Built
    whole (so the init draws what a one-shard run draws) and sliced by
    `models/factory.py::shard_params_`."""

    group: Group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return super().forward(x)
        out = all_gather(F.linear(copy_to(x, self.group), self.weight),
                         self.group, -1)
        return out if self.bias is None else out + self.bias
