"""flax's `nn.Dropout` in PyTorch, shared by VGG19-BN's classifier
(`models/vgg.py`) and the ViT's MLP (`models/vit.py`).

In training, `where(keep, x / (1 − p), 0)` with keep ~ Bernoulli(1 − p);
the identity in eval mode or at p = 0. The keep mask of a call comes, in
this order, from:

- `next_mask` (a bool tensor of x's shape, or a list of them fed to the
  next calls one each, in order: one per microbatch of an accumulated
  step), which the call clears: parity tests hand in the JAX step's masks,
  as the nested tests hand in its k;
- `generator`, a `torch.Generator` on x's device that the train step
  seeds from the run seed, the step and the rank
  (`train/steps.py::seed_dropout`), so a resumed run draws the masks the
  uninterrupted run drew;
- torch's default generator when neither is set.

`draw(shape, device)` takes the mask of the next call without applying
it: the ViT draws each block's mask before the block and passes it in,
so that a rematerialized block recomputes with the mask its forward used
(JAX's functional dropout rng).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn as nn


class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.next_mask: Union[None, torch.Tensor, List[torch.Tensor]] = None
        self.generator: Optional[torch.Generator] = None

    def active(self) -> bool:
        return self.training and self.p > 0.0

    def draw(self, shape: Sequence[int], device: torch.device) -> torch.Tensor:
        """The keep mask (bool, `shape`) of the next training call."""
        keep, self.next_mask = self.next_mask, None
        if isinstance(keep, list):
            keep, rest = keep[0], keep[1:]
            self.next_mask = rest or None
        if keep is None:
            keep = torch.rand(tuple(shape), generator=self.generator,
                              device=device) >= self.p
        return keep.to(device)

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.active():
            return x
        if keep is None:
            keep = self.draw(x.shape, x.device)
        return torch.where(keep, x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))
