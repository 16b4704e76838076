"""VGG19-BN in PyTorch — the counterpart of the JAX package's
`models/vgg.py` (the reference NESTED workload's second backbone,
NESTED/model/vgg.py:10-76).

Module names are torchvision's `vgg19_bn` (`features.<i>`: a conv, its BN
and a ReLU per conv entry of the cfg, one slot per max pool;
`classifier.{0,3,6}` for fc1/fc2/fc3), so a torchvision state dict loads
as it is; `models/convert.py::vgg_from_jax` carries flax weights across.

- `cfg` is a parameter, as the JAX `VGG(cfg=...)` (numbers are conv
  widths, "M" a 2×2 max pool); `vgg19_bn` takes torchvision's cfg E.
- Every BN is `models/batchnorm.py`'s flax BatchNorm (momentum 0.9, the
  biased running variance), with global batch statistics under a process
  group (`group`). JAX passes freeze-BN to the ResNets only, so these BNs
  keep batch statistics in training whatever `model.freeze_bn` says.
- Off a 7×7 grid the features are mean-pooled and tiled to 7×7 (JAX
  `vgg.py:56-58`), not adaptive-average-pooled as torchvision does; the
  two agree at 7×7 (224 px) and 1×1 only (ROADMAP.md §3).
- The flatten is torchvision's (c, h, w); the JAX model flattens (h, w,
  c), so `vgg_from_jax` permutes fc1's inputs.
- `num_classes=0` ends at fc2 (the 4096-d feature, the reference's
  `forward1`); otherwise ReLU, dropout and fc3 give the logits.

Dtype policy (the JAX model's): convs, BN outputs, ReLUs and pools in
the compute dtype (convs cast their f32 weights per call; BN statistics
in f32), the classifier in f32. The served model casts its conv weights
once (`cast_to_compute_dtype`).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from .batchnorm import BatchNorm
from .dropout import Dropout
from .tresnet import Conv2d

# torchvision cfg 'E' (VGG-19): conv output widths, "M" = 2×2 max pool
CFG_E: Sequence[Any] = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
    512, 512, 512, 512, "M", 512, 512, 512, 512, "M",
)
GRID = 7  # the classifier's input grid (torchvision's AdaptiveAvgPool2d(7))
WIDTH = 4096  # fc1/fc2 width, the feature the heads read


class VGG(nn.Module):
    """VGG with BatchNorm → the 4096-d feature (`num_classes=0`) or logits."""

    def __init__(self, cfg: Sequence[Any] = CFG_E, num_classes: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 group: Optional[dist.ProcessGroup] = None,
                 dropout: float = 0.5):
        super().__init__()
        self.cfg, self.dtype = tuple(cfg), dtype
        layers, c_in = [], 3
        for v in self.cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv2d(c_in, v, 3, padding=1),
                           BatchNorm(v, process_group=group), nn.ReLU()]
                c_in = v
        self.features = nn.Sequential(*layers)
        head = [nn.Linear(c_in * GRID * GRID, WIDTH), nn.ReLU(),
                Dropout(dropout), nn.Linear(WIDTH, WIDTH)]
        if num_classes > 0:
            head += [nn.ReLU(), Dropout(dropout), nn.Linear(WIDTH, num_classes)]
        self.classifier = nn.Sequential(*head)
        self.num_features = WIDTH

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x.to(self.dtype))
        if x.shape[2:] != (GRID, GRID):
            x = x.mean(dim=(2, 3), keepdim=True).expand(-1, -1, GRID, GRID)
        return self.classifier(torch.flatten(x, 1).float())

    def cast_to_compute_dtype(self) -> "VGG":
        """Apply the dtype policy to the weights once, for serving: conv
        kernels and biases to the compute dtype; BN and the classifier stay
        f32. A trainer keeps them f32 (the convs cast per call)."""
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                m.to(self.dtype)
        return self


def vgg19_bn(num_classes: int = 0, dtype: torch.dtype = torch.bfloat16,
             group: Optional[dist.ProcessGroup] = None,
             dropout: float = 0.5) -> VGG:
    return VGG(CFG_E, num_classes, dtype, group, dropout)
