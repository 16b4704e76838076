"""ResNet in PyTorch — the counterpart of the JAX package's
`models/resnet.py` (depths 18/34/50/101/152, ImageNet and CIFAR stems), the
default backbone of every reference workload (BASELINE/main.py:134-139).

Structure and numerics follow the flax model (torchvision v1.5: the
stride sits on the 3×3 conv of a bottleneck); module names follow
torchvision's (`conv1`, `bn1`, `layer1.0.conv1`, `downsample.0/1`, `fc`),
which are also the JAX package's torch oracle's
(`models/torch_oracle.py:85-95`), so a torchvision `state_dict` loads
without a map. `models/convert.py::resnet_from_jax` carries flax weights
across.

- Blocks: `BasicBlock` (JAX `resnet.py:40-63`), `Bottleneck` (`:66-92`);
  a block whose output shape differs from its input's has a 1×1 strided
  conv + BN shortcut (`downsample`).
- Stems (`:145-154`): ImageNet, 7×7/2 with padding 3, BN, ReLU, then
  MaxPool(3, 2, 1); CIFAR, 3×3/1 with no pool.
- Head (`:164-170`): the global mean pool in f32, then an f32 `fc`
  (`num_classes=0` returns the pooled features).

Tensors are NCHW in channels_last memory (NHWC, as the JAX package lays
them out). Dtype policy (the JAX model's): convs run in the compute dtype
(bf16 by default) and cast their f32 weights per call, as flax's
`nn.Conv(dtype=...)` does, so a trainer keeps f32 master weights; every BN
computes in f32 from f32 parameters and statistics and writes the
activation dtype (`models/batchnorm.py`); the pool and fc run in f32. The
served model casts its conv weights once (`cast_to_compute_dtype`).

In training mode with a process group of more than one rank, every BN
takes global batch statistics (`models/batchnorm.py`): the JAX model's
BatchNorm over a batch sharded on the mesh's `data` axis (`:136-141`).
With `freeze_bn` every BN normalizes with its running statistics in
training too and exchanges nothing (the NESTED workload, `:136-141`).
With `remat` (`--remat`) each residual block is rematerialized whole in
training, as JAX's `nn.remat(block_cls)` (`:155`): its activations are
recomputed in the backward instead of kept, and the BNs' running update
is made once (`models/remat.py`).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Type

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .batchnorm import BatchNorm
from .remat import remat_whole
from .tresnet import Conv2d


def _conv(c_in: int, c_out: int, k: int, stride: int = 1) -> Conv2d:
    """Bias-free conv with torch's explicit padding k//2 on both sides (the
    JAX model pads the same way so torchvision weights are exact)."""
    return Conv2d(c_in, c_out, k, stride, k // 2, bias=False)


class BasicBlock(nn.Module):
    """3×3 + 3×3 residual block."""

    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int,
                 norm: Callable[[int], nn.Module] = BatchNorm):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = _conv(c_in, filters, 3, stride)
        self.bn1 = norm(filters)
        self.conv2 = _conv(filters, out, 3)
        self.bn2 = norm(out)
        self.downsample = (
            nn.Sequential(_conv(c_in, out, 1, stride),
                          norm(out))
            if stride != 1 or c_in != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (strided) → 1×1 block, expansion 4."""

    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int,
                 norm: Callable[[int], nn.Module] = BatchNorm):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = _conv(c_in, filters, 1)
        self.bn1 = norm(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.bn2 = norm(filters)
        self.conv3 = _conv(filters, out, 1)
        self.bn3 = norm(out)
        self.downsample = (
            nn.Sequential(_conv(c_in, out, 1, stride),
                          norm(out))
            if stride != 1 or c_in != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class ResNet(nn.Module):
    """ResNet backbone → pooled features, or logits when `num_classes` > 0.

    `group`: the process group whose ranks share every BN's batch
    statistics in training (None: this process's batch only).
    `freeze_bn`: every BN normalizes with its running statistics in
    training too (`models/batchnorm.py`). `remat`: in training each
    residual block is recomputed whole in the backward
    (`models/remat.py::remat_whole`)."""

    def __init__(self, stage_sizes: Sequence[int],
                 block_cls: Type[nn.Module], num_classes: int = 0,
                 num_filters: int = 64, cifar_stem: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 group: Optional[dist.ProcessGroup] = None,
                 freeze_bn: bool = False, remat: bool = False):
        super().__init__()
        norm = functools.partial(BatchNorm, process_group=group,
                                 frozen=freeze_bn)
        self.dtype = dtype
        self.remat = remat
        self.cifar_stem = cifar_stem
        if cifar_stem:
            self.conv1 = _conv(3, num_filters, 3)
        else:
            self.conv1 = _conv(3, num_filters, 7, 2)
        self.bn1 = norm(num_filters)
        c_in = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(n_blocks):
                blocks.append(block_cls(c_in, num_filters * 2 ** i,
                                        2 if (i > 0 and j == 0) else 1, norm))
                c_in = num_filters * 2 ** i * block_cls.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.num_features = c_in
        self.fc = nn.Linear(c_in, num_classes) if num_classes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, 1)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i in range(self.num_stages):
            layer = getattr(self, f"layer{i + 1}")
            if not remat:
                x = layer(x)
                continue
            for block in layer:
                x = remat_whole(block, x)
        x = x.float().mean(dim=(2, 3))
        if self.fc is not None:
            x = self.fc(x)
        return x

    def cast_to_compute_dtype(self) -> "ResNet":
        """Apply the dtype policy to the weights once, for serving: conv
        kernels to the compute dtype; BN and fc stay f32. A trainer keeps
        them f32 (the convs cast per call)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(self.dtype)
        return self


DEPTHS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}


def build_resnet(name: str, num_classes: int = 0, variant: str = "imagenet",
                 dtype: torch.dtype = torch.bfloat16,
                 group: Optional[dist.ProcessGroup] = None,
                 freeze_bn: bool = False, remat: bool = False) -> ResNet:
    """The published ResNet `name` (JAX `resnet.py:174-191`)."""
    if variant not in ("imagenet", "cifar"):
        raise ValueError(f"unknown ResNet variant {variant!r}; one of "
                         "imagenet, cifar")
    block_cls, stages = DEPTHS[name]
    return ResNet(stages, block_cls, num_classes=num_classes,
                  cifar_stem=(variant == "cifar"), dtype=dtype, group=group,
                  freeze_bn=freeze_bn, remat=remat)
