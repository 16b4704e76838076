"""TResNet-M in PyTorch — the counterpart of the JAX package's
`models/tresnet.py` (the reference's `--model timm` choice,
BASELINE/main.py:141-144).

Structure and numerics follow the flax model; module names follow timm's
`tresnet.py`, so the `state_dict` has timm's key layout — the one the JAX
package's `models/import_torch.py::convert_tresnet_state_dict` consumes:
`body.conv1.{0,1}` stem conv + ABN; `body.layerL.B.convJ.{0,1}`, or
`convJ.0.{0,1}` + `convJ.1.filt` where the stride-2 conv is followed by the
anti-alias blur; `se.fc{1,2}` as 1×1 convs; `downsample.1.{0,1}`; `head.fc`.

Tensors are NCHW in channels_last memory, which is NHWC as the JAX package
lays it out. Dtype policy (the JAX model's): convs and the blur run in the
compute dtype (bf16 by default), casting their f32 weights to the
activation dtype on every call as flax's `nn.Conv(dtype=...)` does, so a
trainer keeps f32 master weights; every ABN computes in f32 from f32
parameters and statistics and writes the activation dtype; SE squeezes and
excites in f32 and gates in the activation dtype; the pool and the fc head
run in f32. The served model casts its conv weights once, at load
(`TResNet.cast_to_compute_dtype()`), which makes the per-call cast a no-op.

Every activated ABN (the stem, `abn1` of each block, `abn2` of each
bottleneck: 36 sites in TResNet-M) runs K1 (`ops/fused_abn.py`): in eval
mode on its running statistics; in training mode on the batch statistics
of K1s, with K1r and K1d as its backward (`batch_norm_leaky_relu`). The
identity BNs (`bn2`, `bn3`, `bn_down`: 24 sites) are plain PyTorch
(`models/batchnorm.py`, built without a process group: TResNet-M trains
on one rank). In training mode both update their running statistics as flax does:
ra = 0.9·ra + 0.1·batch, with the biased batch variance.
"""

from __future__ import annotations

import collections
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_abn import batch_norm_leaky_relu, fused_bn_leaky_relu
# the identity ABN (`bn2`, `bn3`, `bn_down` on the JAX side) is flax's
# BatchNorm; re-exported so `tresnet.BatchNorm` keeps naming it
from .batchnorm import BatchNorm

SLOPE = 1e-3  # TResNet's leaky-relu slope (inplace_abn activation_param)


class FusedABN(BatchNorm):
    """Activated ABN: BatchNorm + LeakyReLU as one K1 launch, on the
    running statistics in eval mode (`tresnet.py:59-62` on the JAX side)
    and on the batch statistics in training mode (`:63-67`)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 slope: float = SLOPE):
        super().__init__(num_features, eps)
        self.slope = slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return fused_bn_leaky_relu(x, self.weight, self.bias,
                                       self.running_mean, self.running_var,
                                       self.eps, self.slope)
        y, mean, var = batch_norm_leaky_relu(x, self.weight, self.bias,
                                             self.eps, self.slope)
        self.update_running(mean, var)
        return y


class SpaceToDepth(nn.Module):
    """(B, C, H, W) → (B, b²·C, H/b, W/b) with channel order (bh, bw, c) —
    timm's SpaceToDepth permute and the JAX `space_to_depth`
    (`tresnet.py:71-76`). The output is channels_last."""

    def __init__(self, block: int = 4):
        super().__init__()
        self.block = block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        k = self.block
        x = x.permute(0, 2, 3, 1)  # NHWC view; free for channels_last input
        x = x.reshape(b, h // k, k, w // k, k, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h // k, w // k, k * k * c).permute(0, 3, 1, 2)


class BlurPool(nn.Module):
    """Fixed 3×3 binomial depthwise blur, stride 2, pad 1 — timm's
    AntiAliasDownsampleLayer. `filt` is a persistent buffer, as in timm's
    checkpoints; `models/convert.py` fills it (the JAX model holds no
    tensor for it)."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        self.register_buffer("filt", blur_filter(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.filt.to(x.dtype), stride=2, padding=1,
                        groups=self.channels)


def blur_filter(channels: int) -> torch.Tensor:
    k = torch.tensor([1.0, 2.0, 1.0])
    k2 = torch.outer(k, k)
    return (k2 / k2.sum()).expand(channels, 1, 3, 3).contiguous()


class SE(nn.Module):
    """Squeeze-excitation with timm's 1×1-conv parameters (`fc1`, `fc2`),
    computed in f32 on the pooled (B, C) vector as the flax SE computes its
    Dense layers; the gate multiplies in the activation dtype."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, reduced, 1)
        self.fc2 = nn.Conv2d(reduced, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3))
        s = F.relu(F.linear(s, self.fc1.weight.flatten(1), self.fc1.bias))
        s = torch.sigmoid(F.linear(s, self.fc2.weight.flatten(1), self.fc2.bias))
        return x * s[:, :, None, None].to(x.dtype)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` (same parameters and `state_dict` keys) that runs in the
    activation's dtype: its weight is cast to x's dtype on every call, as
    flax's `nn.Conv(dtype=...)` casts its f32 kernel (a no-op once the
    served model has cast the weights)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _conv_bn(c_in: int, c_out: int, k: int, activated: bool,
             aa: bool = False) -> nn.Sequential:
    """timm's conv2d_iabn: conv (stride 1, 'SAME' padding) + ABN, wrapped
    with the blur when it downsamples."""
    inner = nn.Sequential(Conv2d(c_in, c_out, k, 1, k // 2, bias=False),
                          FusedABN(c_out) if activated else BatchNorm(c_out))
    return nn.Sequential(inner, BlurPool(c_out)) if aa else inner


def _downsample(c_in: int, c_out: int, stride: int) -> nn.Sequential:
    """Shortcut: AvgPool2d(2, 2, ceil_mode, count_include_pad=False) when
    striding, then 1×1 conv + identity ABN — keys `downsample.1.{0,1}`."""
    pool = (nn.AvgPool2d(2, 2, ceil_mode=True, count_include_pad=False)
            if stride == 2 else nn.Identity())
    return nn.Sequential(pool, _conv_bn(c_in, c_out, 1, activated=False))


class TBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int, use_se: bool):
        super().__init__()
        self.conv1 = _conv_bn(c_in, filters, 3, True, aa=(stride == 2))
        self.conv2 = _conv_bn(filters, filters, 3, False)
        self.se = (SE(filters, max(filters * self.expansion // 4, 64))
                   if use_se else None)
        out = filters * self.expansion
        self.downsample = (_downsample(c_in, out, stride)
                           if stride == 2 or c_in != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        if self.se is not None:
            y = self.se(y)
        r = x if self.downsample is None else self.downsample(x)
        return F.leaky_relu(y + r, SLOPE)


class TBottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int, use_se: bool):
        super().__init__()
        self.conv1 = _conv_bn(c_in, filters, 1, True)
        self.conv2 = _conv_bn(filters, filters, 3, True, aa=(stride == 2))
        # timm applies SE on the MID width between conv2 and conv3
        self.se = (SE(filters, max(filters * self.expansion // 8, 64))
                   if use_se else None)
        out = filters * self.expansion
        self.conv3 = _conv_bn(filters, out, 1, False)
        self.downsample = (_downsample(c_in, out, stride)
                           if stride == 2 or c_in != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        if self.se is not None:
            y = self.se(y)
        y = self.conv3(y)
        r = x if self.downsample is None else self.downsample(x)
        return F.leaky_relu(y + r, SLOPE)


class TResNet(nn.Module):
    """TResNet topology: stages [3, 4, 11, 3] and widths 64/128/256/512 for
    TResNet-M (width 1). `num_classes=0` returns the pooled features."""

    def __init__(self, num_classes: int = 0,
                 stages: Sequence[int] = (3, 4, 11, 3), width: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        w = int(64 * width)
        plan = [(TBasicBlock, w, 1, True), (TBasicBlock, w * 2, 2, True),
                (TBottleneck, w * 4, 2, True), (TBottleneck, w * 8, 2, False)]
        layers = [("s2d", SpaceToDepth(4)), ("conv1", _conv_bn(48, w, 3, True))]
        c_in = w
        for s, (block, filters, stride, use_se) in enumerate(plan):
            blocks = []
            for b in range(stages[s]):
                blocks.append(block(c_in, filters, stride if b == 0 else 1,
                                    use_se))
                c_in = filters * block.expansion
            layers.append((f"layer{s + 1}", nn.Sequential(*blocks)))
        self.body = nn.Sequential(collections.OrderedDict(layers))
        self.num_features = c_in
        self.head = nn.Module()
        self.head.fc = nn.Linear(c_in, num_classes) if num_classes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.body(x.to(self.dtype))
        x = x.float().mean(dim=(2, 3))
        if self.head.fc is not None:
            x = self.head.fc(x)
        return x

    def cast_to_compute_dtype(self) -> "TResNet":
        """Apply the dtype policy to the weights once, for serving: conv
        kernels and the blur filter to the compute dtype; ABN, SE and fc
        stay f32. A trainer keeps them f32 (the convs cast per call)."""
        se_convs = {id(m) for se in self.modules() if isinstance(se, SE)
                    for m in (se.fc1, se.fc2)}
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and id(m) not in se_convs:
                m.to(self.dtype)
            elif isinstance(m, BlurPool):
                m.filt = m.filt.to(self.dtype)
        return self


def tresnet_m(num_classes: int = 0,
              dtype: torch.dtype = torch.bfloat16) -> TResNet:
    return TResNet(num_classes=num_classes, dtype=dtype)
