"""Torch oracles for checkpoint-import verification — the port's own copy
of the JAX package's `models/torch_oracle.py:38-331`.

From-scratch torch implementations of the torchvision ResNet topology
(v1.5: stride on the Bottleneck's 3x3 conv), torchvision vgg19_bn, and
timm tresnet_m — each with its upstream parameter naming (`conv1`,
`layer1.0.conv1`, `downsample.0/1`, `features.<seq>`, `body.layerL.B`…),
so their `state_dict()`s are exactly the formats `models/import_torch.py`
consumes.

Two consumers:
- the parity tests: randomize every parameter AND buffer, save the
  state_dict, import it into the port's model and require its forward to
  equal the oracle's;
- `cli/verify_import.py`: the same equality check against a REAL `.pth`
  the moment one exists on disk — the oracle strict-loads the real
  state_dict, so the comparison then verifies true pretrained weights.

They re-type public architectures from their published definitions (the
reference's `NESTED/model/imagenet_resnet.py` carries extra vestigial
buffers and a custom forward these oracles deliberately omit).
"""

from __future__ import annotations

import torch
import torch.nn as nn


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module | None = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module | None = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        # v1.5: the stride lives on the 3x3, matching models/resnet.py
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * self.expansion, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return torch.relu(out + identity)


class TorchResNet(nn.Module):
    def __init__(self, block, layers, num_classes: int = 1000):
        super().__init__()
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes: int, blocks: int, stride: int = 1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * block.expansion, 1, stride,
                          bias=False),
                nn.BatchNorm2d(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = x.mean(dim=(2, 3))  # adaptive avg pool to 1x1, flattened
        return self.fc(x)


_DEPTHS = {
    "resnet18": (BasicBlock, [2, 2, 2, 2]),
    "resnet34": (BasicBlock, [3, 4, 6, 3]),
    "resnet50": (Bottleneck, [3, 4, 6, 3]),
    "resnet101": (Bottleneck, [3, 4, 23, 3]),
    "resnet152": (Bottleneck, [3, 8, 36, 3]),
}


def make_torch_resnet(arch: str, num_classes: int = 1000) -> TorchResNet:
    block, layers = _DEPTHS[arch]
    return TorchResNet(block, layers, num_classes)


def randomize_(model: TorchResNet, seed: int = 0) -> None:
    """Randomize every parameter AND buffer so the parity check can catch
    any mapping swap. Torch's defaults would mask whole bug classes:
    running_mean=0/var=1 hides a mean<->var swap, BN weight=1/bias=0 hides
    a scale<->bias swap."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:  # conv / linear weights, fan-in scaled so
                # activations stay O(1) — unscaled noise compounds to ~1e6
                # by layer4 and f32 accumulation noise then swamps tight
                # tolerances
                fan_in = p.numel() // p.shape[0]
                p.normal_(0.0, fan_in ** -0.5, generator=gen)
            elif "weight" in name:  # BN scale
                p.uniform_(0.5, 1.5, generator=gen)
            else:  # biases
                p.normal_(0.0, 0.1, generator=gen)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.2, generator=gen)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 2.0, generator=gen)


class TorchVGG19BN(nn.Module):
    """torchvision vgg19_bn topology with its parameter naming
    (features.<seq>.*, classifier.{0,3,6}.*), re-typed for the same
    zero-egress reason as TorchResNet. Reference role:
    NESTED/model/vgg.py:10-76 wraps exactly this torchvision model."""

    CFG_E = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        layers, c_in = [], 3
        for v in self.CFG_E:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c_in, v, 3, padding=1),
                           nn.BatchNorm2d(v), nn.ReLU(inplace=True)]
                c_in = v
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(inplace=True), nn.Dropout(),
            nn.Linear(4096, 4096), nn.ReLU(inplace=True), nn.Dropout(),
            nn.Linear(4096, num_classes),
        )

    def forward(self, x):
        x = self.features(x)
        return self.classifier(torch.flatten(x, 1))


def make_torch_vgg19_bn(num_classes: int = 1000) -> TorchVGG19BN:
    return TorchVGG19BN(num_classes)


# ------------------------------------------------------ TResNet-M oracle ---
# timm `tresnet_m` topology with timm's parameter naming (body.conv1.{0,1},
# body.layerL.B.convJ.* with the stride-2 conv wrapped as (Sequential(conv,
# bn), blur.filt), se.fc1/fc2 as 1x1 convs, downsample.1.{0,1}, head.fc) —
# the exact key layout convert_tresnet_state_dict consumes. Re-typed from
# the published architecture; the reference selects this model via
# BASELINE/main.py:141-144.

TRESNET_SLOPE = 1e-3


class _SpaceToDepth(nn.Module):
    def forward(self, x):
        b, c, h, w = x.shape
        x = x.view(b, c, h // 4, 4, w // 4, 4)
        x = x.permute(0, 3, 5, 1, 2, 4).contiguous()
        return x.view(b, c * 16, h // 4, w // 4)


class _Blur(nn.Module):
    """Fixed 3x3 binomial depthwise blur, stride 2, pad 1 (buffer `filt`)."""

    def __init__(self, channels):
        super().__init__()
        k = torch.tensor([1.0, 2.0, 1.0])
        k2 = torch.outer(k, k)
        k2 = (k2 / k2.sum()).expand(channels, 1, 3, 3).contiguous()
        self.register_buffer("filt", k2)
        self.channels = channels

    def forward(self, x):
        return torch.nn.functional.conv2d(
            x, self.filt, stride=2, padding=1, groups=self.channels)


def _conv_abn(c_in, c_out, k, activated, aa=False):
    pad = k // 2
    inner = [nn.Conv2d(c_in, c_out, k, 1, pad, bias=False),
             nn.BatchNorm2d(c_out)]
    if activated:
        inner.append(nn.LeakyReLU(TRESNET_SLOPE, inplace=True))
    if aa:
        return nn.Sequential(nn.Sequential(*inner), _Blur(c_out))
    return nn.Sequential(*inner)


class _SE(nn.Module):
    def __init__(self, channels, reduced):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, reduced, 1)
        self.fc2 = nn.Conv2d(reduced, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))
        return x * s


def _downsample(c_in, c_out):
    return nn.Sequential(
        nn.AvgPool2d(2, 2, ceil_mode=True, count_include_pad=False),
        nn.Sequential(nn.Conv2d(c_in, c_out, 1, 1, bias=False),
                      nn.BatchNorm2d(c_out)),
    )


class _TBasic(nn.Module):
    expansion = 1

    def __init__(self, c_in, planes, stride, use_se):
        super().__init__()
        self.conv1 = _conv_abn(c_in, planes, 3, True, aa=(stride == 2))
        self.conv2 = _conv_abn(planes, planes, 3, False)
        self.se = _SE(planes, max(planes // 4, 64)) if use_se else None
        self.downsample = (_downsample(c_in, planes)
                           if stride == 2 or c_in != planes else None)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.se is not None:
            y = self.se(y)
        r = x if self.downsample is None else self.downsample(x)
        return torch.nn.functional.leaky_relu(y + r, TRESNET_SLOPE)


class _TBottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in, planes, stride, use_se):
        super().__init__()
        self.conv1 = _conv_abn(c_in, planes, 1, True)
        self.conv2 = _conv_abn(planes, planes, 3, True, aa=(stride == 2))
        self.se = (_SE(planes, max(planes * self.expansion // 8, 64))
                   if use_se else None)
        self.conv3 = _conv_abn(planes, planes * self.expansion, 1, False)
        self.downsample = (
            _downsample(c_in, planes * self.expansion)
            if stride == 2 or c_in != planes * self.expansion else None)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.se is not None:
            y = self.se(y)
        y = self.conv3(y)
        r = x if self.downsample is None else self.downsample(x)
        return torch.nn.functional.leaky_relu(y + r, TRESNET_SLOPE)


class TorchTResNetM(nn.Module):
    def __init__(self, num_classes: int = 1000):
        super().__init__()
        import collections

        w = 64

        def stage(block, c_in, planes, n, stride, use_se):
            blocks = [block(c_in, planes, stride, use_se)]
            for _ in range(1, n):
                blocks.append(block(planes * block.expansion, planes, 1, use_se))
            return nn.Sequential(*blocks)

        self.s2d = _SpaceToDepth()
        self.body = nn.Sequential(collections.OrderedDict([
            ("conv1", _conv_abn(48, w, 3, True)),
            ("layer1", stage(_TBasic, w, w, 3, 1, True)),
            ("layer2", stage(_TBasic, w, w * 2, 4, 2, True)),
            ("layer3", stage(_TBottleneck, w * 2, w * 4, 11, 2, True)),
            ("layer4", stage(_TBottleneck, w * 16, w * 8, 3, 2, False)),
        ]))
        self.head = nn.Module()
        self.head.fc = nn.Linear(w * 8 * 4, num_classes)

    def forward(self, x):
        x = self.body(self.s2d(x))
        x = x.mean(dim=(2, 3))
        return self.head.fc(x)


def make_torch_tresnet_m(num_classes: int = 1000) -> TorchTResNetM:
    return TorchTResNetM(num_classes)
