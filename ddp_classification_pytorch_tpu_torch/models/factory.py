"""Backbone/model construction from ModelConfig — the counterpart of the JAX
package's `models/factory.py` (`factory.py:27-194`): every ported arch
(the ResNets, VGG19-BN, TResNet-M and the ViT family) under the heads
fc, arcface and nested. `freeze_bn` freezes the ResNets' BNs (JAX passes
it to them only, `factory.py:56-59`); on the other archs the BNs keep
batch statistics and only the optimizer's filter applies
(`train/schedule.py::param_groups`). `dropout` reaches the ViTs and
VGG19-BN (`dropout or 0.5` there, so 0 means 0.5, JAX `factory.py:62`).
Anything else is a ValueError (rc 2)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..config import ModelConfig
from . import vit as _vit
from .resnet import DEPTHS as RESNET_DEPTHS
from .heads import ArcEmbedding, ArcMarginHead, NetClassifier
from .resnet import build_resnet
from .tresnet import tresnet_m
from .vgg import WIDTH as VGG_WIDTH
from .vgg import vgg19_bn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute dtype {name!r}; one of "
                         f"{sorted(_DTYPES)}") from None


PORTED_ARCHS = (*RESNET_DEPTHS, "vgg19_bn", "tresnet_m", "timm",
                *_vit.VIT_CONFIGS)
# the ResNets' feature widths (JAX `models/resnet.py::FEAT_DIMS`)
_RESNET_FEAT = {"resnet18": 512, "resnet34": 512, "resnet50": 2048,
                "resnet101": 2048, "resnet152": 2048}


def feat_dim_for(arch: str) -> int:
    """The backbone's feature width, which the arcface embedding and the
    nested mask read (JAX `factory.py:27-38` without `cfg.feat_dim`: the
    port sizes every head from the backbone it builds)."""
    if arch in _RESNET_FEAT:
        return _RESNET_FEAT[arch]
    if arch == "vgg19_bn":
        return VGG_WIDTH
    if arch in ("tresnet_m", "timm"):
        return 2048
    if arch in _vit.FEAT_DIMS:
        return _vit.FEAT_DIMS[arch]
    raise ValueError(f"unknown arch {arch!r}")


def build_backbone(cfg: ModelConfig, num_classes: int = 0,
                   image_size: int = 224,
                   group: Optional[dist.ProcessGroup] = None) -> nn.Module:
    """Backbone emitting features (num_classes=0) or logits. `image_size`
    sizes the ViT position table (the flax model infers it at init).
    `group`: the process group whose ranks share the ResNet and VGG BNs'
    batch statistics in training (TResNet-M and the ViTs take none).
    `remat` reaches the ResNets and the ViTs (VGG19-BN and TResNet-M
    ignore it, as JAX's factory does); `moe_experts` on any other arch is
    a ValueError."""
    if cfg.moe_experts and cfg.arch not in _vit.VIT_CONFIGS:
        raise ValueError(
            f"moe_experts requires a ViT arch (transformer FFN to split); "
            f"got {cfg.arch!r}")
    if cfg.arch in RESNET_DEPTHS:
        return build_resnet(cfg.arch, num_classes=num_classes,
                            variant=cfg.variant,
                            dtype=compute_dtype(cfg.dtype), group=group,
                            freeze_bn=cfg.freeze_bn, remat=cfg.remat)
    if cfg.arch == "vgg19_bn":
        return vgg19_bn(num_classes, compute_dtype(cfg.dtype), group,
                        dropout=cfg.dropout or 0.5)
    if cfg.arch in ("tresnet_m", "timm"):
        # reference `--model timm` → tresnet_m_miil_in21k (BASELINE/main.py:141-144)
        return tresnet_m(num_classes=num_classes, dtype=compute_dtype(cfg.dtype))
    if cfg.arch in _vit.VIT_CONFIGS:
        return _vit.build_vit(
            cfg.arch, num_classes=num_classes, image_size=image_size,
            dtype=compute_dtype(cfg.dtype), dropout=cfg.dropout,
            remat=cfg.remat, use_flash=cfg.flash_attention,
            moe_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
            flash_min_tokens=cfg.flash_min_tokens, ln_bf16=cfg.ln_bf16)
    raise ValueError(f"arch {cfg.arch!r} not yet ported to the torch package "
                     f"(ported: {', '.join(PORTED_ARCHS)})")


class ClassifierModel(nn.Module):
    """backbone → logits (BASELINE/CDR shape)."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)


class ArcFaceModel(nn.Module):
    """backbone → embedding → margin head (the ARCFACE shape). With labels,
    the margin logits for training; `labels=None` gives s·cosθ."""

    def __init__(self, backbone: nn.Module, embedding: ArcEmbedding,
                 margin: ArcMarginHead):
        super().__init__()
        self.backbone, self.embedding, self.margin = backbone, embedding, margin

    def forward(self, x: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.margin(self.features(x), labels)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The embedding (B, arc_embed_dim), f32."""
        return self.embedding(self.backbone(x))


class NestedModel(nn.Module):
    """backbone features → optional prefix mask → bias-free classifier (the
    NESTED shape, NESTED/model/model.py:12-76); `mask=None` gives the
    unmasked logits."""

    def __init__(self, backbone: nn.Module, classifier: NetClassifier):
        super().__init__()
        self.backbone, self.classifier = backbone, classifier

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        feat = self.features(x)
        if mask is not None:
            feat = feat * mask
        return self.classifier(feat)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The pooled backbone features (B, D), f32."""
        return self.backbone(x)

    @property
    def feat_dim(self) -> int:
        """D, the width the prefix mask and the all-K sweep run over."""
        return self.classifier.fc.in_features

    @property
    def classifier_weight(self) -> torch.Tensor:
        """The classifier's (C, D) weight, for the all-K sweep."""
        return self.classifier.fc.weight


HEADS = ("fc", "arcface", "nested")


def build_model(cfg: ModelConfig, num_classes: int, image_size: int = 224,
                group: Optional[dist.ProcessGroup] = None) -> nn.Module:
    if cfg.head not in HEADS:
        raise ValueError(f"unknown head {cfg.head!r}; one of {HEADS}")
    if cfg.head == "fc":
        return ClassifierModel(build_backbone(cfg, num_classes, image_size,
                                              group))
    backbone = build_backbone(cfg, 0, image_size, group)
    feat = feat_dim_for(cfg.arch)
    if cfg.head == "arcface":
        return ArcFaceModel(
            backbone,
            ArcEmbedding(feat, (512, cfg.arc_embed_dim),
                         cfg.arc_log_softmax_quirk),
            ArcMarginHead(num_classes, cfg.arc_embed_dim, cfg.arc_s,
                          cfg.arc_m, cfg.arc_easy_margin))
    return NestedModel(backbone, NetClassifier(feat, num_classes))
