"""Backbone/model construction from ModelConfig — the counterpart of the JAX
package's `models/factory.py` (`factory.py:86-194`), for the archs and
heads ported so far: head `fc` on every ported arch, heads `arcface` and
`nested` (and `freeze_bn`) on the ResNets; the rest is a ValueError (rc 2)
naming ROADMAP.md."""

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

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute dtype {name!r}; one of "
                         f"{sorted(_DTYPES)}") from None


PORTED_ARCHS = (*RESNET_DEPTHS, "tresnet_m", "timm", *_vit.VIT_CONFIGS)


def build_backbone(cfg: ModelConfig, num_classes: int = 0,
                   image_size: int = 224,
                   group: Optional[dist.ProcessGroup] = None) -> nn.Module:
    """Backbone emitting features (num_classes=0) or logits. `image_size`
    sizes the ViT position table (the flax model infers it at init).
    `group`: the process group whose ranks share the ResNet BNs' batch
    statistics in training (the other archs take none)."""
    if cfg.freeze_bn and cfg.arch not in RESNET_DEPTHS:
        raise ValueError(f"freeze_bn is ported for the ResNets, not "
                         f"{cfg.arch!r} (ROADMAP.md)")
    if cfg.arch in RESNET_DEPTHS:
        return build_resnet(cfg.arch, num_classes=num_classes,
                            variant=cfg.variant,
                            dtype=compute_dtype(cfg.dtype), group=group,
                            freeze_bn=cfg.freeze_bn)
    if cfg.arch in ("tresnet_m", "timm"):
        # reference `--model timm` → tresnet_m_miil_in21k (BASELINE/main.py:141-144)
        return tresnet_m(num_classes=num_classes, dtype=compute_dtype(cfg.dtype))
    if cfg.arch in _vit.VIT_CONFIGS:
        return _vit.build_vit(
            cfg.arch, num_classes=num_classes, image_size=image_size,
            dtype=compute_dtype(cfg.dtype), dropout=cfg.dropout,
            remat=cfg.remat, use_flash=cfg.flash_attention,
            moe_experts=cfg.moe_experts,
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
    if cfg.arch not in RESNET_DEPTHS:
        raise ValueError(f"head {cfg.head!r} is ported for the ResNets, not "
                         f"{cfg.arch!r} (ROADMAP.md)")
    backbone = build_backbone(cfg, 0, image_size, group)
    if cfg.head == "arcface":
        return ArcFaceModel(
            backbone,
            ArcEmbedding(backbone.num_features, (512, cfg.arc_embed_dim),
                         cfg.arc_log_softmax_quirk),
            ArcMarginHead(num_classes, cfg.arc_embed_dim, cfg.arc_s,
                          cfg.arc_m, cfg.arc_easy_margin))
    return NestedModel(backbone, NetClassifier(backbone.num_features,
                                               num_classes))
