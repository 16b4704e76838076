"""Backbone/model construction from ModelConfig — the counterpart of the JAX
package's `models/factory.py`, for the archs and heads ported so far."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..config import ModelConfig
from . import vit as _vit
from .resnet import DEPTHS as RESNET_DEPTHS
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
    if cfg.arch in RESNET_DEPTHS:
        return build_resnet(cfg.arch, num_classes=num_classes,
                            variant=cfg.variant,
                            dtype=compute_dtype(cfg.dtype), group=group)
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


def build_model(cfg: ModelConfig, num_classes: int, image_size: int = 224,
                group: Optional[dist.ProcessGroup] = None) -> nn.Module:
    if cfg.head == "fc":
        return ClassifierModel(build_backbone(cfg, num_classes, image_size,
                                              group))
    raise ValueError(f"head {cfg.head!r} not yet ported to the torch package "
                     "(ported: fc)")
