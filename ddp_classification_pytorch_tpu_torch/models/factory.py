"""Backbone/model construction from ModelConfig — the counterpart of the JAX
package's `models/factory.py` (`factory.py:27-194`): every ported arch
(the ResNets, VGG19-BN, TResNet-M and the ViT family) under the heads
fc, arcface and nested. `freeze_bn` freezes the ResNets' BNs (JAX passes
it to them only, `factory.py:56-59`); on the other archs the BNs keep
batch statistics and only the optimizer's filter applies
(`train/schedule.py::param_groups`). `dropout` reaches the ViTs and
VGG19-BN (`dropout or 0.5` there, so 0 means 0.5, JAX `factory.py:62`).
Anything else is a ValueError (rc 2).

A `mesh` (`parallel/mesh.py::Mesh`) with a model axis above 1 gives a ViT
its one role (JAX `factory.py:66-80`): expert parallelism with MoE, ring
attention over the token axis otherwise; and every arch its class-sharded
heads (`class_shard_`). The model is built whole, so `init_weights_`
draws what a one-shard run draws; `shard_params_` then keeps each rank's
slice of the tensors `parallel/mesh.py::shard_dim` names.

`pipeline_microbatches` > 0 builds the pipelined ViT
(`models/pipeline_vit.py`, JAX `factory.py:135-176`): its stages on the
mesh's pipe axis when it is above 1 (`--pp_stages`), else on the model
axis, with JAX's refusals and texts; `shard_params_` keeps this stage's
blocks."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..config import ModelConfig
from . import vit as _vit
from .resnet import DEPTHS as RESNET_DEPTHS
from ..parallel.collectives import all_gather
from ..parallel.mesh import Mesh, shard_dim
from .heads import ArcEmbedding, ArcMarginHead, ClassShardedLinear, NetClassifier
from .pipeline_vit import GPipeArcFaceViT, GPipeViT, gpipe_vit
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
                   group: Optional[dist.ProcessGroup] = None,
                   mesh: Optional[Mesh] = None) -> nn.Module:
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
        axis = mesh.model_group if mesh is not None and mesh.mp > 1 else None
        return _vit.build_vit(
            cfg.arch, num_classes=num_classes, image_size=image_size,
            dtype=compute_dtype(cfg.dtype), dropout=cfg.dropout,
            remat=cfg.remat, use_flash=cfg.flash_attention,
            moe_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
            flash_min_tokens=cfg.flash_min_tokens, ln_bf16=cfg.ln_bf16,
            seq_group=None if cfg.moe_experts else axis,
            moe_group=axis if cfg.moe_experts else None)
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

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                features_only: bool = False) -> torch.Tensor:
        """`features_only`: the embedding alone (the partial-FC CE's input,
        taken through DDP's forward)."""
        if features_only:
            return self.features(x)
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
        """The classifier's (C, D) weight, for the all-K sweep (gathered
        whole when it is class-sharded)."""
        fc = self.classifier.fc
        return all_gather(fc.weight, getattr(fc, "group", None), 0)


HEADS = ("fc", "arcface", "nested")


def build_pipeline_model(cfg: ModelConfig, num_classes: int,
                         image_size: int, mesh: Optional[Mesh],
                         microbatches: int) -> nn.Module:
    """The pipelined ViT under the fc or arcface head (JAX
    `factory.py:135-176`, its refusals and texts in its order). The stage
    axis: pipe when it is above 1, else model (`Mesh.stage_axis`). The
    batch splits over the mesh's other axes above 1 in JAX's check; the
    port computes a data shard's batch whole on each of its model ranks."""
    if cfg.arch not in _vit.VIT_CONFIGS:
        raise ValueError(
            f"pipeline parallelism (--pp_microbatches) requires a ViT "
            f"arch with a homogeneous block stack; got {cfg.arch!r}")
    if mesh is None:
        raise ValueError("pipeline parallelism requires a device mesh")
    if cfg.dropout:
        raise ValueError(
            "pipeline parallelism does not support dropout (the tick "
            "loop carries no per-tick rng); set --dropout 0")
    if cfg.moe_experts:
        raise ValueError(
            "pipeline parallelism and moe_experts both claim the model "
            "axis — one role per config (drop --pp_microbatches or "
            "--moe_experts)")
    group = mesh.stage_axis()[3]

    def backbone(classes: int) -> GPipeViT:
        return GPipeViT(cfg.arch, classes, image_size, microbatches,
                        compute_dtype(cfg.dtype), group, cfg.remat,
                        cfg.ln_bf16, mesh.batch_shards(), mesh.dp)

    if cfg.head == "arcface":
        features = backbone(0)
        return GPipeArcFaceViT(
            features,
            ArcEmbedding(features.dim, (512, cfg.arc_embed_dim),
                         cfg.arc_log_softmax_quirk),
            ArcMarginHead(num_classes, cfg.arc_embed_dim, cfg.arc_s,
                          cfg.arc_m, cfg.arc_easy_margin))
    if cfg.head != "fc":
        raise ValueError(
            f"pipeline parallelism supports head='fc' or 'arcface' "
            f"(got {cfg.head!r})")
    return backbone(num_classes)


def build_model(cfg: ModelConfig, num_classes: int, image_size: int = 224,
                group: Optional[dist.ProcessGroup] = None,
                mesh: Optional[Mesh] = None,
                pipeline_microbatches: int = 0) -> nn.Module:
    """The model of `cfg` under its head, built whole. `group`: the BNs'
    group (the data group under a mesh); `mesh`: the model axis's roles
    and the class-sharded heads (`class_shard_`);
    `pipeline_microbatches` > 0: the pipelined ViT
    (`build_pipeline_model`)."""
    if pipeline_microbatches > 0:
        model = build_pipeline_model(cfg, num_classes, image_size, mesh,
                                     pipeline_microbatches)
        if mesh.mp > 1:
            class_shard_(model, mesh)
        return model
    if cfg.head not in HEADS:
        raise ValueError(f"unknown head {cfg.head!r}; one of {HEADS}")
    if cfg.head == "fc":
        model = ClassifierModel(build_backbone(cfg, num_classes, image_size,
                                               group, mesh))
    else:
        backbone = build_backbone(cfg, 0, image_size, group, mesh)
        feat = feat_dim_for(cfg.arch)
        if cfg.head == "arcface":
            model = ArcFaceModel(
                backbone,
                ArcEmbedding(feat, (512, cfg.arc_embed_dim),
                             cfg.arc_log_softmax_quirk),
                ArcMarginHead(num_classes, cfg.arc_embed_dim, cfg.arc_s,
                              cfg.arc_m, cfg.arc_easy_margin))
        else:
            model = NestedModel(backbone, NetClassifier(feat, num_classes))
    if mesh is not None and mesh.mp > 1:
        class_shard_(model, mesh)
    return model


def class_shard_(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Give the class-dim heads of `model` the model group: each `fc`
    Linear that `shard_dim` names becomes a `ClassShardedLinear` holding
    the same parameters (its place among the modules kept), and the
    margin head computes on its shard."""
    for name, mod in list(model.named_modules()):
        if isinstance(mod, ArcMarginHead):
            mod.group = mesh.model_group
        if not (isinstance(mod, nn.Linear)
                and shard_dim(f"{name}.weight", mod.weight.shape, mesh.mp)
                == 0):
            continue
        sharded = ClassShardedLinear(mod.in_features, mod.out_features,
                                     bias=mod.bias is not None)
        sharded.weight, sharded.bias = mod.weight, mod.bias
        sharded.group = mesh.model_group
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent), attr, sharded)
    return model


def shard_params_(model: nn.Module, mesh: Optional[Mesh]) -> Dict[str, int]:
    """Keep this rank's slice of every parameter `shard_dim` shards, in
    place, and of a pipelined ViT this stage's blocks; returns {name:
    dim} of the class- or expert-sharded parameters. A class dim the
    model axis does not divide is a ValueError (JAX's placement
    error)."""
    dims: Dict[str, int] = {}
    pipe = gpipe_vit(model)
    if pipe is not None:
        pipe.keep_stage_()
    if mesh is None or mesh.mp <= 1:
        return dims
    for name, p in model.named_parameters():
        dim = shard_dim(name, p.shape, mesh.mp)
        if dim is None:
            continue
        size = p.shape[dim]
        if size % mesh.mp:
            raise ValueError(
                f"{name} {tuple(p.shape)} shards its dim {dim} over the "
                f"model axis, which implies that the global size of its "
                f"dimension {dim} should be divisible by {mesh.mp}, but it "
                f"is equal to {size}")
        n = size // mesh.mp
        with torch.no_grad():
            p.data = p.data.narrow(dim, mesh.model_index * n, n).clone()
        dims[name] = dim
    return dims
