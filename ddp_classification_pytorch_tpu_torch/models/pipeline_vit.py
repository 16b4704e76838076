"""The pipelined ViT — the port of the JAX package's
`models/pipeline_vit.py`: a ViT whose block stack runs over the GPipe
executor (`ops/pipeline.py`), its stages on a stage group.

`GPipeViT` (JAX `:32-121`) has JAX's parameter tree under torch's
layouts: the patch conv `patch` (bias added after the conv, in the
compute dtype), `pos_embed`, the blocks `blocks.<i>` (the port's
`models/vit.py::Block` with dense attention, no MoE, no dropout: JAX
builds its pipelined `Block` without flash or a mesh, so no K2-K4 run
here), a hand-written final LayerNorm `ln_f` (eps 1e-6, in f32, or in the
compute dtype under `ln_bf16`: here the flag changes the result, while
the blocks' LayerNorms stay f32 inside), the f32 token mean-pool and
`fc`; `num_classes=0` gives the headless backbone (pooled features).
Its init follows JAX's distributions (`:58-87`): the patch kernel, the
blocks' Dense kernels and `fc` a truncated normal of fan_in
(`variance_scaling(1.0, "fan_in", "truncated_normal")`, flax's Dense
default in the blocks), `pos_embed` N(0, 0.02), biases zero, LayerNorms
γ 1 β 0 (`train/state.py::init_weights_`).

The model is built whole, with all L blocks named by their global index,
so that one seed draws the same weights at any stage count;
`models/factory.py::shard_params_` then keeps this stage's L/S blocks
(`parallel/mesh.py::block_stage`). `remat` recomputes each block whole
in the backward (JAX's plain `jax.checkpoint`).

`GPipeArcFaceViT` (JAX `:124-178`) puts `models/heads.py`'s
`ArcEmbedding` and `ArcMarginHead` on the headless backbone, with
`ArcFaceModel`'s calling convention: `forward(x, labels)` the margin
logits (s·cosθ with `labels=None`), `features` the embedding the
partial-FC CE takes. Over a model group the margin weight is
class-sharded (`factory.class_shard_`): the dp×tp×pp composition.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pipeline import gpipe
from ..parallel.collectives import Group, axis_index, axis_size
from ..parallel.mesh import block_stage, check_stages
from .heads import ArcEmbedding, ArcMarginHead
from .vit import LN_EPS, VIT_CONFIGS, Block


def _block_fn(block: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return block(h)[0]


class GPipeViT(nn.Module):
    """ViT with its block stack pipelined over `group` (None: one stage,
    the blocks in order). `shards` and `data` give JAX's batch check:
    the product of the mesh's other axes above 1, and the data axis over
    which this rank's batch is a shard (the global batch = B × data)."""

    def __init__(self, arch: str, num_classes: int, image_size: int,
                 microbatches: int, dtype: torch.dtype = torch.bfloat16,
                 group: Group = None, remat: bool = False,
                 ln_bf16: bool = False, shards: int = 1, data: int = 1):
        super().__init__()
        patch, dim, depth, heads = VIT_CONFIGS[arch]
        if image_size % patch:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"the patch size {patch}")
        check_stages(depth, axis_size(group))
        self.dim, self.depth, self.dtype = dim, depth, dtype
        self.microbatches, self.group, self.remat = microbatches, group, remat
        self.ln_bf16, self.shards, self.data = ln_bf16, shards, data
        self.num_classes = num_classes
        self.patch = nn.Conv2d(3, dim, patch, stride=patch)
        tokens = (image_size // patch) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        self.blocks = nn.ModuleDict(
            {str(i): Block(dim, heads, dtype) for i in range(depth)})
        self.ln_f = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc = nn.Linear(dim, num_classes) if num_classes > 0 else None

    def keep_stage_(self) -> None:
        """Drop every block another stage owns (after the init)."""
        me, size = axis_index(self.group), axis_size(self.group)
        for key in [k for k in self.blocks
                    if block_stage(int(k), self.depth, size) != me]:
            del self.blocks[key]

    def stage_blocks(self):
        """This stage's blocks, in order."""
        own = sorted(self.blocks, key=int)
        want = self.depth // axis_size(self.group)
        if len(own) != want:
            raise RuntimeError(f"this stage holds {len(own)} blocks, not "
                               f"{want}: keep_stage_() after the init")
        return [self.blocks[k] for k in own]

    def stage_inputs(self):
        """The parameters only stage 0 consumes: their gradient arises
        there alone and is summed over the stage group."""
        return [self.patch.weight, self.patch.bias, self.pos_embed]

    def _ln_f(self, h: torch.Tensor) -> torch.Tensor:
        """JAX's hand-written final LayerNorm (`:104-111`)."""
        dt = self.dtype if self.ln_bf16 else torch.float32
        h = h.to(dt)
        mu = h.mean(dim=-1, keepdim=True)
        var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
        h = (h - mu) * torch.rsqrt(var + LN_EPS)
        return h * self.ln_f.weight.to(dt) + self.ln_f.bias.to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = F.conv2d(x.to(dt), self.patch.weight.to(dt),
                     stride=self.patch.stride)
        h = h + self.patch.bias.to(dt)[:, None, None]
        h = h.flatten(2).transpose(1, 2)  # (B, h*w, C), row-major patches
        h = h + self.pos_embed.to(dt)
        h = gpipe(_block_fn, self.stage_blocks(), h, self.group,
                  self.microbatches, batch=h.shape[0] * self.data,
                  shards=self.shards,
                  remat=self.remat and self.training)
        feats = self._ln_f(h).float().mean(dim=1)
        return self.fc(feats) if self.fc is not None else feats


class GPipeArcFaceViT(nn.Module):
    """The pipelined backbone → embedding → margin head."""

    def __init__(self, backbone: GPipeViT, embedding: ArcEmbedding,
                 margin: ArcMarginHead):
        super().__init__()
        self.backbone, self.embedding, self.margin = backbone, embedding, margin

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                features_only: bool = False) -> torch.Tensor:
        if features_only:
            return self.features(x)
        return self.margin(self.features(x), labels)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The embedding (B, arc_embed_dim), f32."""
        return self.embedding(self.backbone(x))


def gpipe_vit(model: nn.Module) -> Optional[GPipeViT]:
    """The pipelined ViT inside `model`, None when it has none."""
    return next((m for m in model.modules() if isinstance(m, GPipeViT)),
                None)
