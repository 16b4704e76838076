"""Vision Transformer backbones — the port of the JAX package's
`models/vit.py` on one device: stride-16 conv patch embedding, learned f32
position embedding (no CLS token), pre-LN blocks with multi-head attention
and a 4× GELU MLP, f32 final LayerNorm, f32 token mean-pool, f32 head.

The flax dtype policy is written out, not left to `autocast`: parameters
are f32 (the master weights); a `Dense(dtype=bf16)` casts its input, kernel
and bias to the compute dtype for the product and returns the compute
dtype; LayerNorms run in f32 (eps 1e-6, flax's) and cast their output to
the compute dtype; flax's `nn.gelu` is the tanh approximation.

`use_flash` sends attention to the flash kernels (ops/flash_attention.py)
when the token count reaches `flash_min_tokens`, else to the dense op —
`vit.py:63-70`.

The block options (JAX `vit.py:90-216`):

- `moe_experts` E > 0 replaces each block's MLP by the dropless split-FFN
  mixture of experts of `ops/moe.py` (hidden 4·dim/E per expert, so the
  parameters and FLOPs are the MLP's), under JAX's names and layouts:
  `moe_router` (C, E), `moe_w_in` (E, C, H), `moe_b_in` (E, H),
  `moe_w_out` (E, H, C), `moe_b_out` (E, C). Each block's balance penalty
  is handed out through the block's return value; the ViT's forward sums
  them into `moe_aux`, which the train step takes (`pop_moe_aux`) and
  adds ×`moe_aux_weight` to the loss. MoE with dropout, an E that does not
  divide 4·dim and a `moe_top_k` outside [1, E] are ValueErrors at build.
- `dropout` p > 0: flax's Dropout after the MLP's GELU and nowhere else
  (`models/dropout.py`). The ViT draws each block's keep mask before the
  block and passes it in.
- `remat`: in training each block is rematerialized under JAX's
  `checkpoint_dots` policy (`models/remat.py::remat_dots`): the products'
  outputs are kept, the rest (the flash forward K2 included) is
  recomputed in the backward, so K2 runs twice a block a step.
- `ln_bf16` is accepted and changes nothing: flax's LayerNorm computes its
  statistics and affine in f32 whatever its dtype and casts only the
  output, so `LayerNorm(dtype=bf16)` is bitwise the f32 LayerNorm
  followed by the cast to bf16 that every block already makes.
  `ln_final` is f32 either way, as in JAX.

The model axis (JAX `vit.py:39-72,90-216`, `factory.py:66-80`) serves one
role a config. Without MoE, `seq_group` shards the tokens over the model
group: after the position embedding each rank keeps its T/N tokens
(`ops/attention.py::shard_tokens`, JAX's "not divisible by ring size"
text otherwise), every attention layer runs ring attention over the group
(the flash body under `use_flash`, whatever `flash_min_tokens` says: the
ring path is exempt, as JAX's), a dropout mask is drawn for all T tokens
and sliced, and the mean pool, which commutes with the shard, sums this
rank's tokens and `psum`s over the group before ÷T. Every parameter
before the pool then sees only this rank's tokens: its gradient is
summed over the group after the backward (`token_sharded_params`). With
MoE, `moe_group` shards the experts (`ops/moe.py::moe_mlp`); the tokens
stay whole. The pipeline (GPipe) path is `models/pipeline_vit.py`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import ring_attention, shard_tokens
from ..ops.moe import load_balance_loss, moe_mlp, router_logits, topk_gates
from ..parallel.collectives import Group, axis_size, psum
from .dropout import Dropout
from .remat import remat_dots

# name → (patch, dim, depth, heads). feat dim == dim (backbone contract).
VIT_CONFIGS = {
    "vit_t16": (16, 192, 12, 3),
    "vit_s16": (16, 384, 12, 6),
    "vit_b16": (16, 768, 12, 12),
}
FEAT_DIMS = {name: dim for name, (_, dim, _, _) in VIT_CONFIGS.items()}
LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


class Dense(nn.Linear):
    """flax `nn.Dense(dtype=...)`: f32 parameters, the product and its
    output in the compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm(dtype=float32)`: statistics and affine in f32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class MHA(nn.Module):
    """Multi-head self-attention over (B, T, C) tokens."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype,
                 use_flash: bool = False, flash_min_tokens: int = 0,
                 group: Group = None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.use_flash, self.flash_min_tokens = use_flash, flash_min_tokens
        self.group = group  # the token axis's ring, None when unsharded
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        qkv = self.qkv(x).view(b, t, 3, self.heads, self.dim // self.heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        use_flash = self.use_flash and (self.group is not None
                                        or t >= self.flash_min_tokens)
        out = ring_attention(q, k, v, self.group, use_flash=use_flash)
        return self.proj(out.reshape(b, t, self.dim))


def xavier_uniform_(w: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's `xavier_uniform()` in place: U(±sqrt(6 / (fan_in + fan_out)))
    with fan_in = shape[-2]·r and fan_out = shape[-1]·r, r the product of
    the leading dims (an expert bank's E counts into both fans)."""
    r = math.prod(w.shape[:-2])
    bound = math.sqrt(6.0 / ((w.shape[-2] + w.shape[-1]) * r))
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


# a MoE block's expert params, under their flax names; the weights among
# them take xavier-uniform, the biases zeros
MOE_PARAMS = ("moe_router", "moe_w_in", "moe_b_in", "moe_w_out", "moe_b_out")
MOE_WEIGHTS = ("moe_router", "moe_w_in", "moe_w_out")


class Block(nn.Module):
    """Pre-LN transformer block: LN→MHA→res, LN→MLP(4×, GELU[, dropout])
    →res, or LN→mixture of experts→res with `moe_experts` > 0. `forward(x,
    keep)` returns (x, aux): `keep` the dropout mask of this call (drawn
    by the caller), aux the MoE balance penalty (None without MoE)."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype,
                 use_flash: bool = False, flash_min_tokens: int = 0,
                 dropout: float = 0.0, moe_experts: int = 0,
                 moe_top_k: int = 2, seq_group: Group = None,
                 moe_group: Group = None):
        super().__init__()
        self.dtype, self.moe_group = dtype, moe_group
        self.ln1 = LayerNorm(dim)
        self.attn = MHA(dim, heads, dtype, use_flash, flash_min_tokens,
                        seq_group)
        self.ln2 = LayerNorm(dim)
        self.drop = Dropout(dropout)
        self.moe_experts, self.moe_top_k = moe_experts, moe_top_k
        if moe_experts <= 0:
            self.mlp_in = Dense(dim, 4 * dim, dtype)
            self.mlp_out = Dense(4 * dim, dim, dtype)
            return
        e = moe_experts
        if dropout:
            raise ValueError(
                "moe_experts does not support dropout (the expert mix "
                "has no dropout slot); set --dropout 0")
        if (4 * dim) % e:
            raise ValueError(
                f"moe_experts={e} must divide the FFN hidden width "
                f"{4 * dim} (split-FFN param/FLOP parity)")
        if not 1 <= moe_top_k <= e:
            raise ValueError(f"top_k={moe_top_k} must be in [1, "
                             f"num_experts={e}]")
        n = axis_size(moe_group)
        if e % n:  # moe_mlp's refusal, at build
            raise ValueError(f"num experts {e} not divisible by axis size "
                             f"{n}")
        hidden = (4 * dim) // e
        self.moe_router = nn.Parameter(torch.empty(dim, e))
        self.moe_w_in = nn.Parameter(torch.empty(e, dim, hidden))
        self.moe_b_in = nn.Parameter(torch.zeros(e, hidden))
        self.moe_w_out = nn.Parameter(torch.empty(e, hidden, dim))
        self.moe_b_out = nn.Parameter(torch.zeros(e, dim))
        for name in MOE_WEIGHTS:
            xavier_uniform_(getattr(self, name))

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = x + self.attn(self.ln1(x).to(self.dtype))
        y = self.ln2(x).to(self.dtype)
        if self.moe_experts > 0:
            logits = router_logits(y, self.moe_router)
            gates = topk_gates(logits, self.moe_top_k)
            aux = load_balance_loss(logits, self.moe_top_k)
            return x + moe_mlp(y, gates, self.moe_w_in, self.moe_b_in,
                               self.moe_w_out, self.moe_b_out,
                               self.dtype, self.moe_group), aux
        y = self.drop(F.gelu(self.mlp_in(y), approximate="tanh"), keep)
        return x + self.mlp_out(y), None


class ViT(nn.Module):
    """ViT backbone → pooled f32 feature (num_classes=0) or f32 logits.
    Takes (B, 3, H, W) images; `image_size` fixes the position table.
    After a forward with MoE blocks, `moe_aux` holds the sum of their
    balance penalties (None otherwise)."""

    def __init__(self, patch: int = 16, dim: int = 384, depth: int = 12,
                 heads: int = 6, num_classes: int = 0, image_size: int = 224,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = False,
                 flash_min_tokens: int = 0, dropout: float = 0.0,
                 remat: bool = False, moe_experts: int = 0,
                 moe_top_k: int = 2, ln_bf16: bool = False,
                 seq_group: Group = None, moe_group: Group = None):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"the patch size {patch}")
        self.dtype, self.remat, self.seq_group = dtype, remat, seq_group
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch)
        tokens = (image_size // patch) ** 2
        if seq_group is not None:
            shard_tokens(torch.empty(0, tokens), seq_group)  # divisible?
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        self.blocks = nn.ModuleList(
            Block(dim, heads, dtype, use_flash, flash_min_tokens, dropout,
                  moe_experts, moe_top_k, seq_group, moe_group)
            for _ in range(depth))
        self.ln_final = LayerNorm(dim)
        self.fc = nn.Linear(dim, num_classes) if num_classes > 0 else None
        self.moe_aux: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w, bias = self.patch_embed.weight, self.patch_embed.bias
        x = F.conv2d(x.to(dt), w.to(dt), bias.to(dt),
                     stride=self.patch_embed.stride)
        x = x.flatten(2).transpose(1, 2)  # (B, h*w, C), row-major patches
        x = x + self.pos_embed.to(dt)
        tokens = x.shape[1]
        if self.seq_group is not None:
            x = shard_tokens(x, self.seq_group)
        remat = self.remat and self.training and torch.is_grad_enabled()
        aux = None
        for block in self.blocks:
            keep = None
            if block.drop.active():  # drawn for every token, then sliced
                keep = block.drop.draw((x.shape[0], tokens, 4 * x.shape[2]),
                                       x.device)
                if self.seq_group is not None:
                    keep = shard_tokens(keep, self.seq_group)
            x, a = remat_dots(block, x, keep) if remat else block(x, keep)
            if a is not None:
                aux = a if aux is None else aux + a
        self.moe_aux = aux
        x = self.ln_final(x)  # f32
        if self.seq_group is not None:
            x = psum(x.sum(dim=1), self.seq_group) / tokens
        else:
            x = x.mean(dim=1)
        return self.fc(x) if self.fc is not None else x

    def token_sharded_params(self):
        """The parameters whose gradient covers only this rank's tokens
        (everything before the pool) when the tokens are sharded; none
        otherwise."""
        if self.seq_group is None:
            return []
        return [p for name, p in self.named_parameters()
                if not name.startswith("fc.")]


def pop_moe_aux(model: nn.Module) -> Optional[torch.Tensor]:
    """The summed MoE balance penalty of `model`'s last forward (its ViT
    backbone's `moe_aux`), cleared so that its graph is not kept; None
    without MoE blocks."""
    for m in model.modules():
        if isinstance(m, ViT):
            aux, m.moe_aux = m.moe_aux, None
            return aux
    return None


def build_vit(arch: str, num_classes: int = 0, image_size: int = 224,
              dtype: torch.dtype = torch.bfloat16, dropout: float = 0.0,
              remat: bool = False, use_flash: bool = False,
              moe_experts: int = 0, moe_top_k: int = 2,
              flash_min_tokens: int = 0, ln_bf16: bool = False,
              seq_group: Group = None, moe_group: Group = None) -> ViT:
    patch, dim, depth, heads = VIT_CONFIGS[arch]
    return ViT(patch=patch, dim=dim, depth=depth, heads=heads,
               num_classes=num_classes, image_size=image_size, dtype=dtype,
               use_flash=use_flash, flash_min_tokens=flash_min_tokens,
               dropout=dropout, remat=remat, moe_experts=moe_experts,
               moe_top_k=moe_top_k, ln_bf16=ln_bf16, seq_group=seq_group,
               moe_group=moe_group)
