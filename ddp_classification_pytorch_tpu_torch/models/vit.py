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
`vit.py:63-70`. Not ported yet (ROADMAP.md), and refused with a ValueError:
`moe_experts`, `remat`, `ln_bf16`, `dropout > 0`, and the pipeline and
ring (token-sharded) paths.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import ring_attention

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
                 use_flash: bool = False, flash_min_tokens: int = 0):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.use_flash, self.flash_min_tokens = use_flash, flash_min_tokens
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        qkv = self.qkv(x).view(b, t, 3, self.heads, self.dim // self.heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        use_flash = self.use_flash and t >= self.flash_min_tokens
        out = ring_attention(q, k, v, use_flash=use_flash)
        return self.proj(out.reshape(b, t, self.dim))


class Block(nn.Module):
    """Pre-LN transformer block: LN→MHA→res, LN→MLP(4×, GELU)→res."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype,
                 use_flash: bool = False, flash_min_tokens: int = 0):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(dim)
        self.attn = MHA(dim, heads, dtype, use_flash, flash_min_tokens)
        self.ln2 = LayerNorm(dim)
        self.mlp_in = Dense(dim, 4 * dim, dtype)
        self.mlp_out = Dense(4 * dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x).to(self.dtype))
        y = self.ln2(x).to(self.dtype)
        y = self.mlp_out(F.gelu(self.mlp_in(y), approximate="tanh"))
        return x + y


class ViT(nn.Module):
    """ViT backbone → pooled f32 feature (num_classes=0) or f32 logits.
    Takes (B, 3, H, W) images; `image_size` fixes the position table."""

    def __init__(self, patch: int = 16, dim: int = 384, depth: int = 12,
                 heads: int = 6, num_classes: int = 0, image_size: int = 224,
                 dtype: torch.dtype = torch.bfloat16, use_flash: bool = False,
                 flash_min_tokens: int = 0):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"the patch size {patch}")
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch)
        tokens = (image_size // patch) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        self.blocks = nn.ModuleList(
            Block(dim, heads, dtype, use_flash, flash_min_tokens)
            for _ in range(depth))
        self.ln_final = LayerNorm(dim)
        self.fc = nn.Linear(dim, num_classes) if num_classes > 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w, bias = self.patch_embed.weight, self.patch_embed.bias
        x = F.conv2d(x.to(dt), w.to(dt), bias.to(dt),
                     stride=self.patch_embed.stride)
        x = x.flatten(2).transpose(1, 2)  # (B, h*w, C), row-major patches
        x = x + self.pos_embed.to(dt)
        for block in self.blocks:
            x = block(x)
        x = self.ln_final(x).mean(dim=1)  # f32
        return self.fc(x) if self.fc is not None else x


def build_vit(arch: str, num_classes: int = 0, image_size: int = 224,
              dtype: torch.dtype = torch.bfloat16, dropout: float = 0.0,
              remat: bool = False, use_flash: bool = False,
              moe_experts: int = 0, flash_min_tokens: int = 0,
              ln_bf16: bool = False) -> ViT:
    refused = [name for name, on in (("moe_experts", moe_experts > 0),
                                     ("remat", remat), ("ln_bf16", ln_bf16),
                                     ("dropout > 0", dropout > 0)) if on]
    if refused:
        raise ValueError(f"ViT {', '.join(refused)} not yet ported to the "
                         "torch package (ROADMAP.md)")
    patch, dim, depth, heads = VIT_CONFIGS[arch]
    return ViT(patch=patch, dim=dim, depth=depth, heads=heads,
               num_classes=num_classes, image_size=image_size, dtype=dtype,
               use_flash=use_flash, flash_min_tokens=flash_min_tokens)
