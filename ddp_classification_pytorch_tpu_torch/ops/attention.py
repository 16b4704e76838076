"""Attention ops of the port — the single-device part of the JAX package's
`ops/attention.py`: the dense `attention` and `ring_attention`'s dispatch
when the token axis is not sharded.

Ring attention over a sharded token axis (and its flash-ring body with
`flash_attention_with_lse`) needs two or more devices and is not ported yet
(ROADMAP.md); a mesh axis larger than 1 raises.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30  # finite stand-in for -inf, as in the JAX package


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, scale: Optional[float] = None
              ) -> torch.Tensor:
    """Dense scaled-dot-product attention, (B, T, H, D) → (B, T, H, D) in
    q's dtype: scores and softmax in f32, P cast to v's dtype before P·V
    (f32 accumulation), as `attention.py:47-69`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(tk, device=s.device)[None, :]
                <= torch.arange(tq, device=s.device)[:, None])
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_size: int = 1, causal: bool = False,
                   scale: Optional[float] = None,
                   use_flash: bool = False) -> torch.Tensor:
    """Exact attention over (B, T, H, D). On one device (`axis_size` 1)
    `use_flash` goes to the flash kernels (which route untileable T to the
    dense op) and anything else to the dense op (`attention.py:211-220`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if axis_size > 1:
        raise NotImplementedError(
            "ring attention not yet ported (a token axis sharded over "
            f"{axis_size} devices; ROADMAP.md)")
    if use_flash:
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, scale=scale, causal=causal)
    return attention(q, k, v, causal=causal, scale=scale)
