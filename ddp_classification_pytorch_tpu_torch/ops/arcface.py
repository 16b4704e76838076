"""ArcFace margin math — the port of the JAX package's `ops/arcface.py`,
pure functions in float32 whatever the backbone's compute dtype (the
clamped sqrt near cos²θ ≈ 1 and the acos lose their precision in bf16).

- `margin_splice` (JAX `arcface.py:34-60`): cos θ and a one-hot → the
  scaled margin logits, `(one_hot·phi + (1 − one_hot)·cosine)·s`, the JAX
  arithmetic (no scatter), so both sides round alike.
- `arc_margin_logits` (`:63-80`): normalize the features and the weight
  rows, cos θ, then the splice (ARCFACE/arc_main.py:157-176).
- `arcface_naive_log_logits` (`:83-104`): the reference's naive
  acos/exp ArcFaceNet forward with its `/10` guard (arc_main.py:120-129).
  No path runs it (nor does the JAX package's): it is kept for parity
  with the JAX module, and only the tests call it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    """x / max(‖x‖, eps) along `dim` (`F.normalize`'s rule; JAX
    `arcface.py:28-31`)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(n, eps)


def margin_splice(cosine: torch.Tensor, one_hot: torch.Tensor, s: float = 30.0,
                  m: float = 0.5, easy_margin: bool = False) -> torch.Tensor:
    """cos θ (B, C) + one-hot (B, C) → scaled margin logits. Past the flip
    point cos(θ+m) stops being monotonic: easy margin keeps cos θ where
    cos θ ≤ 0, the hard margin takes the linear penalty cos θ − mm where
    cos θ ≤ cos(π − m) (arc_main.py:164-165)."""
    cos_m, sin_m = math.cos(m), math.sin(m)
    th = math.cos(math.pi - m)
    mm = math.sin(math.pi - m) * m
    sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, 0.0, 1.0))
    phi = cosine * cos_m - sine * sin_m
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        phi = torch.where(cosine > th, phi, cosine - mm)
    return (one_hot * phi + (1.0 - one_hot) * cosine) * s


def cosine_logits(features: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """cos θ (B, C) of the f32 features (B, D) against the weight rows
    (C, D), both L2-normalized."""
    return _l2_normalize(features.float(), 1) @ _l2_normalize(weight.float(), 1).T


def arc_margin_logits(features: torch.Tensor, weight: torch.Tensor,
                      labels: torch.Tensor, s: float = 30.0, m: float = 0.5,
                      easy_margin: bool = False) -> torch.Tensor:
    """Large-margin arc logits (B, C) for cross-entropy: features (B, D),
    weight (C, D) (the `F.linear` layout), labels (B,)."""
    cosine = cosine_logits(features, weight)
    one_hot = F.one_hot(labels.long(), cosine.shape[1]).to(cosine.dtype)
    return margin_splice(cosine, one_hot, s, m, easy_margin)


def arcface_naive_log_logits(features: torch.Tensor, weight_dc: torch.Tensor,
                             m: float = 1.0, s: float = 10.0) -> torch.Tensor:
    """The reference's naive ArcFaceNet forward: weight_dc (D, C) normalized
    per column; log(softmax with margin) per class, with the `/10` guard
    that keeps acos's argument in range (arc_main.py:125)."""
    f = _l2_normalize(features.float(), 1)
    w = _l2_normalize(weight_dc.float(), 0)
    theta = torch.arccos(torch.clamp((f @ w) / 10.0, -1.0, 1.0))
    numerator = torch.exp(s * torch.cos(theta + m))
    plain = torch.exp(s * torch.cos(theta))
    denominator = plain.sum(dim=1, keepdim=True) - plain + numerator
    return torch.log(numerator / denominator)
