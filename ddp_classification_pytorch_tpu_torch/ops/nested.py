"""Nested-Dropout ops — the port of the JAX package's `ops/nested.py`: the
Gaussian prefix distribution, the training mask, and the all-K evaluation.

- `gaussian_dist` (JAX `nested.py:28-33`): p_i ∝ exp(−((i − mu)/std)²)
  over i = 1..n (NESTED/train.py:93-97), in numpy, bitwise the JAX one.
- `nested_k`: the train step's k, one per step, drawn with numpy from a
  key of (seed + 1, step, _NESTED_FOLD) — the same on every rank, so
  every replica masks alike; under gradient accumulation one per
  microbatch i, keyed on (seed + 1, step, i, _NESTED_FOLD) (JAX folds the
  microbatch into the step's key, `steps.py:455`). `np.random.choice(range(D), p=dist)` is the
  reference's draw (train.py:248); torch cannot reproduce `jax.random`'s
  bits, so parity tests pass the JAX step's k in.
- `prefix_mask` (`:43-47`): keep the first k + 1 feature dims.
- `nested_all_k_logits` (`:50-58`): every truncation's logits, the test
  oracle, O(D·B·C) memory. No path runs it: it is kept for parity with
  the JAX module, and the tests hold the sweep against it.
- `nested_all_k_counts` (`:61-112`): per-K top-1/top-3 correct counts in
  one pass over blocks of `block` feature dims. The running (B, C) logits
  are carried from block to block; within a block `carry[:, None, :] +
  cumsum(f[:, :, None]·w[None], dim=1)` is reduced straight to per-K
  counts (ties against the sample, a non-finite row a miss, rows weighted
  by `mask`), so the (D, B, C) tensor is never built. The JAX scan body is
  jnp, so this is plain PyTorch.
- `best_k` (`:115-122`): argmax of acc_K − 1e-5·K, the smallest K among
  equal accuracies (train.py:143).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.metrics import true_label_rank

_NESTED_FOLD = 0x4E455354  # "NEST"


def gaussian_dist(mu: float, std: float, n: int) -> np.ndarray:
    """p_i ∝ exp(−((i − mu)/std)²), i = 1..n, as float32."""
    i = np.arange(1, n + 1, dtype=np.float64)
    d = np.exp(-(((i - mu) / std) ** 2))
    return (d / d.sum()).astype(np.float32)


def nested_k(seed: int, step: int, feat_dim: int, std: float,
             microbatch: Optional[int] = None) -> int:
    """The k (kept dims − 1) of the train step at `step`, or of its
    `microbatch` under accumulation (None: the step's one k, the key
    every run without accumulation has drawn)."""
    p = gaussian_dist(0.0, std, feat_dim).astype(np.float64)
    key = ((seed + 1, step, _NESTED_FOLD) if microbatch is None
           else (seed + 1, step, microbatch, _NESTED_FOLD))
    rng = np.random.default_rng(key)
    return int(rng.choice(feat_dim, p=p / p.sum()))


def prefix_mask(k, feat_dim: int, dtype=torch.float32,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """mask[d] = 1 for d ≤ k, else 0 (an int k gives (feat_dim,); a tensor
    k of shape S gives (*S, feat_dim))."""
    k = torch.as_tensor(k, device=device)
    d = torch.arange(feat_dim, device=k.device)
    return (d <= k[..., None]).to(dtype)


def nested_all_k_logits(features: torch.Tensor,
                        weight: torch.Tensor) -> torch.Tensor:
    """(D, B, C): logits_K = (f ⊙ m_K)·Wᵀ for every K, from features
    (B, D) and the bias-free classifier's weight (C, D)."""
    contrib = torch.einsum("bd,cd->bdc", features.float(), weight.float())
    return torch.cumsum(contrib, dim=1).movedim(1, 0)


def nested_all_k_counts(features: torch.Tensor, weight: torch.Tensor,
                        labels: torch.Tensor, block: int = 128,
                        mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-K top-1 and top-3 correct counts (two (D,) f32 vectors) of one
    batch: features (B, D), weight (C, D), labels (B,); `mask` (B,) weighs
    the rows (0 for padding)."""
    b, d = features.shape
    if d % block:
        raise ValueError(f"feat_dim {d} must be divisible by block {block}")
    f32, w32 = features.float(), weight.float()
    row_w = (torch.ones(b, device=f32.device) if mask is None
             else mask.float())
    idx = labels.long()[:, None, None]
    carry = torch.zeros(b, weight.shape[0], device=f32.device)
    top1, top3 = [], []
    for lo in range(0, d, block):
        fb, wb = f32[:, lo:lo + block], w32[:, lo:lo + block].T  # (B, G), (G, C)
        cum = carry[:, None, :] + torch.cumsum(fb[:, :, None] * wb[None], dim=1)
        true_logit = cum.gather(2, idx.expand(b, cum.shape[1], 1))  # (B, G, 1)
        rank = true_label_rank(cum, true_logit)  # (B, G)
        ok = torch.isfinite(cum).all(dim=2) * row_w[:, None]
        top1.append(((rank < 1) * ok).sum(dim=0))
        top3.append(((rank < 3) * ok).sum(dim=0))
        carry = cum[:, -1, :]
    return torch.cat(top1), torch.cat(top3)


def best_k(true_pred: torch.Tensor, nb_sample: float) -> Tuple[float, int]:
    """(accuracy at the best K, K): argmax over acc_K − 1e-5·K in f32."""
    n = torch.tensor(nb_sample, dtype=torch.float32)
    acc = true_pred.float().cpu() / n
    score = acc - 1e-5 * torch.arange(true_pred.shape[0], dtype=torch.float32)
    k = int(torch.argmax(score))
    return float(acc[k]), k
