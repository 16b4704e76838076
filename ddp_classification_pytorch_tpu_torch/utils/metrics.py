"""Top-k counts — the port of the JAX package's `utils/metrics.py`
rank-count rule (`metrics.py:24-57`).

The true class's rank is the number of classes scoring at or above it,
itself excluded: exact ties count AGAINST the sample, and a row with any
non-finite logit is a miss. `torch.topk` breaks ties by class index
instead, so it is not used here.
"""

from __future__ import annotations

import torch


def true_label_rank(logits: torch.Tensor, true_logit: torch.Tensor) -> torch.Tensor:
    """Classes ranked at or above the true class, itself excluded (JAX
    `metrics.py:24-31`): `>=` counts ties against the sample. NaN compares
    all-False, giving rank -1, so callers pair this with a finite guard."""
    return (logits >= true_logit).sum(dim=-1) - 1


def topk_hits(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Per-sample bool: is the true label within the top-k logits?"""
    true_logit = logits.gather(-1, labels.long()[..., None])
    rank = true_label_rank(logits, true_logit)
    finite = torch.isfinite(logits).all(dim=-1)
    return (rank < k) & finite


def topk_correct(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Number of samples whose true label is within the top-k logits."""
    return topk_hits(logits, labels, min(k, logits.shape[-1])).sum()
