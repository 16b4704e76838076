"""CDR's selective-gradient step — the port of the JAX package's
`ops/cdr.py` (parity target `train_one_step`, CDR/main.py:179-215).

After the backward, the gradients of every 2-D and 4-D parameter (Linear
and conv weights; BN and bias vectors pass untouched) are ranked by |g·v|
over their concatenation; the top `nonzero_ratio` fraction keeps its
gradient scaled by `clip`, the rest is zeroed. The JAX package does this
as an optax transform chained before the optimizer; the port applies
`cdr_mask_` to the (param, grad) pairs between the backward (DDP's
averaged gradients) and `optimizer.step()`, so the optimizer's weight
decay and momentum see the masked gradients, as optax's chain does.

The threshold is a rank statistic, `sort(metric)[num − nz]` with nz =
max(int(ratio·num), 1) (JAX `cdr.py:113-122`), so the order of
concatenation does not matter: the port concatenates in module order. A
conv master weight is channels_last, so each tensor is flattened with
`reshape(-1)`.

`cdr_clip_schedule` (`cdr.py:37-48`): the reference's intended gradual
clip (1 → 1 − noise_rate over `num_gradual` epochs) or, with
`dead_schedule` (its actual behaviour, CDR/main.py:227), the constant.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def is_selected(p: torch.Tensor) -> bool:
    """torch's `param.dim() in [2, 4]` (CDR/main.py:190)."""
    return p.dim() in (2, 4)


def cdr_clip_schedule(noise_rate: float, num_gradual: int, n_epochs: int,
                      dead_schedule: bool = True) -> np.ndarray:
    """Per-epoch clip values (float32)."""
    if dead_schedule:
        return np.full(n_epochs, 1.0 - noise_rate, dtype=np.float32)
    ramp = np.linspace(1.0 - noise_rate, 1.0, num=num_gradual)[::-1]
    out = np.full(n_epochs, 1.0 - noise_rate, dtype=np.float32)
    out[: min(num_gradual, n_epochs)] = ramp[: min(num_gradual, n_epochs)]
    return out


def cdr_metric(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """|g·v| of the selected pairs, flattened and concatenated."""
    return torch.cat([(g * v).abs().reshape(-1) for v, g in pairs
                      if is_selected(v)])


def cdr_threshold(metric: torch.Tensor, nonzero_ratio: float) -> torch.Tensor:
    """The nz-th largest |g·v| (0-d), nz = max(int(ratio·num), 1)."""
    num = metric.numel()
    nz = max(int(nonzero_ratio * num), 1)
    return torch.sort(metric).values[num - nz]


def cdr_mask_(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              nonzero_ratio: float, clip: float) -> torch.Tensor:
    """g ← g·((|v·g| ≥ thresh)·clip) in place for every selected (v, g)
    pair; returns the threshold (0-d, on the gradients' device)."""
    with torch.no_grad():
        thresh = cdr_threshold(cdr_metric(pairs), nonzero_ratio)
        for v, g in pairs:
            if is_selected(v):
                g.mul_((v * g).abs().ge(thresh).to(g.dtype) * clip)
    return thresh


def cdr_clip(noise_rate: float, num_gradual: int, dead_schedule: bool,
             opt_count: int, steps_per_epoch: int) -> float:
    """The clip of the update at `opt_count` (JAX `schedule.py:138-153`
    with `cdr.py:101-108`): with the dead schedule the constant 1 −
    noise_rate; else the ramp indexed by min(opt_count // steps_per_epoch,
    len − 1)."""
    if dead_schedule:
        return 1.0 - noise_rate
    sched = cdr_clip_schedule(noise_rate, num_gradual, num_gradual,
                              dead_schedule=False)
    return float(sched[min(opt_count // steps_per_epoch, len(sched) - 1)])
