"""LR schedule + optimizer — the port of the JAX package's
`train/schedule.py` for one param group.

`build_schedule` is `step -> lr`, the optax schedules of the JAX package
written out as optax computes them (in float32, except a constant, which
optax returns as given):

- "step": lr · γ^⌊step / (step_size · steps_per_epoch)⌋ (StepLR,
  `optax.exponential_decay(staircase=True)`);
- "multistep": lr times γ for every milestone epoch reached
  (`optax.piecewise_constant_schedule`);
- "constant";
- a linear warmup from `warmup_start_lr` over `warmup_iters` iterations,
  overlaid on the main schedule so its decay milestones stay anchored at
  the true step (`schedule.py:48-62`).

`build_optimizer` gives `torch.optim.SGD(momentum, weight_decay)` or
`Adam(weight_decay)`: PyTorch's coupled weight decay adds wd·p to the
gradient before momentum/Adam, which is optax's `add_decayed_weights`
chained before `sgd`/`adam`. The trainer sets each update's lr from the
schedule at the count of updates applied so far (optax keeps that count
in the optimizer state, so a skipped step does not advance it). The head
param group, CDR's gradient transform and freeze-BN are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from ..config import OptimConfig

Schedule = Callable[[int], float]
_f32 = np.float32


def build_schedule(cfg: OptimConfig, steps_per_epoch: int) -> Schedule:
    if cfg.schedule == "step":
        transition = cfg.step_size * steps_per_epoch
        if transition <= 0:  # optax returns the constant schedule then
            def main(step: int) -> float:
                return cfg.lr
        else:
            def main(step: int) -> float:
                if step <= 0:
                    return float(_f32(cfg.lr))
                p = np.floor(_f32(step) / _f32(transition))
                return float(_f32(cfg.lr) * np.power(_f32(cfg.gamma), _f32(p)))
    elif cfg.schedule == "multistep":
        bounds = sorted({int(m) * steps_per_epoch: cfg.gamma
                         for m in cfg.milestones}.items())

        def main(step: int) -> float:
            v = _f32(cfg.lr)
            for b, s in bounds:
                if step >= b:
                    v = _f32(v * _f32(s))
            return float(v)
    elif cfg.schedule == "constant":
        def main(step: int) -> float:
            return cfg.lr  # optax's constant schedule hands back the value itself
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")

    warmup = max(cfg.warmup_iters, 0)
    if warmup == 0:
        return main
    start, end = _f32(cfg.warmup_start_lr), _f32(cfg.lr)

    def overlaid(step: int) -> float:
        if step >= warmup:  # jnp.where: the f32 of either branch
            return float(_f32(main(step)))
        frac = _f32(1) - _f32(min(max(step, 0), warmup)) / _f32(warmup)
        return float((start - end) * frac + end)

    return overlaid


def build_optimizer(cfg: OptimConfig,
                    params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The optimizer over `params`; its lr is set per update from the
    schedule (the value given here is the schedule's start)."""
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
