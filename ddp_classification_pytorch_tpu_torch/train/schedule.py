"""LR schedule + optimizer — the port of the JAX package's
`train/schedule.py`.

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
chained before `sgd`/`adam`. The trainer sets each update's lr from its
group's schedule at the count of updates applied so far (optax keeps that
count in the optimizer state, so a skipped step does not advance it).

`param_groups` forms the optimizer's groups from a model (JAX
`schedule.py:84-162`):

- **The head group.** With `head_lr` or `head_weight_decay` set, the
  params under `margin.` (the ArcFace margin head, the reference's second
  optimizer group, arc_main.py:248-253) form a group with that lr and
  weight decay, under a schedule of the same shape (`head_config`); the
  rest form the base group. A model without a margin head is a ValueError
  (JAX `:117-124`).
- **Freeze-BN.** The params that the JAX package's `_is_bn_param` matches
  on their flax paths (`models/convert.py::flax_path`) are in no group: no
  decay, no momentum, no update — JAX's `set_to_zero` at the end of the
  chain (`:155-162`). They keep `requires_grad`, so their gradients still
  enter the grad norm (JAX `steps.py:647`). The matcher misses the four
  downsample BNs (`…/downsample_bn/scale` holds none of its substrings),
  so it freezes 98 of ResNet-50's 106 BN tensors; the port freezes the
  same 98 (ROADMAP.md §3: the reference freezes all of them). On the
  other archs (`frozen_bn_names`) only this filter applies: their BNs
  keep batch statistics in training, as JAX's (ROADMAP.md §3).

CDR's gradient transform is `ops/cdr.py::cdr_mask_`, applied by the train
step before `optimizer.step()`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List

import numpy as np
import torch
import torch.nn as nn

from ..config import OptimConfig
from ..models.convert import flax_path
from ..models.vgg import CFG_E, VGG

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
                    params: Iterable) -> torch.optim.Optimizer:
    """The optimizer over `params` (parameters, or the groups of
    `param_groups`); each group's lr is set per update from its schedule
    (the value given here is the schedule's start)."""
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


# the top-level module whose params form the head group (JAX
# `schedule.py:81`: the ArcFaceModel's "margin" subtree)
HEAD_GROUP = "margin"


def is_bn_param(path: str) -> bool:
    """The JAX package's `_is_bn_param` (`schedule.py:65-67`) on a
    "/"-joined flax param path."""
    keys = path.lower()
    return ("batchnorm" in keys or "bn_" in keys or keys.endswith("_bn")
            or "/bn" in keys)


def frozen_bn_names(model: nn.Module) -> List[str]:
    """The names of the params freeze-BN leaves out of the update: on
    ResNet-50 98 of its 106 BN tensors (above), on TResNet-M the γ/β of
    its 24 identity BNs (`bn2`, `bn3`, `bn_down`; no activated ABN's), on
    VGG19-BN all 16 BNs' γ/β, on a ViT none."""
    vgg_cfg = next((m.cfg for m in model.modules() if isinstance(m, VGG)),
                   CFG_E)
    return [n for n, _ in model.named_parameters()
            if is_bn_param(flax_path(n, vgg_cfg))]


def head_config(cfg: OptimConfig) -> OptimConfig:
    """The head group's hyperparameters: `head_lr` / `head_weight_decay`
    where set, else the base group's."""
    return dataclasses.replace(
        cfg, lr=cfg.lr if cfg.head_lr is None else cfg.head_lr,
        weight_decay=(cfg.weight_decay if cfg.head_weight_decay is None
                      else cfg.head_weight_decay))


def two_groups(cfg: OptimConfig) -> bool:
    return cfg.head_lr is not None or cfg.head_weight_decay is not None


def param_groups(cfg: OptimConfig, model: nn.Module,
                 freeze_bn: bool = False) -> List[Dict]:
    """The optimizer's param groups for `model`: one (the base), or the
    base then the head (`"head": True`, with its own lr and weight decay);
    freeze-BN's params in none."""
    frozen = set(frozen_bn_names(model)) if freeze_bn else set()
    named = [(n, p) for n, p in model.named_parameters() if n not in frozen]
    if not two_groups(cfg):
        return [{"params": [p for _, p in named]}]
    head = [p for n, p in named if n.split(".")[0] == HEAD_GROUP]
    if not head:
        raise ValueError(
            f"head_lr/head_weight_decay set but the model has no "
            f"{HEAD_GROUP!r} head param group (top-level modules: "
            f"{sorted({n.split('.')[0] for n, _ in named})}); these flags "
            "apply to the ArcFace margin head")
    hc = head_config(cfg)
    return [{"params": [p for n, p in named if n.split(".")[0] != HEAD_GROUP]},
            {"params": head, "lr": hc.lr, "weight_decay": hc.weight_decay,
             "head": True}]
