"""Model state — the JAX package's `train/state.py`: the training state
(`create_train_state`) and the served model (`create_served_model`).

In PyTorch the module holds its own weights, so the "state" the engine
serves and swaps is the `nn.Module` itself; the training state bundles the
module (f32 master weights) with its optimizer, LR schedule and counters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.nn as nn

from ..config import Config
from ..models.factory import build_model
from ..models.vit import VIT_CONFIGS
from .schedule import Schedule, build_optimizer, build_schedule


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh weights from `generator`: conv and linear weights
    N(0, 1/fan_in) (LeCun normal, the flax default) and zero biases; BN
    keeps its construction values (γ=1, β=0, mean 0, var 1), as flax's.
    `torch.Generator` and `jax.random` give different numbers from one
    seed; parity tests carry weights across with `models/convert.py`."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith("pos_embed"):  # the ViT's N(0, 0.02), as flax's
                p.normal_(0.0, 0.02, generator=generator)
    return model


@dataclasses.dataclass
class TrainState:
    """Everything a train step reads and updates.

    `step` counts train steps (skipped ones too); `opt_count` counts the
    updates applied — the count optax keeps in its optimizer state, which
    the schedule reads, so a skipped step does not advance the lr."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0
    opt_count: int = 0

    @property
    def params(self) -> List[nn.Parameter]:
        return [p for group in self.optimizer.param_groups
                for p in group["params"]]

    def state_dict(self) -> Dict[str, Any]:
        """What resuming needs: the model's f32 master weights and buffers
        (BN running statistics), the optimizer's state (momentum buffers),
        `step` and `opt_count` (the count the schedule reads)."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "opt_count": self.opt_count}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        """Restore `state_dict()`'s output in place: tensors are copied into
        the model's own, and the optimizer's state is moved to each
        parameter's device and dtype. Raises ValueError when `sd` is not
        a train state or does not fit the model."""
        missing = [k for k in ("model", "optimizer", "step", "opt_count")
                   if k not in sd]
        if missing:
            raise ValueError(f"not a train-state checkpoint (no "
                             f"{', '.join(missing)}): it holds weights only "
                             "and cannot be resumed from")
        try:
            self.model.load_state_dict(sd["model"])
            self.optimizer.load_state_dict(sd["optimizer"])
        except (RuntimeError, KeyError) as e:  # other keys or shapes
            raise ValueError(f"checkpoint does not fit this model and "
                             f"optimizer: {e}") from None
        self.step, self.opt_count = int(sd["step"]), int(sd["opt_count"])


TRESNET_ARCHS = ("tresnet_m", "timm")
TRAIN_ARCHS = (*TRESNET_ARCHS, *VIT_CONFIGS)


def create_train_state(cfg: Config, device: torch.device,
                       steps_per_epoch: int) -> TrainState:
    """Model with fresh f32 master weights from `run.seed` on `device`, its
    optimizer and LR schedule. Training is ported for TResNet-M and the ViT
    family; anything else is a ValueError. TResNet-M goes to the device in
    channels_last, as K1 and its training passes take their activations
    (weights in NCHW could lead cuDNN to hand back NCHW outputs)."""
    if cfg.model.arch not in TRAIN_ARCHS:
        raise ValueError(f"training arch {cfg.model.arch!r} not yet ported "
                         f"to the torch package (ported: "
                         f"{', '.join(TRAIN_ARCHS)}; ROADMAP.md)")
    model = build_model(cfg.model, cfg.data.num_classes, cfg.data.image_size)
    init_weights_(model, torch.Generator().manual_seed(cfg.run.seed))
    if cfg.model.arch in TRESNET_ARCHS:
        model.to(device=device, memory_format=torch.channels_last)
    else:
        model.to(device)
    return TrainState(model=model,
                      optimizer=build_optimizer(cfg.optim, model.parameters()),
                      schedule=build_schedule(cfg.optim, steps_per_epoch))


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.params)


def create_served_model(cfg: Config, device: torch.device,
                        state_dict: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> nn.Module:
    """Build the served model for `cfg` on `device`: init from `run.seed`
    (or load `state_dict`, e.g. a verified checkpoint), then apply the
    dtype policy once, move to the device in channels_last, and set eval
    mode. Raises ValueError for an arch or head not ported yet."""
    if cfg.model.arch not in TRESNET_ARCHS:
        raise ValueError(f"serving arch {cfg.model.arch!r} not yet ported to "
                         "the torch package (ported: tresnet_m, timm; "
                         "ROADMAP.md)")
    model = build_model(cfg.model, cfg.data.num_classes, cfg.data.image_size)
    if state_dict is None:
        init_weights_(model, torch.Generator().manual_seed(cfg.run.seed))
    else:
        try:
            model.load_state_dict(state_dict)
        except RuntimeError as e:  # missing/unexpected keys, wrong shapes
            raise ValueError(f"weights do not fit {cfg.model.arch} with "
                             f"{cfg.data.num_classes} classes: {e}") from None
    model.backbone.cast_to_compute_dtype()
    model.to(device=device, memory_format=torch.channels_last)
    return model.eval()
