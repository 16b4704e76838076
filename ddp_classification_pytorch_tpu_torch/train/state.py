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
import torch.distributed as dist
import torch.nn as nn

from ..config import Config
from ..models.factory import build_model
from ..models.heads import ArcMarginHead
from ..models.import_torch import import_state_dict, load_torch_checkpoint
from ..models.resnet import DEPTHS as RESNET_DEPTHS
from ..models.resnet import ResNet
from ..models.tresnet import TResNet
from ..models.vgg import CFG_E, VGG
from ..models.vit import VIT_CONFIGS
from .schedule import (
    Schedule,
    build_optimizer,
    build_schedule,
    head_config,
    param_groups,
    two_groups,
)

# jax.nn.initializers' truncated normal: the stddev of a standard normal cut
# at ±2, by which `variance_scaling(..., "truncated_normal")` divides
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(w: torch.Tensor, scale: float, fan: int,
                      generator: torch.Generator) -> torch.Tensor:
    """flax's `variance_scaling(scale, mode, "truncated_normal")` in place:
    a normal of σ = sqrt(scale / fan) / _TRUNC_STD cut at ±2σ."""
    std = (scale / fan) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh weights from `generator`: biases zero; BN keeps its
    construction values (γ=1, β=0, mean 0, var 1), as flax's. A ResNet
    starts from the JAX ResNet's distribution: its convs take
    `variance_scaling(2.0, "fan_out", "truncated_normal")` with fan_out =
    O·kh·kw (JAX `models/resnet.py:132-133`), its fc and the heads' Dense
    layers LeCun normal (flax's Dense default, a truncated normal of
    fan_in), and the ArcFace margin's (C, D) weight flax's xavier-uniform,
    U(±sqrt(6 / (C + D))) (JAX `models/heads.py:68-73`). The other archs'
    conv and linear weights are N(0, 1/fan_in). `torch.Generator` and
    `jax.random` give different numbers from one seed; parity tests carry
    weights across with `models/convert.py`."""
    resnet = any(isinstance(m, ResNet) for m in model.modules())
    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
                continue
            fan_in = m.weight[0].numel()
            if resnet and isinstance(m, nn.Conv2d):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                _variance_scaling_(m.weight, 2.0, fan_out, generator)
            elif resnet:
                _variance_scaling_(m.weight, 1.0, fan_in, generator)
            else:
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        for m in model.modules():
            if isinstance(m, ArcMarginHead):
                bound = (6.0 / sum(m.weight.shape)) ** 0.5
                m.weight.uniform_(-bound, bound, generator=generator)
        for name, p in model.named_parameters():
            if name.endswith("pos_embed"):  # the ViT's N(0, 0.02), as flax's
                p.normal_(0.0, 0.02, generator=generator)
    return model


def load_pretrained_(backbone: nn.Module, path: str) -> nn.Module:
    """Overlay a torchvision or timm state dict onto `backbone` in place,
    the converter chosen by the backbone's arch as the JAX
    `_load_pretrained` chooses it (`train/state.py:108-146`): a ResNet or
    VGG19-BN takes torchvision's names, TResNet-M timm's
    (`models/import_torch.py`). The classifier loads only when its shape
    fits the model's head (the reference replaces a 1000-class head:
    otherwise it keeps its init); tensors the file lacks keep their init.
    A key the model does not have, a shape that does not fit, or a file
    with nothing to load is a ValueError."""
    fam = ("vgg" if isinstance(backbone, VGG) else
           "tresnet" if isinstance(backbone, TResNet) else
           "resnet" if isinstance(backbone, ResNet) else None)
    if fam is None:
        raise ValueError(f"no torchvision/timm import for a "
                         f"{type(backbone).__name__} backbone (ported: the "
                         "ResNets, vgg19_bn, tresnet_m)")
    load = import_state_dict(fam, load_torch_checkpoint(path),
                             backbone.state_dict(),
                             getattr(backbone, "cfg", CFG_E))
    backbone.load_state_dict(load, strict=False)
    return backbone


@dataclasses.dataclass
class TrainState:
    """Everything a train step reads and updates.

    `step` counts train steps (skipped ones too); `opt_count` counts the
    updates applied — the count optax keeps in its optimizer state, which
    the schedules read, so a skipped step does not advance the lr.
    `schedule` sets the base group's lr, `head_schedule` that of the head
    group (`train/schedule.py::param_groups`) where there is one."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0
    opt_count: int = 0
    # the DistributedDataParallel wrapper of `model` that the train step
    # runs the forward through (parallel/ddp.py), None without a process
    # group; `model` stays the unwrapped module whose state is saved
    ddp: Optional[nn.Module] = None
    head_schedule: Optional[Schedule] = None
    # the loader's steps an epoch (CDR's live clip schedule is per epoch)
    steps_per_epoch: int = 1

    @property
    def params(self) -> List[nn.Parameter]:
        """The params the optimizer updates (freeze-BN's are not)."""
        return [p for group in self.optimizer.param_groups
                for p in group["params"]]

    def set_lrs(self) -> None:
        """Each group's lr from its schedule at `opt_count`."""
        for group in self.optimizer.param_groups:
            sched = self.head_schedule if group.get("head") else self.schedule
            group["lr"] = sched(self.opt_count)

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
# channels_last on the device
CONV_ARCHS = (*RESNET_DEPTHS, "vgg19_bn", *TRESNET_ARCHS)
TRAIN_ARCHS = (*CONV_ARCHS, *VIT_CONFIGS)


def create_train_state(cfg: Config, device: torch.device,
                       steps_per_epoch: int,
                       group: Optional[dist.ProcessGroup] = None
                       ) -> TrainState:
    """Model with fresh f32 master weights from `run.seed` (or, with
    `model.pretrained`, its backbone overlaid with `pretrained_path`'s
    torchvision or timm weights) on `device`, its optimizer
    (`param_groups`: the head group, freeze-BN) and LR schedules. Every
    ported arch trains under every head; anything else is a ValueError.
    `group` is the process group whose ranks share the ResNet and VGG BNs'
    batch statistics. The conv nets go to the device in channels_last, as K1 and
    its training passes take their activations (weights in NCHW could lead
    cuDNN to hand back NCHW outputs)."""
    if cfg.model.arch not in TRAIN_ARCHS:
        raise ValueError(f"training arch {cfg.model.arch!r} not yet ported "
                         f"to the torch package (ported: "
                         f"{', '.join(TRAIN_ARCHS)}; ROADMAP.md)")
    model = build_model(cfg.model, cfg.data.num_classes, cfg.data.image_size,
                        group)
    init_weights_(model, torch.Generator().manual_seed(cfg.run.seed))
    if cfg.model.pretrained:
        if not cfg.model.pretrained_path:
            raise ValueError("model.pretrained needs model.pretrained_path: "
                             "nothing is downloaded; pass a local .pth "
                             "(a torchvision or timm state_dict, or the "
                             "reference's NESTED format) with "
                             "--pretrained_path")
        load_pretrained_(model.backbone, cfg.model.pretrained_path)
    if cfg.model.arch in CONV_ARCHS:
        model.to(device=device, memory_format=torch.channels_last)
    else:
        model.to(device)
    opt = cfg.optim
    return TrainState(
        model=model,
        optimizer=build_optimizer(
            opt, param_groups(opt, model, cfg.model.freeze_bn)),
        schedule=build_schedule(opt, steps_per_epoch),
        head_schedule=(build_schedule(head_config(opt), steps_per_epoch)
                       if two_groups(opt) else None),
        steps_per_epoch=steps_per_epoch)


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())


def create_served_model(cfg: Config, device: torch.device,
                        state_dict: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> nn.Module:
    """Build the served model for `cfg` on `device`: init from `run.seed`
    (or load `state_dict`, e.g. a verified checkpoint), then apply the
    dtype policy once (the convolutional nets cast their weights to the
    compute dtype; a ViT keeps its f32 masters and casts per call, as in
    training), move to the device (channels_last for the convolutional
    nets), and set eval mode. A ViT built from a config with
    `model.flash_attention` runs the flash forward (K2) in every block at
    T ≥ `flash_min_tokens`. Raises ValueError for an arch or head not
    ported yet."""
    if cfg.model.arch not in TRAIN_ARCHS:
        raise ValueError(f"serving arch {cfg.model.arch!r} not yet ported to "
                         f"the torch package (ported: "
                         f"{', '.join(TRAIN_ARCHS)}; ROADMAP.md)")
    model = build_model(cfg.model, cfg.data.num_classes, cfg.data.image_size)
    if state_dict is None:
        init_weights_(model, torch.Generator().manual_seed(cfg.run.seed))
    else:
        try:
            model.load_state_dict(state_dict)
        except RuntimeError as e:  # missing/unexpected keys, wrong shapes
            raise ValueError(f"weights do not fit {cfg.model.arch} with "
                             f"{cfg.data.num_classes} classes: {e}") from None
    if cfg.model.arch in CONV_ARCHS:
        model.backbone.cast_to_compute_dtype()
        model.to(device=device, memory_format=torch.channels_last)
    else:
        model.to(device)
    return model.eval()
