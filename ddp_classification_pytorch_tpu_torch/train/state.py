"""The served model's state — serving's part of the JAX package's
`train/state.py::create_train_state`.

In PyTorch the module holds its own weights, so the "state" the engine
serves and swaps is the `nn.Module` itself.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

from ..config import Config
from ..models.factory import build_model


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
    return model


def create_served_model(cfg: Config, device: torch.device,
                        state_dict: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> nn.Module:
    """Build the served model for `cfg` on `device`: init from `run.seed`
    (or load `state_dict`, e.g. a verified checkpoint), then apply the
    dtype policy once, move to the device in channels_last, and set eval
    mode. Raises ValueError for an arch or head not ported yet."""
    model = build_model(cfg.model, cfg.data.num_classes)
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
