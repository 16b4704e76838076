"""Step functions of the port — serving's part of the JAX package's
`train/steps.py`: the uint8 input epilogue and the top-k predict.

PyTorch runs eagerly, so a "step" here is a plain function over the model
and a device tensor; there is nothing to trace or compile.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import Config

# ImageNet normalization constants (the JAX package's data/transforms.py)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def device_input_epilogue(images: torch.Tensor, mean: torch.Tensor,
                          std: torch.Tensor) -> torch.Tensor:
    """uint8 wire → normalized float32, on the device.

    `images` is (B, 3, H, W), the NCHW view of NHWC pixels (channels_last in
    memory); `mean`/`std` are the ImageNet constants as (1, 3, 1, 1) f32 on
    the same device. `(x/255 − μ)/σ` in f32 in the op order of the JAX
    epilogue (`steps.py:86-87`). float32 inputs pass through untouched (the
    host-normalized wire). Serving never flips, so the train-time flip waits
    for the training slice."""
    if images.dtype != torch.uint8:
        return images
    x = images.float() / 255.0
    return (x - mean) / std


def make_topk_predict_step(
    cfg: Config, k: int
) -> Callable[[nn.Module, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """`(model, images (B, H, W, 3)) -> (probs (B, k) f32, indices (B, k)
    int32)` — the serving engine's predict (serve/engine.py).

    `images` lies on the model's device in the wire dtype; the NCHW view
    `permute(0, 3, 1, 2)` of the NHWC batch is already channels_last, so no
    copy is made. The forward runs in eval mode on the running statistics
    under `torch.inference_mode()`; softmax runs on the f32 logits, then
    top-k, so only (B, k) values leave the device. Eval mode has no
    cross-sample op, so bucket padding cannot perturb real rows.
    `cfg.model.head` must be `fc` (the only head ported)."""
    if cfg.model.head != "fc":
        raise ValueError(f"head {cfg.model.head!r} not yet ported to the "
                         "torch package (ported: fc)")
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def step(model: nn.Module, images: torch.Tensor):
        if images.device not in consts:
            consts[images.device] = tuple(
                torch.from_numpy(a).view(1, 3, 1, 1).to(images.device)
                for a in (IMAGENET_MEAN, IMAGENET_STD))
        mean, std = consts[images.device]
        with torch.inference_mode():
            x = device_input_epilogue(images.permute(0, 3, 1, 2), mean, std)
            logits = model(x)
            probs = torch.softmax(logits.float(), dim=-1)
            vals, idx = torch.topk(probs, min(k, probs.shape[-1]), dim=-1)
        return vals, idx.to(torch.int32)

    return step
