"""The serving engine's devices — the port's counterpart of the JAX
package's `parallel/mesh.py::serve_mesh`.

Serving is pure data parallelism: a padded bucket splits into equal row
blocks, one a device, each device holding its own replica of the model
(`serve/engine.py`). There is no model axis to feed, so a list of devices
is the whole mesh.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def visible_devices(device: torch.device) -> List[torch.device]:
    """Every device of `device`'s kind this process can serve on: each
    visible card for a CUDA device, `device`'s own first (so one serve
    device is the card the process was given), the one CPU for the CPU."""
    if device.type == "cuda":
        n = torch.cuda.device_count()
        first = device.index if device.index is not None else 0
        return [torch.device("cuda", (first + i) % n) for i in range(n)]
    return [device]


def serve_devices(n_devices: int = 0, device: Optional[torch.device] = None,
                  devices: Optional[Sequence[torch.device]] = None
                  ) -> List[torch.device]:
    """The first `n_devices` of `devices` (default: `visible_devices` of
    `device`); 0 takes them all. Raises ValueError (the serve CLI's rc 2)
    when the request exceeds what exists, with the JAX package's text."""
    if devices is None:
        devices = visible_devices(torch.device(device or "cpu"))
    devices = list(devices)
    if n_devices < 0:
        raise ValueError(f"serve_devices must be >= 0, got {n_devices}")
    if n_devices > len(devices):
        raise ValueError(
            f"serve_devices={n_devices} exceeds the {len(devices)} visible "
            "devices — lower --serve_devices or widen the deployment")
    return devices[:n_devices] if n_devices else devices
