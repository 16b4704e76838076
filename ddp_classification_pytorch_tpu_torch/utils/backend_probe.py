"""Device resolution for the port's entry points.

`cuda` is the default. The CPU is used only when the caller asks for it
(`device="cpu"`, `--device cpu`). With no card and no such request the entry
point refuses with `BackendUnavailable`, which the CLI turns into rc 3 — the
JAX serve CLI's "backend unreachable" code — instead of carrying on on the
CPU.
"""

from __future__ import annotations

import torch


class BackendUnavailable(RuntimeError):
    """The requested accelerator is not there."""


def resolve_device(requested: str = "") -> torch.device:
    """"" or "cuda" → the current CUDA device (raises BackendUnavailable
    without one); "cpu" → the CPU. Anything else is a ValueError."""
    if requested == "cpu":
        return torch.device("cpu")
    if requested not in ("", "cuda"):
        raise ValueError(f"unknown device {requested!r}; one of cuda, cpu")
    if not torch.cuda.is_available():
        raise BackendUnavailable(
            "CUDA is not available (pass --device cpu to run on the host)")
    return torch.device("cuda", torch.cuda.current_device())
