"""`--debug_nans`: the port's counterpart of `jax_debug_nans` (the JAX
CLI's `cli/train.py:567-568`), which makes every primitive that produces
a NaN raise.

`NanCheck` is a `TorchDispatchMode`: every aten op's floating outputs are
checked, and the first NaN raises `FloatingPointError` naming the op. The
mode lives in thread-local state that autograd hands to its device
threads, so the backward's ops are checked too. Factory ops that return
uninitialised memory (`empty*`, `new_empty*`) are not checked. The
hand-written kernels launch through ctypes and are invisible to dispatch:
each wrapper calls `check_outputs` on what its kernel wrote, a no-op
unless a `NanCheck` is on the thread's mode stack. Like jax's check, it
finds NaNs only (an infinity passes), and it makes a host sync per op: a
debugging switch, off by default.

A `nan_loss` fault step (`utils/chaos.py`) poisons the loss with
`full_like(nan)`, an aten op: under the mode the step raises instead of
being skipped by the sentinel, as under `jax_debug_nans`.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_leaves


def _unchecked(func: Any) -> bool:
    name = func.overloadpacket.__name__
    return name.startswith(("empty", "new_empty")) or name in ("set_",
                                                               "resize_")


def _has_nan(t: Any) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() > 0 and bool(torch.isnan(t).any()))


class NanCheck(TorchDispatchMode):
    """Raise `FloatingPointError` at the first aten op with a NaN output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _unchecked(func) and any(_has_nan(t) for t in tree_leaves(out)):
            raise FloatingPointError(
                f"NaN in the output of {func} (--debug_nans)")
        return out


def check_outputs(kernel: str, *outs: torch.Tensor) -> None:
    """A hand-written kernel's outputs, checked as `NanCheck` checks an
    aten op's while one is active on this thread (the wrappers call this
    after their launch)."""
    if any(isinstance(m, NanCheck) for m in _get_current_dispatch_mode_stack()
           ) and any(_has_nan(t) for t in outs):
        raise FloatingPointError(
            f"NaN in the output of kernel {kernel} (--debug_nans)")
