"""Device resolution for the port's entry points, and the mid-run hang
watchdog.

`cuda` is the default. The CPU is used only when the caller asks for it
(`device="cpu"`, `--device cpu`). With no card and no such request the entry
point refuses with `BackendUnavailable`, which the CLI turns into rc 3 — the
JAX serve CLI's "backend unreachable" code — instead of carrying on on the
CPU.

`StepHeartbeat` is the JAX package's (`utils/backend_probe.py:90-135`
there): a daemon thread that exits the process with rc 7 when the trainer
stops reporting progress. torch is imported only by `resolve_device`, so a
process that needs the heartbeat alone does not load it.
"""

from __future__ import annotations

import os
import sys
import threading
import time


class BackendUnavailable(RuntimeError):
    """The requested accelerator is not there."""


def resolve_device(requested: str = "") -> "torch.device":  # noqa: F821
    """"" or "cuda" → the current CUDA device (raises BackendUnavailable
    without one); "cpu" → the CPU. Anything else is a ValueError."""
    import torch

    if requested == "cpu":
        return torch.device("cpu")
    if requested not in ("", "cuda"):
        raise ValueError(f"unknown device {requested!r}; one of cuda, cpu")
    if not torch.cuda.is_available():
        raise BackendUnavailable(
            "CUDA is not available (pass --device cpu to run on the host)")
    return torch.device("cuda", torch.cuda.current_device())


class StepHeartbeat:
    """Mid-run hang detector: a trainer that freezes mid-step (a peer gone
    from a collective, a wedged CUDA call) raises nothing and never exits, so
    a supervisor that restarts on exit never sees it.

    `touch()` marks host-observed progress; a daemon thread exits the
    process loudly (`os._exit(exit_code)`, default 7) when no touch lands
    within `timeout_s`. The diagnostic is printed and flushed BEFORE the
    exit, but the exit CODE is the contract: it is what the supervisor
    restarts on. `os._exit` skips every teardown (the process group's
    included) on purpose: a thread stuck in a collective cannot be
    unwound. `timeout_s` 0 never starts the thread."""

    def __init__(self, timeout_s: float, *, exit_code: int = 7,
                 where: str = "trainer"):
        self.timeout_s = float(timeout_s)
        self.exit_code = exit_code
        self.where = where
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "StepHeartbeat":
        if self.timeout_s > 0 and self._thread is None:
            self._thread = threading.Thread(target=self._watch, daemon=True,
                                            name="heartbeat")
            self._thread.start()
        return self

    def touch(self) -> None:
        self._last = time.monotonic()

    def stop(self) -> None:
        self._stop.set()

    def _watch(self) -> None:
        poll = min(max(self.timeout_s / 4.0, 0.05), 30.0)
        while not self._stop.wait(poll):
            stale = time.monotonic() - self._last
            if stale > self.timeout_s:
                print(f"# {self.where}: no progress for {stale:.0f}s "
                      f"(> hang_timeout_s={self.timeout_s:.0f}) — hang "
                      f"suspected; exiting {self.exit_code} for the "
                      "supervisor to restart (auto_resume continues from "
                      "the last checkpoint)", file=sys.stderr, flush=True)
                os._exit(self.exit_code)
