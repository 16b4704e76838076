"""Host-side policy over the train step's non-finite check — the port of
the JAX package's `train/sentinel.py` (`sentinel.py:40-106`).

The train step (train/steps.py) skips its update when the loss or the
global grad norm is not finite, and reports `step_ok`. This layer counts:

- `StepSentinel.observe` records one step's `step_ok`;
- `StepSentinel.flush` — at the log cadence and at epoch end — counts the
  window's skips, logs them, and raises `SentinelDiverged` after
  `run.max_bad_steps` CONSECUTIVE skips (the streak carries across
  windows and epochs). The train CLI maps it to rc 8: deterministic, a
  supervisor must not restart it.

Under gradient accumulation (`parallel.grad_accum` K > 1) the step's gate
reads the summed gradients once, at the optimizer boundary, and
`train/loop.py::train_epoch` observes once a step: one non-finite
microbatch skips the whole step, and `max_bad_steps` counts optimizer
steps whatever K is (JAX `sentinel.py:10-16`).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from ..obs.registry import Registry
from ..utils.logging import host0_print


class SentinelDiverged(RuntimeError):
    """Training diverged: max_bad_steps consecutive non-finite steps."""

    exit_code = 8


class StepSentinel:
    """Counts skipped (non-finite) train steps and escalates sustained
    divergence. One instance per Trainer."""

    def __init__(self, max_bad_steps: int,
                 log: Callable[[str], None] = host0_print,
                 registry: Optional[Registry] = None):
        self.max_bad_steps = int(max_bad_steps)
        self.skipped_total = 0
        self.streak = 0  # consecutive skips, across flush windows/epochs
        self._log = log
        self._pending: List[Any] = []
        registry = registry if registry is not None else Registry()
        self._skipped_counter = registry.counter(
            "sentinel_skipped_steps_total",
            "non-finite steps replaced by the identity update")
        self._divergence_counter = registry.counter(
            "sentinel_divergence_total",
            "times the consecutive-skip streak hit max_bad_steps (rc 8)")
        self._streak_gauge = registry.gauge(
            "sentinel_streak", "current consecutive-skip streak")

    def observe(self, step_ok: Any) -> None:
        """Record one step's `step_ok` flag (a float, or a 0-d tensor)."""
        self._pending.append(step_ok)

    def flush(self) -> None:
        """Apply policy to the pending window. Raises SentinelDiverged when
        the consecutive-skip streak reaches max_bad_steps."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        window_skips = 0
        for ok in pending:
            if float(ok) >= 0.5:
                self.streak = 0
            else:
                self.streak += 1
                self.skipped_total += 1
                window_skips += 1
        if window_skips:
            self._skipped_counter.inc(window_skips)
            self._log(f"[sentinel] skipped {window_skips} non-finite "
                      f"step(s) (total {self.skipped_total}, "
                      f"consecutive {self.streak})")
        self._streak_gauge.set(self.streak)
        if 0 < self.max_bad_steps <= self.streak:
            self._divergence_counter.inc()
            raise SentinelDiverged(
                f"{self.streak} consecutive non-finite steps "
                f"(max_bad_steps={self.max_bad_steps}) — the skip-step "
                "guard is not recovering; loss/gradients are NaN/Inf "
                "every step (rc 8: deterministic, do not restart)")
