"""Runtime recompile guard: a program build after warmup is a paged-in bug —
the port's counterpart of the JAX package's `analysis/compile_sentinel.py`.

The JAX package counts XLA compiles. Eager PyTorch compiles nothing per
shape; the port's counterparts of a program build are the two things that
stall a served batch or a train step for seconds:

- a kernel library build that runs `nvcc` (`ops/_build.py::build`; a
  library found already built is not an event). Its event is named
  `build:<lib>` and its signature is the library's source hash;
- a CUDA graph capture by the serving engine (`serve/engine.py`), named
  `capture:b<bucket>@<device>` with the captured input's shape and dtype
  as its signature.

A build is reported through `record_event`, which fans it out to every
armed sentinel: it is process-wide, as the JAX sentinel's logger is,
because a stray build anywhere stalls the device. `ops/_build.py` does not
import this module: it calls the listeners in its own `BUILD_LISTENERS`
list, which the first `arm()` joins. A capture is recorded by the engine
that captured (`CompileSentinel.record`) and reaches its sentinel alone:
another engine's warmup in the same process is not this engine's drift.

Usage as in the JAX package: `arm()` once warmup is over; `take()` (drain)
or `check(strict)` (drain, log, and raise `SteadyStateRecompile` when
strict) at natural sync points — the trainer's epoch boundary, the
engine's batch boundary. `SteadyStateRecompile.exit_code` is 2: the same
program replays the same build, so the CLIs exit rc 2 and supervisors do
not restart it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, List, NamedTuple, Optional

_armed_lock = threading.Lock()
_armed: List["CompileSentinel"] = []
_hooked = False  # record_event joined ops/_build.py's BUILD_LISTENERS


class CompileEvent(NamedTuple):
    """One observed program build after arming."""

    name: str        # "build:<lib>" or "capture:b<bucket>@<device>"
    signature: str   # the source hash, or the captured input's shape/dtype
    t: float         # time.monotonic() at capture


class SteadyStateRecompile(RuntimeError):
    """A build or capture landed after warmup with the sentinel in strict
    mode. Deterministic — the same program replays it — so the CLIs map it
    to rc 2 (supervisors must not restart it)."""

    exit_code = 2


def record_event(name: str, signature: str) -> None:
    """Report one program build to every armed sentinel."""
    with _armed_lock:
        sentinels = list(_armed)
    for s in sentinels:
        s.record(name, signature)


def _hook_builds() -> None:
    global _hooked
    with _armed_lock:
        if _hooked:
            return
        from ..ops import _build

        _build.BUILD_LISTENERS.append(record_event)
        _hooked = True


class CompileSentinel:
    """Count (and attribute) program builds observed while armed."""

    def __init__(self, tag: str = "",
                 log: Optional[Callable[[str], Any]] = None):
        self.tag = tag
        self._log = log
        self._lock = threading.Lock()
        self._events: List[CompileEvent] = []
        self._armed = False
        self.total = 0       # events observed since first arm
        self.violations = 0  # events surfaced through check()

    def record(self, name: str, signature: str) -> None:
        """One event, to this sentinel alone (the engine's captures)."""
        with self._lock:
            self._events.append(CompileEvent(name, signature, time.monotonic()))
            self.total += 1

    @property
    def armed(self) -> bool:
        return self._armed

    def arm(self) -> "CompileSentinel":
        if not self._armed:
            _hook_builds()
            with _armed_lock:
                _armed.append(self)
            self._armed = True
        return self

    def disarm(self) -> None:
        if self._armed:
            with _armed_lock:
                _armed.remove(self)
            self._armed = False

    def take(self) -> List[CompileEvent]:
        """Drain and return the events captured since the last drain."""
        with self._lock:
            events, self._events = self._events, []
        return events

    def check(self, strict: bool = False) -> List[CompileEvent]:
        """Drain; log one warning per event (with its signature); raise
        SteadyStateRecompile when strict and anything was captured."""
        events = self.take()
        if not events:
            return events
        self.violations += len(events)
        log = self._log or (lambda msg: logging.getLogger(__name__).warning(msg))
        for e in events:
            log(f"[compile-sentinel{':' + self.tag if self.tag else ''}] "
                f"steady-state build `{e.name}` — signature: {e.signature}")
        if strict:
            raise SteadyStateRecompile(
                f"{len(events)} steady-state build(s) after warmup "
                f"({self.tag or 'unarmed tag'}): "
                + "; ".join(f"{e.name} {e.signature}" for e in events[:3]))
        return events
