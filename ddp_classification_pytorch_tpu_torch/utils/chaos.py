"""Deterministic fault injection for the recovery chain — the port's own
copy of the JAX package's `utils/chaos.py`: the same grammar, ranges,
one-shot marker files and env knobs, so one drill directory reads the
same under both.

The recovery chain (`cli/supervise.py`'s rc classification, the
`StepHeartbeat` in `utils/backend_probe.py`, atomic checkpoint writes and
checksum-verified resume in `train/checkpoint.py`, the non-finite step
sentinel in `train/sentinel.py`, and the pod fleet in `parallel/fleet.py`)
exists to survive failures that are rare and hard to stage. This module
makes them stageable: a `FaultPlan` parsed from a spec string like

    nan_loss@step=7,ckpt_io@epoch=1,loader_io@batch=3,sigterm@step=20

drives injection hooks planted in the trainer and the server:

- ``nan_loss`` — the train step poisons its loss to NaN after the backward
  pass on the matching global steps (train/steps.py). A pure function of
  the step counter, so it re-fires identically across restarts, as a real
  divergence does; the step's non-finite gate skips the update.
- ``ckpt_io`` — the checkpoint write for the matching epoch is torn (the
  landed file is truncated AFTER its sha256 was computed), so
  `--auto_resume` must quarantine it and fall back.
- ``loader_io`` — the loader raises ``IOError`` on the matching
  batch/epoch: the transient crash (rc 1) a supervisor retries.
- ``sigterm`` — the step loop SIGTERMs its own process on the matching
  global step: a mid-epoch preemption.
- ``peer_dead`` — the step loop SIGKILLs its own process: a rank dropping
  out of a pod with no cleanup, which leaves every peer waiting in its
  next collective.
- ``peer_slow`` — the step loop sleeps ``CHAOS_PEER_SLOW_S`` seconds
  (default 15) on the matching global step: a straggler.
- ``host_lost`` — the step loop SIGKILLs its whole PROCESS GROUP: the
  trainer AND its supervisor are gone (elastic re-formation).
- ``publish_corrupt`` — the serve-side twin of ``ckpt_io``: tears the
  published candidate the same way, naming the scenario a watching server
  must absorb (quarantine, keep serving).
- ``watcher_io`` — the checkpoint watcher's poll raises ``OSError(EIO)``
  on the matching poll number (serve/reload.py): it must log, back off and
  re-arm, never die.

Ranges: ``@step=7`` (one step), ``@step=7..9`` (inclusive), ``@step=7..``
(every step from 7 on). Host-side faults fire AT MOST ONCE per fault — in
process, and across restarts when a ``state_dir`` is given (a marker file
per fired fault, ``<kind>.<unit>.<lo>-<hi>.h<process index>``). The spec
is env-overridable (``CHAOS_FAULT_SPEC``) so a drill can wrap any launch
line unchanged.

Pod drills share ONE spec across every process and aim faults with
``CHAOS_HOST``: when set, faults fire only on the process whose index (its
rank: `current_process_index`) equals it; unset means every process.
``nan_loss`` windows honor the same gate.

An empty/absent spec parses to a falsy plan and every call site gates on
it, so a run without faults takes exactly the code path it takes without
this module.
"""

from __future__ import annotations

import os
import signal
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

@dataclass(frozen=True)
class KindInfo:
    """One row of the fault grammar: which range units a kind accepts,
    which side of the train→serve pipeline injects it, which subsystem
    is expected to absorb it, and the error to raise on a wrong unit.
    A scenario fuzzer (the JAX package's `scenario/fuzz.py`) enumerates
    this table instead of hardcoding kinds, so a new fault automatically
    enters its search space."""

    units: Tuple[str, ...]  # allowed range units, first = canonical
    side: str  # "trainer" | "serve": who hosts the injection hook
    subsystem: str  # the recovery layer under test
    unit_error: str = ""  # parse error when the unit is not allowed


# kind → grammar row. Subsystem names feed the fuzzer's coverage ledger
# keys ("<kind>x<subsystem>"); keep them stable.
# The messages are the JAX package's word for word: a drill reads the same
# errors under both.
FAULT_GRAMMAR = {
    "nan_loss": KindInfo(
        ("step",), "trainer", "sentinel",
        "nan_loss is keyed by the in-jit step counter; use nan_loss@step=..."),
    "ckpt_io": KindInfo(("epoch", "step", "batch"), "trainer", "checkpoint"),
    "loader_io": KindInfo(("batch", "epoch", "step"), "trainer", "dataplane"),
    "sigterm": KindInfo(("step", "epoch", "batch"), "trainer", "supervise"),
    "peer_dead": KindInfo(
        ("step",), "trainer", "pod",
        "peer_dead is keyed by the host-side step counter; "
        "use peer_dead@step=..."),
    "peer_slow": KindInfo(
        ("step",), "trainer", "pod",
        "peer_slow is keyed by the host-side step counter; "
        "use peer_slow@step=..."),
    "host_lost": KindInfo(
        ("step",), "trainer", "elastic",
        "host_lost is keyed by the host-side step counter; "
        "use host_lost@step=..."),
    "publish_corrupt": KindInfo(
        ("epoch",), "trainer", "publish",
        "publish_corrupt tears a published epoch checkpoint; "
        "use publish_corrupt@epoch=..."),
    "watcher_io": KindInfo(
        ("poll",), "serve", "watcher",
        "watcher_io is keyed by the watcher's poll counter; "
        "use watcher_io@poll=..."),
}

KINDS = tuple(FAULT_GRAMMAR)
UNITS = ("step", "epoch", "batch", "poll")


def kinds_for_side(side: str) -> Tuple[str, ...]:
    """Fault kinds whose injection hook lives on `side` ("trainer" or
    "serve") — the fuzzer's per-subsystem sampling universe."""
    return tuple(k for k, info in FAULT_GRAMMAR.items() if info.side == side)


def subsystem_of(kind: str) -> str:
    """The recovery subsystem a fault kind targets (coverage-ledger axis)."""
    return FAULT_GRAMMAR[kind].subsystem

ENV_SPEC = "CHAOS_FAULT_SPEC"
ENV_STATE_DIR = "CHAOS_STATE_DIR"
ENV_HOST = "CHAOS_HOST"
ENV_PEER_SLOW_S = "CHAOS_PEER_SLOW_S"


def resolve_spec(config_spec: str = "") -> str:
    """The active fault spec: ``CHAOS_FAULT_SPEC`` wins over the config
    value so a drill can wrap an existing launch script unchanged."""
    return os.environ.get(ENV_SPEC) or (config_spec or "")


@dataclass(frozen=True)
class Fault:
    kind: str  # one of KINDS
    unit: str  # one of UNITS
    lo: int
    hi: Optional[int]  # None = open-ended range

    def matches(self, value: int) -> bool:
        return value >= self.lo and (self.hi is None or value <= self.hi)

    @property
    def key(self) -> str:
        """Filesystem-safe identity for fired-marker files."""
        hi = "inf" if self.hi is None else str(self.hi)
        return f"{self.kind}.{self.unit}.{self.lo}-{hi}"

    def __str__(self) -> str:
        if self.hi == self.lo:
            rng = str(self.lo)
        elif self.hi is None:
            rng = f"{self.lo}.."
        else:
            rng = f"{self.lo}..{self.hi}"
        return f"{self.kind}@{self.unit}={rng}"


def _parse_range(text: str) -> Tuple[int, Optional[int]]:
    if ".." in text:
        lo_s, hi_s = text.split("..", 1)
        lo = int(lo_s)
        hi = int(hi_s) if hi_s else None
        if hi is not None and hi < lo:
            raise ValueError(f"empty fault range {text!r}")
        return lo, hi
    v = int(text)
    return v, v


class FaultPlan:
    """Parsed fault spec + one-shot firing state for the host-side hooks.

    Falsy when empty — call sites gate on the plan so an absent spec costs
    nothing and changes nothing.
    """

    def __init__(self, faults: List[Fault], state_dir: Optional[str] = None,
                 process_index: int = 0):
        self.faults = list(faults)
        self.state_dir = state_dir
        self.process_index = int(process_index)
        self._fired: set = set()

    @classmethod
    def parse(cls, spec: str, state_dir: Optional[str] = None,
              process_index: int = 0) -> "FaultPlan":
        """``kind@unit=range[,kind@unit=range...]`` → FaultPlan.

        Raises ValueError on malformed specs — surfaced at trainer
        construction, which the CLI maps to the deterministic rc 2.
        """
        state_dir = os.environ.get(ENV_STATE_DIR) or state_dir
        faults: List[Fault] = []
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            try:
                kind, cond = part.split("@", 1)
                unit, rng = cond.split("=", 1)
                lo, hi = _parse_range(rng.strip())
            except ValueError:
                raise ValueError(
                    f"malformed fault {part!r} (want kind@unit=N, "
                    "kind@unit=N..M, or kind@unit=N..)") from None
            kind, unit = kind.strip(), unit.strip()
            if kind not in FAULT_GRAMMAR:
                raise ValueError(f"unknown fault kind {kind!r}; one of {KINDS}")
            if unit not in UNITS:
                raise ValueError(f"unknown fault unit {unit!r}; one of {UNITS}")
            info = FAULT_GRAMMAR[kind]
            if unit not in info.units:
                raise ValueError(
                    info.unit_error
                    or f"{kind} accepts units {info.units}; got {unit!r}")
            if unit == "poll" and kind != "watcher_io":
                raise ValueError("the poll unit belongs to watcher_io only")
            faults.append(Fault(kind, unit, lo, hi))
        return cls(faults, state_dir=state_dir, process_index=process_index)

    def __bool__(self) -> bool:
        return bool(self.faults)

    def __str__(self) -> str:
        return ",".join(str(f) for f in self.faults)

    # ---------------------------------------------------------- host gate --
    def host_gated(self) -> bool:
        """True when ``CHAOS_HOST`` is set and names a DIFFERENT process:
        this plan's faults belong to another host of the pod. Unset (the
        single-host default) gates nothing."""
        target = os.environ.get(ENV_HOST, "")
        if target == "":
            return False
        try:
            return int(target) != self.process_index
        except ValueError:
            return False

    # --------------------------------------------------------------- state --
    def _marker(self, fault: Fault) -> Optional[str]:
        # markers are per-host: on a pod the state_dir rides the SHARED
        # out_dir, and host A firing a fault must not consume host B's
        # one shot (one-shot means once per fault PER PROCESS)
        return (os.path.join(self.state_dir,
                             f"{fault.key}.h{self.process_index}")
                if self.state_dir else None)

    def _already_fired(self, fault: Fault) -> bool:
        if fault.key in self._fired:
            return True
        m = self._marker(fault)
        return m is not None and os.path.exists(m)

    def _mark_fired(self, fault: Fault) -> None:
        """Record the firing BEFORE the fault takes effect: a fault that
        kills the process must not re-fire on the supervised restart."""
        self._fired.add(fault.key)
        m = self._marker(fault)
        if m is not None:
            os.makedirs(self.state_dir, exist_ok=True)
            with open(m, "w") as f:
                f.write(str(fault) + "\n")

    def should_fire(self, kind: str, **coords: int) -> Optional[Fault]:
        """One-shot host-side trigger: the first un-fired fault of `kind`
        whose unit is present in `coords` and whose range matches. Marks
        it fired (in memory, and in state_dir when configured) before
        returning it. ``CHAOS_HOST`` gating: a plan aimed at another
        host never fires (and never consumes its one shot)."""
        if self.host_gated():
            return None
        for f in self.faults:
            if (f.kind == kind and f.unit in coords
                    and f.matches(int(coords[f.unit]))
                    and not self._already_fired(f)):
                self._mark_fired(f)
                return f
        return None

    # ------------------------------------------------------------ windows --
    def windows(self, kind: str, unit: str = "step") -> List[Tuple[int, Optional[int]]]:
        """(lo, hi) ranges for in-step injection (hi None = open-ended).
        NOT one-shot: a pure function of the step counter, like a real
        divergence. ``CHAOS_HOST`` gating applies when the step is built:
        the targeted process injects, its peers run the clean step — how
        a pod drill stages a ONE-process divergence."""
        if self.host_gated():
            return []
        return [(f.lo, f.hi) for f in self.faults
                if f.kind == kind and f.unit == unit]

    # -------------------------------------------------------------- hooks --
    def maybe_fail_loader(self, *, epoch: int, batch: int) -> None:
        """Loader-read hook (data/loader.py::Loader._load_batch)."""
        f = self.should_fire("loader_io", epoch=epoch, batch=batch)
        if f is not None:
            raise IOError(f"chaos: injected loader failure ({f}) "
                          f"at epoch={epoch} batch={batch}")

    def maybe_corrupt_checkpoint(self, path: str, *, epoch: int) -> bool:
        """Checkpoint-write hook (train/checkpoint.py): tears the landed
        file by truncating it to half its bytes — the sha256 sidecar
        (computed from the intact serialization) then fails verification
        on resume. Returns True when it fired.

        Fires for ``ckpt_io`` (resume-path drills) and its serve-side twin
        ``publish_corrupt`` (a corrupt PUBLISHED candidate a watching
        serving fleet must quarantine without dropping traffic)."""
        f = self.should_fire("ckpt_io", epoch=epoch)
        label = "tore checkpoint"
        if f is None:
            f = self.should_fire("publish_corrupt", epoch=epoch)
            label = "corrupted published candidate"
        if f is None:
            return False
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(max(size // 2, 1))
        print(f"# chaos: {label} {path} ({f}): "
              f"{size} -> {max(size // 2, 1)} bytes", file=sys.stderr, flush=True)
        return True

    def maybe_fail_watcher_poll(self, *, poll: int) -> None:
        """Watcher-poll hook (serve/reload.py::CheckpointWatcher): raises
        EIO on the matching poll number — a shared-fs flake mid-scan the
        watcher must survive (log + bounded backoff + re-arm)."""
        f = self.should_fire("watcher_io", poll=poll)
        if f is not None:
            import errno

            print(f"# chaos: watcher poll {poll} fails ({f})",
                  file=sys.stderr, flush=True)
            raise OSError(errno.EIO, f"chaos: injected watcher poll "
                                     f"failure ({f}) at poll={poll}")

    def maybe_sigterm(self, *, step: int) -> None:
        """Step-loop hook (train/loop.py): a mid-epoch preemption."""
        f = self.should_fire("sigterm", step=step)
        if f is not None:
            print(f"# chaos: SIGTERM self at step {step} ({f})",
                  file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGTERM)

    def maybe_peer_dead(self, *, step: int) -> None:
        """Step-loop hook: SIGKILL self — a host dropping out of the pod
        with no cleanup (no atexit, no flush, rc 137), so the pod chaos
        drill stages the peers-hang-at-the-next-collective scenario."""
        f = self.should_fire("peer_dead", step=step)
        if f is not None:
            print(f"# chaos: host {self.process_index} dies (SIGKILL) at "
                  f"step {step} ({f})", file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    def maybe_host_lost(self, *, step: int) -> None:
        """Step-loop hook: SIGKILL this host's whole process group —
        trainer AND supervisor die together (`cli/supervise.py` keeps its
        child in its own group), so nothing local restarts it. The surviving
        hosts' lease scans must re-form the pod without it."""
        f = self.should_fire("host_lost", step=step)
        if f is not None:
            print(f"# chaos: host {self.process_index} lost (SIGKILL "
                  f"group) at step {step} ({f})", file=sys.stderr, flush=True)
            os.killpg(os.getpgid(0), signal.SIGKILL)

    def maybe_peer_slow(self, *, step: int) -> None:
        """Step-loop hook: stall this host ``CHAOS_PEER_SLOW_S`` seconds
        (default 15) — a straggler; its peers block at the step's
        collective, and nothing should escalate unless the stall
        exceeds the heartbeat."""
        f = self.should_fire("peer_slow", step=step)
        if f is not None:
            import time

            stall = float(os.environ.get(ENV_PEER_SLOW_S, "15"))
            print(f"# chaos: host {self.process_index} stalls {stall:.0f}s "
                  f"at step {step} ({f})", file=sys.stderr, flush=True)
            time.sleep(stall)


def current_process_index() -> int:
    """This process's index in the pod: its rank once the process group
    is up (`dist.get_rank()`), before that ``FLEET_PROCESS_ID`` or
    torchrun's ``RANK``, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("FLEET_PROCESS_ID")
               or os.environ.get("RANK") or 0)


def plan_for_run(config_spec: str, out_dir: str,
                 process_index: Optional[int] = None) -> FaultPlan:
    """The trainer's entry point: resolve the spec (env wins), persist
    one-shot firing state under ``<out_dir>/chaos`` so a supervised
    restart does not replay host-side faults (``CHAOS_STATE_DIR``
    overrides the location). `process_index` (default
    `current_process_index()`) feeds the ``CHAOS_HOST`` per-process gate
    on pods."""
    spec = resolve_spec(config_spec)
    if not spec:
        return FaultPlan([])
    if process_index is None:
        process_index = current_process_index()
    return FaultPlan.parse(spec, state_dir=os.path.join(out_dir, "chaos"),
                           process_index=process_index)
