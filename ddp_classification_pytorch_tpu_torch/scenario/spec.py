"""`--scenario_spec` grammar: one JSON object describing a train→serve
chaos scenario — the port's copy of the JAX package's `scenario/spec.py`,
the same grammar, defaults, errors and canonical dump.

    {
      "trainer": {
        "hosts": 2, "elastic": true, "min_processes": 1, "epochs": 4,
        "model": "resnet18", "variant": "cifar", "num_classes": 4,
        "image_size": 16, "batchsize": 8, "synthetic_size": 64,
        "relaunch_lost": true,
        "fault_specs": {"0": "ckpt_io@epoch=0,publish_corrupt@epoch=2",
                        "1": "nan_loss@step=2..3,host_lost@step=10"}
      },
      "serve": {
        "replicas": 2, "poll_s": 1.0, "queue_depth": 16,
        "max_batch": 4, "buckets": "1,4",
        "max_replicas": 3, "fleet_ttl_s": 6.0,
        "admission_deadline_ms": 0.0, "scale_out_deadline_s": 60.0,
        "fault_specs": {"0": "watcher_io@poll=3"}
      },
      "load": {"rps": 4.0, "timeout_s": 20.0},
      "availability": {"floor": 0.5, "window_s": 10.0, "min_samples": 3},
      "adopt_deadline_s": 120.0,
      "deadline_s": 600.0,
      "timeline": [{"at": "publish:1", "action": "drain_replica", "replica": 1},
                   {"at": "t:30", "action": "spike_load", "rps": 12.0},
                   {"at": "t:40", "action": "kill_replica_during_wave"}]
    }

Per-host / per-replica `fault_specs` reuse the port's utils/chaos.py grammar
verbatim (each process gets its own ``CHAOS_FAULT_SPEC``, so a pod drill
can aim a NaN burst at host 1 while host 0 tears its own checkpoint —
no ``CHAOS_HOST`` gating needed). The ``timeline`` drives the faults chaos
cannot express in-process: supervisor-side actions fired at a wall-clock
offset (``"t:SECONDS"``) or when the trainer publishes a given epoch
(``"publish:EPOCH"``). Actions: ``drain_replica`` (SIGTERM → graceful
drain → relaunch: the reload-during-drain window), ``kill_replica``
(SIGKILL → relaunch), ``kill_replica_during_wave`` (SIGKILL the replica
holding the fleet's drain token once a reload wave is in flight —
targets the holder, so it takes no ``replica`` field; proves the
lease-TTL token hand-off under the S5 invariant), and ``spike_load``
(an offered-load step function: from the fire time on, the load
generator sustains ``rps`` instead of ``load.rps`` — only meaningful at
a ``t:`` offset, and the only action that takes ``rps``).

``serve.max_replicas > replicas`` arms the supervisor-side autoscaler
(the port's serve/fleet.py::Autoscaler over the replicas' /metrics.json):
a spike may scale the fleet out up to ``max_replicas``; S5 requires the
first ``scale_out`` within ``scale_out_deadline_s`` of a spike.
``fleet_ttl_s`` is the replicas' lease/drain-token freshness horizon and
``admission_deadline_ms > 0`` turns on deadline-based admission shedding
inside every replica.

A malformed spec raises `SpecError` (a ValueError), which `cli/scenario.py`
maps to the deterministic rc 2 — same discipline as every other CLI.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_AT_RE = re.compile(r"^(t|publish):(\d+)$")
_ACTIONS = ("drain_replica", "kill_replica", "kill_replica_during_wave",
            "spike_load")


class SpecError(ValueError):
    """Malformed scenario spec — deterministic, never retried (rc 2)."""


@dataclass
class TrainerSpec:
    hosts: int = 2
    elastic: bool = True
    min_processes: int = 1
    epochs: int = 4
    model: str = "resnet18"
    variant: str = "cifar"
    num_classes: int = 4
    image_size: int = 16
    batchsize: int = 8
    synthetic_size: int = 64
    relaunch_lost: bool = True
    fault_specs: Dict[int, str] = field(default_factory=dict)


@dataclass
class ServeSpec:
    replicas: int = 2
    poll_s: float = 1.0
    queue_depth: int = 16
    max_batch: int = 4
    buckets: str = "1,4"
    # fleet control plane: max_replicas > replicas arms the autoscaler
    # (0 or == replicas means a fixed fleet); fleet_ttl_s bounds how long
    # a dead replica can pin the drain token; admission_deadline_ms > 0
    # turns on deadline shedding inside every replica; the first scale_out
    # after a spike must land within scale_out_deadline_s (S5)
    max_replicas: int = 0
    fleet_ttl_s: float = 6.0
    admission_deadline_ms: float = 0.0
    scale_out_deadline_s: float = 60.0
    fault_specs: Dict[int, str] = field(default_factory=dict)


@dataclass
class LoadSpec:
    rps: float = 4.0
    timeout_s: float = 20.0


@dataclass
class AvailabilitySpec:
    floor: float = 0.5
    window_s: float = 10.0
    min_samples: int = 3


@dataclass
class TimelineItem:
    at_kind: str    # "t" | "publish"
    at_value: int   # seconds offset | epoch number
    action: str     # one of _ACTIONS
    replica: int = 0
    rps: float = 0.0  # spike_load only: offered-load step target

    def __str__(self) -> str:
        if self.action == "spike_load":
            return f"{self.action}@{self.at_kind}:{self.at_value}(rps={self.rps})"
        if self.action == "kill_replica_during_wave":
            return f"{self.action}@{self.at_kind}:{self.at_value}(holder)"
        return f"{self.action}@{self.at_kind}:{self.at_value}(replica={self.replica})"


@dataclass
class ScenarioSpec:
    trainer: TrainerSpec
    serve: ServeSpec
    load: LoadSpec
    availability: AvailabilitySpec
    adopt_deadline_s: float = 120.0
    deadline_s: float = 600.0
    timeline: List[TimelineItem] = field(default_factory=list)

    def to_json(self, indent: int = 2) -> str:
        """Canonical lossless dump: ``parse_spec(json.loads(s.to_json()))
        == s`` and the dump is a fixpoint (dump → parse → dump is
        byte-identical), so a minimized failing spec can be committed
        and replayed verbatim (the JAX package's corpus under
        tests/data/scenarios/ replays through `cli/scenario.py`)."""
        return json.dumps(spec_to_raw(self), indent=indent,
                          sort_keys=True) + "\n"


def _typed(section: str, raw: dict, key: str, kind, default):
    v = raw.get(key, default)
    if isinstance(kind, tuple):  # numeric: int accepted where float wanted
        ok = isinstance(v, kind) and not isinstance(v, bool)
    elif kind is bool:
        ok = isinstance(v, bool)
    else:
        ok = isinstance(v, kind) and not isinstance(v, bool)
    if not ok:
        raise SpecError(f"{section}.{key} must be {getattr(kind, '__name__', kind)}, "
                        f"got {v!r}")
    return v


def _check_keys(section: str, raw: dict, allowed) -> None:
    unknown = sorted(set(raw) - set(allowed))
    if unknown:
        raise SpecError(f"unknown key(s) in {section}: {unknown} "
                        f"(allowed: {sorted(allowed)})")


def _fault_specs(section: str, raw: dict, count: int) -> Dict[int, str]:
    """{"0": "kind@unit=N,..."} → {0: spec}, each validated by the real
    chaos parser so a typo'd fault name is an rc 2 here, not a silent
    no-op inside a subprocess."""
    from ..utils import chaos as chaoslib

    out: Dict[int, str] = {}
    specs = raw.get("fault_specs", {})
    if not isinstance(specs, dict):
        raise SpecError(f"{section}.fault_specs must be an object of "
                        "index -> chaos spec strings")
    for k, v in specs.items():
        try:
            idx = int(k)
        except (TypeError, ValueError):
            raise SpecError(f"{section}.fault_specs key {k!r} is not an index")
        if not 0 <= idx < count:
            raise SpecError(f"{section}.fault_specs[{idx}] is out of range "
                            f"(have {count})")
        if not isinstance(v, str):
            raise SpecError(f"{section}.fault_specs[{idx}] must be a string")
        try:
            chaoslib.FaultPlan.parse(v)
        except ValueError as e:
            raise SpecError(f"{section}.fault_specs[{idx}]: {e}") from None
        out[idx] = v
    return out


def parse_spec(raw: dict) -> ScenarioSpec:
    if not isinstance(raw, dict):
        raise SpecError(f"scenario spec must be a JSON object, got "
                        f"{type(raw).__name__}")
    _check_keys("spec", raw, ("trainer", "serve", "load", "availability",
                              "adopt_deadline_s", "deadline_s", "timeline"))

    t_raw = raw.get("trainer", {})
    if not isinstance(t_raw, dict):
        raise SpecError("trainer must be an object")
    _check_keys("trainer", t_raw,
                ("hosts", "elastic", "min_processes", "epochs", "model",
                 "variant", "num_classes", "image_size", "batchsize",
                 "synthetic_size", "relaunch_lost", "fault_specs"))
    trainer = TrainerSpec(
        hosts=_typed("trainer", t_raw, "hosts", int, 2),
        elastic=_typed("trainer", t_raw, "elastic", bool, True),
        min_processes=_typed("trainer", t_raw, "min_processes", int, 1),
        epochs=_typed("trainer", t_raw, "epochs", int, 4),
        model=_typed("trainer", t_raw, "model", str, "resnet18"),
        variant=_typed("trainer", t_raw, "variant", str, "cifar"),
        num_classes=_typed("trainer", t_raw, "num_classes", int, 4),
        image_size=_typed("trainer", t_raw, "image_size", int, 16),
        batchsize=_typed("trainer", t_raw, "batchsize", int, 8),
        synthetic_size=_typed("trainer", t_raw, "synthetic_size", int, 64),
        relaunch_lost=_typed("trainer", t_raw, "relaunch_lost", bool, True),
    )
    if trainer.hosts < 1:
        raise SpecError("trainer.hosts must be >= 1")
    if trainer.epochs < 1:
        raise SpecError("trainer.epochs must be >= 1")
    if not 1 <= trainer.min_processes <= trainer.hosts:
        raise SpecError("trainer.min_processes must be in "
                        f"[1, hosts={trainer.hosts}]")
    trainer.fault_specs = _fault_specs("trainer", t_raw, trainer.hosts)

    s_raw = raw.get("serve", {})
    if not isinstance(s_raw, dict):
        raise SpecError("serve must be an object")
    _check_keys("serve", s_raw, ("replicas", "poll_s", "queue_depth",
                                 "max_batch", "buckets", "max_replicas",
                                 "fleet_ttl_s", "admission_deadline_ms",
                                 "scale_out_deadline_s", "fault_specs"))
    serve = ServeSpec(
        replicas=_typed("serve", s_raw, "replicas", int, 2),
        poll_s=_typed("serve", s_raw, "poll_s", (int, float), 1.0),
        queue_depth=_typed("serve", s_raw, "queue_depth", int, 16),
        max_batch=_typed("serve", s_raw, "max_batch", int, 4),
        buckets=_typed("serve", s_raw, "buckets", str, "1,4"),
        max_replicas=_typed("serve", s_raw, "max_replicas", int, 0),
        fleet_ttl_s=_typed("serve", s_raw, "fleet_ttl_s", (int, float), 6.0),
        admission_deadline_ms=_typed("serve", s_raw, "admission_deadline_ms",
                                     (int, float), 0.0),
        scale_out_deadline_s=_typed("serve", s_raw, "scale_out_deadline_s",
                                    (int, float), 60.0),
    )
    if serve.replicas < 1:
        raise SpecError("serve.replicas must be >= 1 (the availability floor "
                        "needs someone to answer)")
    if serve.poll_s <= 0:
        raise SpecError("serve.poll_s must be > 0")
    if serve.max_replicas != 0 and serve.max_replicas < serve.replicas:
        raise SpecError("serve.max_replicas must be 0 (autoscaler off) or "
                        f">= replicas={serve.replicas}")
    if serve.fleet_ttl_s <= 0:
        raise SpecError("serve.fleet_ttl_s must be > 0")
    if serve.admission_deadline_ms < 0:
        raise SpecError("serve.admission_deadline_ms must be >= 0 "
                        "(0 = admission off)")
    if serve.scale_out_deadline_s <= 0:
        raise SpecError("serve.scale_out_deadline_s must be > 0")
    serve.fault_specs = _fault_specs("serve", s_raw, serve.replicas)

    l_raw = raw.get("load", {})
    if not isinstance(l_raw, dict):
        raise SpecError("load must be an object")
    _check_keys("load", l_raw, ("rps", "timeout_s"))
    load = LoadSpec(rps=_typed("load", l_raw, "rps", (int, float), 4.0),
                    timeout_s=_typed("load", l_raw, "timeout_s",
                                     (int, float), 20.0))
    if load.rps <= 0 or load.timeout_s <= 0:
        raise SpecError("load.rps and load.timeout_s must be > 0")

    a_raw = raw.get("availability", {})
    if not isinstance(a_raw, dict):
        raise SpecError("availability must be an object")
    _check_keys("availability", a_raw, ("floor", "window_s", "min_samples"))
    avail = AvailabilitySpec(
        floor=_typed("availability", a_raw, "floor", (int, float), 0.5),
        window_s=_typed("availability", a_raw, "window_s", (int, float), 10.0),
        min_samples=_typed("availability", a_raw, "min_samples", int, 3),
    )
    if not 0.0 < avail.floor <= 1.0:
        raise SpecError("availability.floor must be in (0, 1]")
    if avail.window_s <= 0:
        raise SpecError("availability.window_s must be > 0")

    adopt = raw.get("adopt_deadline_s", 120.0)
    deadline = raw.get("deadline_s", 600.0)
    for name, v in (("adopt_deadline_s", adopt), ("deadline_s", deadline)):
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
            raise SpecError(f"{name} must be a positive number, got {v!r}")

    items: List[TimelineItem] = []
    tl = raw.get("timeline", [])
    if not isinstance(tl, list):
        raise SpecError("timeline must be a list of actions")
    for i, it in enumerate(tl):
        if not isinstance(it, dict):
            raise SpecError(f"timeline[{i}] must be an object")
        _check_keys(f"timeline[{i}]", it, ("at", "action", "replica", "rps"))
        at = it.get("at", "")
        m = _AT_RE.match(at if isinstance(at, str) else "")
        if not m:
            raise SpecError(f"timeline[{i}].at {at!r} must be 't:SECONDS' "
                            "or 'publish:EPOCH'")
        action = it.get("action", "")
        if action not in _ACTIONS:
            raise SpecError(f"timeline[{i}].action {action!r} must be one "
                            f"of {list(_ACTIONS)}")
        if action == "spike_load":
            # an offered-load step function: only a wall-clock fire time
            # makes sense (a publish-gated spike would race the trainer),
            # and rps is the one parameter it takes
            if m.group(1) != "t":
                raise SpecError(f"timeline[{i}]: spike_load fires at "
                                "'t:SECONDS' (got a publish trigger)")
            if "replica" in it:
                raise SpecError(f"timeline[{i}]: spike_load targets the "
                                "whole fleet, not a replica")
            rps = it.get("rps", None)
            if not isinstance(rps, (int, float)) or isinstance(rps, bool) \
                    or rps <= 0:
                raise SpecError(f"timeline[{i}]: spike_load needs rps > 0, "
                                f"got {rps!r}")
            items.append(TimelineItem(m.group(1), int(m.group(2)), action,
                                      rps=float(rps)))
            continue
        if "rps" in it:
            raise SpecError(f"timeline[{i}]: rps is only valid with "
                            "spike_load")
        if action == "kill_replica_during_wave":
            # the target is whoever holds the drain token when the wave is
            # in flight — a fixed replica index would race the wave order
            if "replica" in it:
                raise SpecError(f"timeline[{i}]: kill_replica_during_wave "
                                "kills the drain-token holder; it takes no "
                                "replica index")
            items.append(TimelineItem(m.group(1), int(m.group(2)), action))
            continue
        replica = it.get("replica", 0)
        if not isinstance(replica, int) or isinstance(replica, bool) or \
                not 0 <= replica < serve.replicas:
            raise SpecError(f"timeline[{i}].replica {replica!r} out of range "
                            f"(have {serve.replicas})")
        items.append(TimelineItem(m.group(1), int(m.group(2)), action, replica))

    return ScenarioSpec(trainer=trainer, serve=serve, load=load,
                        availability=avail, adopt_deadline_s=float(adopt),
                        deadline_s=float(deadline), timeline=items)


def _timeline_item_raw(item: TimelineItem) -> dict:
    """The dump half of the timeline grammar, action-aware to mirror the
    parser exactly: ``spike_load`` carries ``rps`` and no ``replica``
    (the parser rejects one), ``kill_replica_during_wave`` carries
    neither (it targets the token holder), everything else carries
    ``replica`` and no ``rps``. A naive field dump of TimelineItem would
    round-trip to an rc 2 here — this asymmetry is exactly the "field
    the dump path reveals as unparseable"."""
    raw = {"at": f"{item.at_kind}:{item.at_value}", "action": item.action}
    if item.action == "spike_load":
        raw["rps"] = item.rps
    elif item.action != "kill_replica_during_wave":
        raw["replica"] = item.replica
    return raw


def spec_to_raw(spec: ScenarioSpec) -> dict:
    """ScenarioSpec → the raw dict `parse_spec` accepts. Every field is
    emitted explicitly (defaults included) so the dump is canonical:
    two equal specs always serialize byte-identically."""
    t, s = spec.trainer, spec.serve
    return {
        "trainer": {
            "hosts": t.hosts, "elastic": t.elastic,
            "min_processes": t.min_processes, "epochs": t.epochs,
            "model": t.model, "variant": t.variant,
            "num_classes": t.num_classes, "image_size": t.image_size,
            "batchsize": t.batchsize, "synthetic_size": t.synthetic_size,
            "relaunch_lost": t.relaunch_lost,
            "fault_specs": {str(k): v for k, v in sorted(t.fault_specs.items())},
        },
        "serve": {
            "replicas": s.replicas, "poll_s": s.poll_s,
            "queue_depth": s.queue_depth, "max_batch": s.max_batch,
            "buckets": s.buckets, "max_replicas": s.max_replicas,
            "fleet_ttl_s": s.fleet_ttl_s,
            "admission_deadline_ms": s.admission_deadline_ms,
            "scale_out_deadline_s": s.scale_out_deadline_s,
            "fault_specs": {str(k): v for k, v in sorted(s.fault_specs.items())},
        },
        "load": {"rps": spec.load.rps, "timeout_s": spec.load.timeout_s},
        "availability": {"floor": spec.availability.floor,
                         "window_s": spec.availability.window_s,
                         "min_samples": spec.availability.min_samples},
        "adopt_deadline_s": spec.adopt_deadline_s,
        "deadline_s": spec.deadline_s,
        "timeline": [_timeline_item_raw(it) for it in spec.timeline],
    }


def load_spec(spec_arg: str) -> ScenarioSpec:
    """`--scenario_spec` value → ScenarioSpec: a path to a JSON file, or an
    inline JSON object (starts with '{'). Every failure is a SpecError."""
    if not spec_arg:
        raise SpecError("empty --scenario_spec")
    text = spec_arg
    if not spec_arg.lstrip().startswith("{"):
        if not os.path.exists(spec_arg):
            raise SpecError(f"scenario spec file not found: {spec_arg}")
        try:
            with open(spec_arg) as f:
                text = f.read()
        except OSError as e:
            raise SpecError(f"cannot read scenario spec {spec_arg}: {e}")
    try:
        raw = json.loads(text)
    except ValueError as e:
        raise SpecError(f"scenario spec is not valid JSON: {e}") from None
    return parse_spec(raw)
