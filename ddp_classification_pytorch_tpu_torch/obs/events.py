"""Machine-readable event plane (`events.jsonl`) — the shared spine the
scenario supervisor, trainer, serve replicas and fleet all write to.

One JSON object per line, append-only, written by EVERY process of a
scenario run (trainer hosts, serve replicas, the supervisor, the load
generator) into the same file. A single `write()` of one line on a local
filesystem is atomic for our line sizes, so concurrent appenders interleave
whole records, never torn ones; the reader still skips an unparseable tail
line (a process killed mid-append — exactly what the chaos drill stages).

Producers inside the trainer/server call the module-level `emit()`, which
is a no-op unless the scenario supervisor armed the process via env:

- ``SCENARIO_EVENTS`` — absolute path of the shared events.jsonl;
- ``SCENARIO_SOURCE`` — who is speaking (``trainer.h0``, ``replica1``,
  ``supervisor``, ``loadgen``); defaults to ``pid<N>``.

Production runs never set the env, so the hooks cost one dict lookup and
change nothing.

Event vocabulary (fields beyond ts/kind/source):

    publish        epoch, path, digest, world_size   trainer host 0
    publish_torn   epoch, path                       chaos tore the candidate
    quarantine     path, reason                      any verifier's rename
    verify_ok      epoch, path, digest               watcher, pre-swap
    swap           epoch, digest                     watcher, post-adopt
    watcher_error  error, poll, backoff_s            watcher poll survived an
                                                     fs fault (backing off)
    serve_ready    port, epoch                       replica finished warmup
    drain_begin    queued / drain_end                replica graceful drain
    reform         gen, world                        fleet membership write
    replica_start  replica, port / replica_stop      supervisor
    request        status, replica, digest?,         load generator; status ∈
                   generation?, code?                ok|busy|draining|refused|error
    lint           rc                                end-of-run analyzer gate
    scenario_start / scenario_end                    supervisor brackets

Serve-fleet control plane (serve/fleet.py + supervisor autoscaling; the
S5 invariant replays these):

    drain_token_acquire   replica, digest            wave slot taken — this
                                                     replica is draining
    drain_token_release   replica, digest,           wave slot freed post-swap
                          generation
    drain_token_takeover  replica, stale_holder?     TTL-stale token replaced
                                                     (wedged holder evicted)
    admission_shed        tenant, queue_depth,       admission layer refused a
                          est_wait_ms                request (503 forensics)
    spike_load            rps                        supervisor stepped the
                                                     offered load
    scale_out             replica, replicas,         autoscaler added a replica
                          queue_depth, p99_ms,
                          offered_rps
    scale_in              replica, replicas,         autoscaler retiring one
                          queue_depth, fill_ratio
    replica_retire        replica                    retired replica excused
                                                     from future S3 adoption

The port's copy of the JAX package's `obs/events.py`, record for record:
a port process and a JAX process appending to one `events.jsonl` write
the same vocabulary, and the JAX package's `read_events` /
`validate_events` read what the port writes. The port's trainer
(`publish`, `quarantine`, `reform`) and server (the serve rows) emit when
the variables are set; the scenario supervisor (`scenario/supervisor.py`)
writes the rest.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List

ENV_EVENTS = "SCENARIO_EVENTS"
ENV_SOURCE = "SCENARIO_SOURCE"

# The event vocabulary, machine-readable: kind → required fields beyond
# the ts/kind/source envelope (the fields the S1–S5 checkers and the
# fuzz replayer actually read; producers may append extras freely).
# `cli.scenario --check_only` validates a replayed timeline against this
# so a corrupt forensics file fails loudly (rc 2) instead of vacuously
# passing with its evidence silently skipped.
EVENT_SCHEMA: Dict[str, tuple] = {
    "scenario_start": (),
    "scenario_end": (),
    "publish": ("epoch", "path", "digest"),
    "publish_torn": ("epoch", "path"),
    "quarantine": ("path",),
    "verify_ok": ("epoch", "path", "digest"),
    "swap": ("epoch", "digest"),
    "watcher_error": ("error", "poll"),
    "serve_ready": ("port",),
    "drain_begin": (),
    "drain_end": (),
    "reform": ("gen", "world"),
    "replica_start": ("replica", "port"),
    "replica_stop": ("replica", "rc"),
    "request": ("status", "replica"),
    "lint": ("rc",),
    "timeline": ("action",),
    "spike_load": ("rps",),
    "host_lost_observed": ("host",),
    "host_relaunch": ("host",),
    "drain_token_acquire": ("replica",),
    "drain_token_release": ("replica",),
    "drain_token_takeover": ("replica",),
    "admission_shed": ("tenant",),
    "scale_out": ("replica", "replicas"),
    "scale_in": ("replica", "replicas"),
    "replica_retire": ("replica",),
}


def validate_events(events: List[Dict]) -> List[str]:
    """Schema errors for a replayed timeline: unknown kinds and missing
    required fields (per ``EVENT_SCHEMA``), plus a missing ts/source
    envelope. Empty list = clean. Live runs stay tolerant (a hole is
    missing evidence, not a crash); replays of committed forensics must
    not be — a checker fed a half-vocabulary timeline proves nothing."""
    errors: List[str] = []
    for i, rec in enumerate(events):
        kind = rec.get("kind")
        if kind not in EVENT_SCHEMA:
            errors.append(f"event[{i}]: unknown kind {kind!r}")
            continue
        missing = [f for f in ("ts", "source") + EVENT_SCHEMA[kind]
                   if f not in rec]
        if missing:
            errors.append(f"event[{i}] kind={kind}: missing "
                          f"required field(s) {missing}")
    return errors


class EventLog:
    """Explicit-path appender for processes that own their identity (the
    supervisor and its load generator); in-tree hooks use `emit()`."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def emit(self, kind: str, **fields: Any) -> None:
        write_event(self.path, self.source, kind, fields)


def write_event(path: str, source: str, kind: str, fields: Dict) -> None:
    rec = {"ts": round(time.time(), 6), "kind": kind, "source": source}
    rec.update(fields)
    line = json.dumps(rec, sort_keys=True) + "\n"
    try:
        with open(path, "a") as f:
            f.write(line)
    except OSError:
        # losing an event must never take down training or serving — the
        # invariant checker treats a hole as missing evidence, not a crash
        pass


def emit(kind: str, **fields: Any) -> None:
    """Env-gated hook for trainer/serve/fleet code: record `kind` into the
    scenario event log IF this process runs under a scenario supervisor
    (``SCENARIO_EVENTS`` set); free and silent otherwise."""
    path = os.environ.get(ENV_EVENTS, "")
    if not path:
        return
    source = os.environ.get(ENV_SOURCE) or f"pid{os.getpid()}"
    write_event(path, source, kind, fields)


def read_events(path: str) -> List[Dict]:
    """Parse an events.jsonl; skips blank and torn lines (a producer
    SIGKILLed mid-append leaves at most one unparseable record)."""
    out: List[Dict] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "kind" in rec:
                out.append(rec)
    out.sort(key=lambda r: r.get("ts", 0.0))
    return out
