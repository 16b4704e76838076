"""The numbers a scenario run leaves in its `events.jsonl`, read back:
what the checkers judge, as measurements (standard library only).

- `adoption_s`: per good publish, the seconds until each replica serves
  it (its first `swap` to that epoch or newer after the publish; None
  when it never did);
- `min_availability`: the lowest alive share over S2's sliding windows
  (`window_s` wide, 1-s steps, windows under `min_samples` skipped);
- `request_ms`: the load generator's client latency (`latency_ms` of the
  answered requests), p50 and p99 by nearest rank, and the count of each
  status;
- `replica_stops` / `host_lost`: each replica exit's rc and each lost
  host's;
- `spike_to_scale_out_s`: per `spike_load`, the seconds to the first
  `scale_out` at or after it (None when none came).

`chip_smoke.py` phase 30 prints it beside the card's name.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from .invariants import good_publishes
from .spec import ScenarioSpec

_ALIVE = ("ok", "busy", "draining")


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """The q-quantile (0 < q <= 1) by nearest rank; None for no values."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def min_availability(events: Sequence[Dict], spec: ScenarioSpec,
                     t0: float = 0.0) -> Optional[Dict]:
    """The window of S2's walk with the lowest alive share (the first such
    window; its start and end in seconds after `t0`), or None when no
    window holds `min_samples` requests."""
    samples = [(float(e.get("ts", 0.0)), e.get("status") in _ALIVE)
               for e in events if e.get("kind") == "request"]
    if not samples:
        return None
    window = spec.availability.window_s
    best = None
    start, t_end = samples[0][0], samples[-1][0]
    while start <= t_end:
        in_win = [a for ts, a in samples if start <= ts < start + window]
        if len(in_win) >= spec.availability.min_samples:
            ratio = sum(in_win) / len(in_win)
            if best is None or ratio < best["ratio"]:
                best = {"ratio": ratio, "start": start - t0,
                        "end": start + window - t0, "alive": sum(in_win),
                        "requests": len(in_win)}
        start += 1.0
    return best


def timeline_report(events: Sequence[Dict], spec: ScenarioSpec) -> Dict:
    t0 = float(events[0].get("ts", 0.0)) if events else 0.0
    replicas = sorted({str(e.get("source", "")) for e in events
                       if e.get("kind") == "serve_ready"})
    swaps = [e for e in events if e.get("kind") == "swap"]
    adoption = []
    for pub in good_publishes(events):
        t_pub, epoch = float(pub.get("ts", 0.0)), int(pub.get("epoch", -1))
        per = {}
        for r in replicas:
            first = next((float(s["ts"]) for s in swaps
                          if str(s.get("source", "")) == r
                          and int(s.get("epoch", -1)) >= epoch
                          and float(s.get("ts", 0.0)) >= t_pub), None)
            per[r] = None if first is None else first - t_pub
        adoption.append({"epoch": epoch, "at_s": t_pub - t0,
                         "digest": str(pub.get("digest", ""))[:12],
                         "replicas": per})
    reqs = [e for e in events if e.get("kind") == "request"]
    ok_ms = [float(e["latency_ms"]) for e in reqs
             if e.get("status") == "ok" and "latency_ms" in e]
    statuses: Dict[str, int] = {}
    for e in reqs:
        statuses[str(e.get("status"))] = statuses.get(
            str(e.get("status")), 0) + 1
    scale_ts = [float(e.get("ts", 0.0)) for e in events
                if e.get("kind") == "scale_out"]
    spikes: List[Dict] = []
    for e in events:
        if e.get("kind") == "spike_load":
            t = float(e.get("ts", 0.0))
            after = [s - t for s in scale_ts if s >= t]
            spikes.append({"at_s": t - t0, "rps": e.get("rps"),
                           "to_scale_out_s": min(after) if after else None})
    return {
        "adoption_s": adoption,
        "min_availability": min_availability(events, spec, t0),
        "request_ms": {"p50": nearest_rank(ok_ms, 0.5),
                       "p99": nearest_rank(ok_ms, 0.99), "n": len(ok_ms),
                       "statuses": dict(sorted(statuses.items()))},
        "replica_stops": [
            {"replica": e.get("replica"), "rc": e.get("rc"),
             "deliberate": e.get("deliberate"),
             "at_s": float(e.get("ts", 0.0)) - t0}
            for e in events if e.get("kind") == "replica_stop"],
        "host_lost": [{"host": e.get("host"), "rc": e.get("rc"),
                       "at_s": float(e.get("ts", 0.0)) - t0}
                      for e in events if e.get("kind") == "host_lost_observed"],
        "spike_to_scale_out_s": spikes,
    }
