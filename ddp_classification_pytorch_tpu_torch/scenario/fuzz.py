"""Coverage-steered property-based fuzzer over the scenario grammar — the
port's copy of the JAX package's `scenario/fuzz.py`: given one seed, the
same draws, coverage keys, simulated events, shrinks and ledger, byte for
byte. Four pieces, all seeded and fully deterministic:

- **SpecSampler** — draws random *valid* `ScenarioSpec`s from the
  `scenario/spec.py` grammar: trainer fault kinds enumerated from the
  `utils/chaos.py` ``FAULT_GRAMMAR`` table (never hardcoded — a new
  fault kind automatically enters the search space) × serve kinds ×
  timeline actions × host/replica counts × timing jitter. Every draw is
  shrunken-drill sized (tiny ``synthetic_size``, short deadlines) and
  stays inside the system's operating contract — kills only with a
  spare replica, spikes only with the autoscaler armed, at least one
  clean publish — so ANY S1–S5 violation is a bug, not an intended
  outage.
- **CoverageLedger** — a persistent JSON ledger over
  ``(fault kind × subsystem)`` pair keys (``"<kind>x<subsystem>"``),
  where overlap windows turn co-occurring elements into cross-subsystem
  pairs: a ``watcher_io`` poll fault overlapping a torn publish covers
  ``watcher_iox{publish}`` AND ``publish_corruptx{watcher}`` — the
  watcher-vs-quarantine race. The sampler draws several candidates and
  keeps the one touching the most uncovered pairs, so generation visibly
  steers toward the races no hand-written phase exercises
  (drain-during-reform, publish-during-scale-out,
  kill-holder-during-takeover).
- **simulate_events** — a deterministic model of a *correctly behaving*
  system: it plays a spec forward into the exact `events.jsonl`
  vocabulary (obs/events.py) the real drill records — publishes, torn
  candidates + quarantines, supervised restarts resuming from the
  newest good checkpoint (re-publishing condemned epochs), elastic
  re-forms, watcher backoff, rolling drain-token waves, autoscaler
  scale-outs, and a failover-aware request stream. Replaying the sim
  through `check_invariants` is the fuzzer's fast runner (~ms/spec):
  a red sim means the CHECKERS disagree with correct behavior — the
  checker-bug half of the search space (two found while building it:
  see `good_publishes` and S5(c)). `DrillRunner` is the slow runner:
  the same spec through the real `ScenarioSupervisor`, for the
  process-bug half (`cli/fuzz.py --runner drill`).
- **shrink_spec** — delta-minimization: drop fault atoms → drop
  timeline items → shrink timing → shrink topology (re-homing a
  dropped host/replica's faults onto index 0), re-running the failure
  predicate after each cut, looping passes to a fixpoint under a run
  cap. The result serializes losslessly (`ScenarioSpec.to_json`) for
  committing as a regression case and replaying via
  `cli/scenario.py --check_only`.

`Fuzzer` glues them: sample → record coverage → run → on failure,
shrink and report. `cli/fuzz.py` is the entry point (rc 0 green / 1
minimized failure found / 2 bad args).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from random import Random
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..utils import chaos as chaoslib
from .invariants import Violation, check_invariants
from .spec import ScenarioSpec, SpecError, parse_spec, spec_to_raw

# timeline actions are injection elements too: which subsystem absorbs
# each (the chaos FAULT_GRAMMAR's sibling for supervisor-side faults)
ACTION_SUBSYSTEM = {
    "drain_replica": "drain",
    "kill_replica": "replica",
    "kill_replica_during_wave": "wave",
    "spike_load": "autoscaler",
}

# sim/coverage time model: one step ≈ one second, supervisor warmup ≈ 3 s
_STEP_S = 1.0
_WARM_S = 3.0


def _steps_per_epoch(spec: ScenarioSpec) -> int:
    return max(1, spec.trainer.synthetic_size // max(1, spec.trainer.batchsize))


# --------------------------------------------------------------- coverage --

def _fault_elements(spec: ScenarioSpec) -> List[Tuple[str, str, float, float]]:
    """(kind, subsystem, t_lo, t_hi) for every injection element of the
    spec — chaos fault atoms AND timeline actions — under the heuristic
    time model. Windows only need to be roughly right: they decide which
    elements *overlap*, i.e. which cross-subsystem races a spec stages."""
    spe = _steps_per_epoch(spec)
    out: List[Tuple[str, str, float, float]] = []

    def unit_window(f: "chaoslib.Fault") -> Tuple[float, float]:
        hi = f.lo + 5 if f.hi is None else f.hi
        if f.unit == "epoch":
            return _WARM_S + f.lo * spe * _STEP_S, \
                _WARM_S + (hi + 1) * spe * _STEP_S
        if f.unit == "poll":
            poll = float(spec.serve.poll_s)
            return _WARM_S + f.lo * poll, _WARM_S + (hi + 1) * poll
        # step/batch ≈ seconds from warmup
        return _WARM_S + f.lo * _STEP_S, _WARM_S + (hi + 1) * _STEP_S

    for specs in (spec.trainer.fault_specs, spec.serve.fault_specs):
        for fault_spec in specs.values():
            for f in chaoslib.FaultPlan.parse(fault_spec).faults:
                lo, hi = unit_window(f)
                out.append((f.kind, chaoslib.subsystem_of(f.kind), lo, hi))
    for item in spec.timeline:
        if item.at_kind == "t":
            lo = float(item.at_value)
        else:  # publish:E fires when epoch E lands
            lo = _WARM_S + (item.at_value + 1) * spe * _STEP_S
        out.append((item.action, ACTION_SUBSYSTEM[item.action], lo, lo + 5.0))
    return out


def coverage_keys(spec: ScenarioSpec) -> Set[str]:
    """The ledger keys a spec exercises: each element covers its own
    ``kindxsubsystem`` pair, and every OVERLAPPING pair of elements in
    different subsystems covers both cross pairs — the races."""
    elems = _fault_elements(spec)
    keys = {f"{kind}x{sub}" for kind, sub, _, _ in elems}
    for i, (k1, s1, lo1, hi1) in enumerate(elems):
        for k2, s2, lo2, hi2 in elems[i + 1:]:
            if s1 == s2:
                continue
            if lo1 <= hi2 and lo2 <= hi1:  # windows overlap
                keys.add(f"{k1}x{s2}")
                keys.add(f"{k2}x{s1}")
    return keys


def pair_universe() -> List[str]:
    """Every plausible ledger key: each injection element crossed with
    every subsystem (its own = the element fired at all; another's = the
    two overlapped). The ledger's `uncovered()` report ranges over this."""
    kinds = dict(ACTION_SUBSYSTEM)
    kinds.update({k: chaoslib.subsystem_of(k) for k in chaoslib.KINDS})
    subsystems = sorted(set(kinds.values()))
    return sorted(f"{k}x{s}" for k in kinds for s in subsystems)


class CoverageLedger:
    """Persistent ``(fault kind × subsystem)`` coverage counts. Survives
    across fuzz runs (``$OUT/fuzz_ledger.json``) so a nightly budget
    keeps pushing into uncovered territory instead of re-rolling the
    same easy pairs."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.pairs: Dict[str, int] = {}
        self.specs_run = 0

    @classmethod
    def load(cls, path: str) -> "CoverageLedger":
        led = cls(path)
        if os.path.exists(path):
            with open(path) as f:
                raw = json.load(f)
            pairs = raw.get("pairs", {})
            if isinstance(pairs, dict):
                led.pairs = {str(k): int(v) for k, v in pairs.items()}
            led.specs_run = int(raw.get("specs_run", 0))
        return led

    def record(self, keys: Set[str]) -> None:
        for k in keys:
            self.pairs[k] = self.pairs.get(k, 0) + 1
        self.specs_run += 1

    def distinct(self) -> int:
        return len(self.pairs)

    def uncovered(self, universe: Optional[Sequence[str]] = None) -> List[str]:
        return sorted(set(universe if universe is not None
                          else pair_universe()) - set(self.pairs))

    def save(self) -> None:
        if not self.path:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"pairs": dict(sorted(self.pairs.items())),
                       "specs_run": self.specs_run}, f, indent=2,
                      sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)


# ---------------------------------------------------------------- sampler --

class SpecSampler:
    """Seeded generator of valid, shrunken-drill-sized ScenarioSpecs.
    Same seed → byte-identical spec sequence (`to_json`), which is what
    makes a fuzz failure reproducible from its seed alone.

    With a ledger, each `sample()` draws `candidates` specs and keeps
    the one covering the most ledger-uncovered pairs (first wins ties) —
    coverage-steered generation. `last_candidates` exposes the scored
    batch so tests can assert the steering actually happened.
    """

    def __init__(self, seed: int = 0, candidates: int = 4):
        self.rng = Random(seed)
        self.candidates = max(1, int(candidates))
        self.last_candidates: List[Tuple[ScenarioSpec, int]] = []

    # every draw goes through parse_spec: the sampler can only ever emit
    # specs the grammar accepts (a draw the parser rejects is a bug HERE)
    def _draw(self) -> ScenarioSpec:
        rng = self.rng
        hosts = rng.choice([1, 1, 2, 2, 3])
        epochs = rng.choice([2, 3, 4])
        batchsize = 8
        synthetic_size = rng.choice([32, 64])
        spe = max(1, synthetic_size // batchsize)
        max_step = spe * epochs - 1
        replicas = rng.choice([1, 2, 2, 3])
        armed = rng.random() < 0.5
        max_replicas = replicas + rng.choice([1, 2]) if armed else 0

        trainer_faults: Dict[str, List[str]] = {}

        def add_trainer(host: int, atom: str) -> None:
            trainer_faults.setdefault(str(host), []).append(atom)

        lethal_budget = 1  # restart-churn bound: keeps drills short
        tear_budget = 2
        for _ in range(rng.randrange(0, 4)):
            kind = rng.choice(chaoslib.kinds_for_side("trainer"))
            host = rng.randrange(hosts)
            if kind == "nan_loss":
                lo = rng.randrange(1, max_step + 1)
                hi = min(lo + rng.randrange(0, 3), max_step)
                add_trainer(host, f"nan_loss@step={lo}..{hi}")
            elif kind in ("ckpt_io", "publish_corrupt"):
                if tear_budget <= 0 or epochs < 2:
                    continue
                tear_budget -= 1
                # never tear the final epoch: the fleet must end converged
                # on SOME good publish for S5(b) to have a target
                add_trainer(host, f"{kind}@epoch={rng.randrange(epochs - 1)}")
            elif kind == "peer_slow":
                add_trainer(host,
                            f"peer_slow@step={rng.randrange(1, max_step + 1)}")
            elif kind == "host_lost":
                # one host loss, aimed at a non-zero host with a quorum
                # left behind — the relaunch/re-form contract under test
                if lethal_budget <= 0 or hosts < 2:
                    continue
                lethal_budget -= 1
                add_trainer(rng.randrange(1, hosts),
                            f"host_lost@step={rng.randrange(1, max_step + 1)}")
            else:  # sigterm / peer_dead / loader_io: a supervised restart
                if lethal_budget <= 0:
                    continue
                lethal_budget -= 1
                if kind == "loader_io":
                    atom = f"loader_io@batch={rng.randrange(1, max_step + 1)}"
                else:
                    atom = f"{kind}@step={rng.randrange(1, max_step + 1)}"
                add_trainer(host, atom)

        serve_faults: Dict[str, List[str]] = {}
        for _ in range(rng.randrange(0, 3)):
            rep = rng.randrange(replicas)
            lo = rng.randrange(1, 7)
            hi = lo + rng.randrange(0, 2)
            serve_faults.setdefault(str(rep), []).append(
                f"watcher_io@poll={lo}" if hi == lo
                else f"watcher_io@poll={lo}..{hi}")

        timeline: List[dict] = []
        used_t: List[int] = []

        def pick_t() -> Optional[int]:
            for _ in range(8):
                t = rng.choice([10, 18, 26, 34, 42, 50])
                if all(abs(t - u) >= 8 for u in used_t):
                    used_t.append(t)
                    return t
            return None

        for _ in range(rng.randrange(0, 4)):
            action = rng.choice(list(ACTION_SUBSYSTEM))
            if action == "spike_load":
                if max_replicas <= replicas:
                    continue  # unarmed spike proves nothing
                t = pick_t()
                if t is not None:
                    timeline.append({"at": f"t:{t}", "action": action,
                                     "rps": 12.0})
            elif action == "kill_replica_during_wave":
                if replicas < 2:
                    continue
                t = pick_t()
                if t is not None:
                    timeline.append({"at": f"t:{t}", "action": action})
            else:  # drain_replica / kill_replica need a spare replica
                if replicas < 2:
                    continue
                target = rng.randrange(replicas)
                if rng.random() < 0.3:
                    timeline.append({"at": f"publish:{rng.randrange(epochs)}",
                                     "action": action, "replica": target})
                else:
                    t = pick_t()
                    if t is not None:
                        timeline.append({"at": f"t:{t}", "action": action,
                                         "replica": target})

        raw = {
            "trainer": {
                "hosts": hosts, "elastic": True, "min_processes": 1,
                "epochs": epochs, "model": "resnet18", "variant": "cifar",
                "num_classes": 4, "image_size": 16, "batchsize": batchsize,
                "synthetic_size": synthetic_size, "relaunch_lost": True,
                "fault_specs": {h: ",".join(a)
                                for h, a in sorted(trainer_faults.items())},
            },
            "serve": {
                "replicas": replicas, "poll_s": 1.0, "queue_depth": 16,
                "max_batch": 4, "buckets": "1,4",
                "max_replicas": max_replicas, "fleet_ttl_s": 6.0,
                "admission_deadline_ms": 0.0, "scale_out_deadline_s": 30.0,
                "fault_specs": {r: ",".join(a)
                                for r, a in sorted(serve_faults.items())},
            },
            "load": {"rps": 4.0, "timeout_s": 20.0},
            "availability": {"floor": 0.5, "window_s": 10.0, "min_samples": 3},
            "adopt_deadline_s": 60.0,
            "deadline_s": 240.0,
            "timeline": timeline,
        }
        return parse_spec(raw)

    def sample(self, ledger: Optional[CoverageLedger] = None) -> ScenarioSpec:
        cands = [self._draw() for _ in range(self.candidates)]
        if ledger is None:
            self.last_candidates = [(c, 0) for c in cands]
            return cands[0]
        scores = [len(coverage_keys(c) - set(ledger.pairs)) for c in cands]
        self.last_candidates = list(zip(cands, scores))
        best = max(range(len(cands)), key=lambda i: (scores[i], -i))
        return cands[best]


# -------------------------------------------------------------- simulator --

def simulate_events(spec: ScenarioSpec,
                    bugs: Sequence[str] = ()) -> List[Dict]:
    """Deterministic model of a CORRECT run of `spec`, in the real
    events.jsonl vocabulary. No randomness, no wall clock: replaying the
    result through `check_invariants` must be green — a red is a checker
    bug (the fast half of the fuzz search space).

    `bugs` plays known-bad behavior models instead, for red-path corpus
    cases and end-to-end pipeline tests:

    - ``"adopt_unverified"`` — watchers swap without sha256-verifying
      (the regression S1 exists to catch): no ``verify_ok`` events.
    - ``"spike_unanswered"`` — the autoscaler ignores every spike (S5(c)
      red when armed and below max).
    """
    bugs = set(bugs)
    ev: List[Dict] = []

    def add(ts: float, kind: str, source: str, **fields) -> None:
        rec = {"ts": round(ts, 3), "kind": kind, "source": source}
        rec.update(fields)
        ev.append(rec)

    spe = _steps_per_epoch(spec)
    poll = float(spec.serve.poll_s)
    add(0.0, "scenario_start", "supervisor")

    # ---- trainer pass: publishes, tears, supervised restarts, re-forms
    restart_faults: List[Dict] = []   # fire once, send the pod back to resume
    tear_faults: List[Dict] = []      # fire once, condemn that epoch's write
    stall_faults: List[Dict] = []     # fire once, stretch the epoch
    for h_str, fault_spec in sorted(spec.trainer.fault_specs.items()):
        for f in chaoslib.FaultPlan.parse(fault_spec).faults:
            entry = {"fault": f, "host": int(h_str), "fired": False}
            if f.kind in ("sigterm", "peer_dead", "host_lost", "loader_io"):
                step = f.lo if f.unit in ("step", "batch") else f.lo * spe
                entry["step"] = step
                restart_faults.append(entry)
            elif f.kind in ("ckpt_io", "publish_corrupt"):
                entry["epoch"] = f.lo if f.unit == "epoch" else f.lo // spe
                tear_faults.append(entry)
            elif f.kind == "peer_slow":
                entry["step"] = f.lo
                stall_faults.append(entry)
            # nan_loss: the sentinel absorbs it in-step; no timeline trace

    t = _WARM_S
    epoch = 0
    gen = 0
    goods: List[Dict] = []        # {"ts","epoch","path","digest"}
    torn: List[Dict] = []         # {"ts","epoch","path"}
    rewrites: Dict[int, int] = {}
    guard = 0
    while epoch < spec.trainer.epochs and guard < 10 * spec.trainer.epochs:
        guard += 1
        lo_step, hi_step = epoch * spe, (epoch + 1) * spe
        for entry in stall_faults:
            if not entry["fired"] and lo_step <= entry["step"] < hi_step:
                entry["fired"] = True
                t += 15.0  # a straggler stalls the pod, nothing escalates
        fire = min((e for e in restart_faults
                    if not e["fired"] and lo_step <= e["step"] < hi_step),
                   key=lambda e: e["step"], default=None)
        if fire is not None:
            fire["fired"] = True
            t_fire = t + (fire["step"] - lo_step) * _STEP_S
            if fire["fault"].kind == "host_lost":
                add(t_fire + 1.0, "host_lost_observed", "supervisor",
                    host=fire["host"], rc=-9)
                gen += 1
                add(t_fire + 2.0, "reform", "trainer.h0", gen=gen,
                    world=max(1, spec.trainer.hosts - 1))
                if spec.trainer.relaunch_lost and spec.trainer.hosts > 1:
                    add(t_fire + 6.0, "host_relaunch", "supervisor",
                        host=fire["host"])
                    gen += 1
                    add(t_fire + 8.0, "reform", "trainer.h0", gen=gen,
                        world=spec.trainer.hosts)
                t = t_fire + 9.0
            else:
                t = t_fire + 3.0  # supervise.sh relaunch
            # auto_resume: newest non-condemned write wins; condemned
            # epochs after it get re-run and RE-published (same path,
            # fresh digest) — the shape the good_publishes fix covers
            resume = max((g["epoch"] for g in goods), default=-1)
            epoch = resume + 1
            continue
        t += spe * _STEP_S
        path = f"ckpt_e{epoch:03d}"
        n = rewrites.get(epoch, 0)
        rewrites[epoch] = n + 1
        digest = f"sha-e{epoch:03d}-w{n}-{'0' * 8}"
        tear = next((e for e in tear_faults
                     if not e["fired"] and e["epoch"] == epoch), None)
        add(t, "publish", "trainer.h0", epoch=epoch, path=path,
            digest=digest, world_size=spec.trainer.hosts)
        if tear is not None:
            tear["fired"] = True
            add(t + 0.05, "publish_torn", "trainer.h0", epoch=epoch, path=path)
            torn.append({"ts": t, "epoch": epoch, "path": path})
        else:
            goods.append({"ts": t, "epoch": epoch, "path": path,
                          "digest": digest})
        epoch += 1

    # ---- serve pass: replica lifecycle sessions
    # session = [ready_ts, end_ts or None]; source name survives relaunch
    sessions: Dict[int, List[List[Optional[float]]]] = {}
    digests: Dict[int, List[Tuple[float, str]]] = {}

    def open_session(r: int, ready_ts: float, port_base: int = 9000) -> None:
        add(ready_ts - 0.8, "replica_start", "supervisor",
            replica=f"replica{r}", port=port_base + r)
        add(ready_ts, "serve_ready", f"replica{r}", port=port_base + r)
        sessions.setdefault(r, []).append([ready_ts, None])
        digests.setdefault(r, []).append((ready_ts, "fresh"))

    def close_session(r: int, end_ts: float) -> None:
        for s in sessions.get(r, []):
            if s[1] is None:
                s[1] = end_ts

    def up_at(r: int, ts: float) -> bool:
        return any(s[0] <= ts and (s[1] is None or ts < s[1])
                   for s in sessions.get(r, []))

    def next_up(r: int, ts: float) -> Optional[float]:
        best = None
        for s in sessions.get(r, []):
            if s[1] is not None and s[1] <= ts:
                continue
            cand = max(ts, s[0])
            if s[1] is None or cand < s[1]:
                best = cand if best is None else min(best, cand)
        return best

    for r in range(spec.serve.replicas):
        open_session(r, 1.0 + 0.3 * r)

    # timeline firings (wall-clock and publish-gated)
    def fire_ts(item) -> Optional[float]:
        if item.at_kind == "t":
            return float(item.at_value)
        pub = next((p for p in sorted(goods + torn, key=lambda p: p["ts"])
                    if p["epoch"] == item.at_value), None)
        return None if pub is None else pub["ts"] + 0.2

    kills = []      # (tf, item) for drain/kill
    wave_kills = [] # [tf, consumed]
    spikes = []     # (tf, rps)
    for item in spec.timeline:
        tf = fire_ts(item)
        if tf is None:
            continue
        if item.action == "spike_load":
            spikes.append((tf, item.rps))
        elif item.action == "kill_replica_during_wave":
            add(tf, "timeline", "supervisor", action=str(item))
            wave_kills.append([tf, False])
        else:
            kills.append((tf, item))
    for tf, item in sorted(kills, key=lambda k: k[0]):
        r = item.replica
        add(tf, "timeline", "supervisor", action=str(item),
            target=f"replica{r}")
        if item.action == "drain_replica":
            add(tf + 0.1, "drain_begin", f"replica{r}", queued=0)
            add(tf + 0.6, "drain_end", f"replica{r}")
            add(tf + 0.7, "replica_stop", "supervisor", replica=f"replica{r}",
                rc=0, deliberate=True)
        else:
            add(tf + 0.1, "replica_stop", "supervisor", replica=f"replica{r}",
                rc=-9, deliberate=True)
        close_session(r, tf + 0.1)
        open_session(r, tf + 2.0)

    # autoscaler: spike → scale_out within deadline, unless at max
    fleet = spec.serve.replicas
    armed = spec.serve.max_replicas > spec.serve.replicas
    for tf, rps in sorted(spikes):
        add(tf, "timeline", "supervisor",
            action=f"spike_load@t:{int(tf)}(rps={rps})")
        add(tf + 0.05, "spike_load", "supervisor", rps=rps)
        if armed and fleet < spec.serve.max_replicas \
                and "spike_unanswered" not in bugs:
            r_new = fleet
            fleet += 1
            add(tf + 3.0, "scale_out", "supervisor", replica=f"replica{r_new}",
                replicas=fleet, queue_depth=12, p99_ms=80.0, offered_rps=rps)
            open_session(r_new, tf + 5.0)

    # watcher faults: per-replica one-shot poll failures → backoff delays
    watcher_delays: Dict[int, List[List]] = {}
    for r_str, fault_spec in sorted(spec.serve.fault_specs.items()):
        for f in chaoslib.FaultPlan.parse(fault_spec).faults:
            if f.kind != "watcher_io":
                continue
            t_wf = _WARM_S + f.lo * poll
            add(t_wf, "watcher_error", f"replica{r_str}", error="EIO",
                poll=f.lo, backoff_s=round(2 * poll, 3))
            watcher_delays.setdefault(int(r_str), []).append([t_wf, False])

    def poll_delay(r: int, t_poll: float) -> float:
        extra = 0.0
        for entry in watcher_delays.get(r, []):
            if not entry[1] and entry[0] <= t_poll:
                entry[1] = True
                extra += 2 * poll  # bounded backoff, then re-arm
        return extra

    # quarantines: the first polling replica condemns a torn candidate
    for tp in torn:
        r_q = next((r for r in sorted(sessions)
                    if up_at(r, tp["ts"] + poll)), None)
        if r_q is not None:
            add(tp["ts"] + poll, "quarantine", f"replica{r_q}",
                path=tp["path"], reason="sha256 mismatch")

    # adoption waves: each good publish rolls through the fleet behind
    # the drain token, one replica draining at a time; a wave-kill leaves
    # the token wedged until its TTL expires, and the next adopter must
    # prove it stale and take over before acquiring
    token_free = 0.0
    wedged_holder: Optional[int] = None
    goods_sorted = sorted(goods, key=lambda g: g["ts"])

    def adopt(r: int, start: float, g: Dict) -> float:
        nonlocal wedged_holder
        if wedged_holder is not None:
            add(start, "drain_token_takeover", f"replica{r}",
                replica=f"replica{r}", stale_holder=f"replica{wedged_holder}")
            wedged_holder = None
        add(start, "drain_token_acquire", f"replica{r}", replica=f"replica{r}",
            digest=g["digest"])
        if "adopt_unverified" not in bugs:
            add(start + 0.1, "verify_ok", f"replica{r}", epoch=g["epoch"],
                path=g["path"], digest=g["digest"])
        add(start + 0.2, "swap", f"replica{r}", epoch=g["epoch"],
            digest=g["digest"])
        add(start + 0.3, "drain_token_release", f"replica{r}",
            replica=f"replica{r}", digest=g["digest"], generation=g["epoch"])
        digests.setdefault(r, []).append((start + 0.2, g["digest"]))
        return start + 0.3

    for gi, g in enumerate(goods_sorted):
        nxt = goods_sorted[gi + 1]["ts"] if gi + 1 < len(goods_sorted) else None
        retries: List[Tuple[int, float]] = []
        for r in sorted(sessions):
            t_up = next_up(r, g["ts"] + poll)
            if t_up is None:
                continue
            base = t_up + poll_delay(r, t_up)
            if nxt is not None and nxt <= base:
                continue  # a newer candidate lands first; watcher takes that
            start = max(base, token_free)
            wk = next((w for w in wave_kills if not w[1] and w[0] <= start),
                      None)
            if wk is not None:
                # this replica is the token holder when the timeline kills
                # it: acquire, die, never release — the token stays wedged
                # for a full lease TTL. Acquiring over an ALREADY-wedged
                # token is itself a takeover (the fleet's last-writer-wins
                # semantics) — two back-to-back wave kills stage exactly
                # that, and skipping the takeover here is an S5(a) red
                wk[1] = True
                if wedged_holder is not None:
                    add(start, "drain_token_takeover", f"replica{r}",
                        replica=f"replica{r}",
                        stale_holder=f"replica{wedged_holder}")
                    wedged_holder = None
                add(start, "drain_token_acquire", f"replica{r}",
                    replica=f"replica{r}", digest=g["digest"])
                add(start + 0.2, "replica_stop", "supervisor",
                    replica=f"replica{r}", rc=-9, deliberate=True)
                close_session(r, start + 0.2)
                open_session(r, start + 2.2)
                token_free = start + float(spec.serve.fleet_ttl_s)
                wedged_holder = r
                retries.append((r, start + 2.4))
                continue
            token_free = adopt(r, start, g)
        for r, t_r in retries:
            start = max(t_r, token_free)
            token_free = adopt(r, start, g)

    # ---- request stream: failover-aware, bounded sample count
    last_ts = max((r["ts"] for r in ev), default=_WARM_S)
    t_load_end = last_ts + 2.0
    segments = [(2.0, float(spec.load.rps))]
    for tf, rps in sorted(spikes):
        segments.append((tf, float(rps)))
    samples: List[float] = []
    for i, (seg_t, seg_rps) in enumerate(segments):
        seg_end = segments[i + 1][0] if i + 1 < len(segments) else t_load_end
        dt = max(1.0 / seg_rps, 0.05)
        ts = seg_t
        while ts < seg_end and len(samples) < 400:
            samples.append(ts)
            ts += dt

    def digest_at(r: int, ts: float) -> str:
        cur = "fresh"
        for t_d, d in sorted(digests.get(r, [])):
            if t_d <= ts:
                cur = d
        return cur

    rr = 0
    for ts in samples:
        up = [r for r in sorted(sessions) if up_at(r, ts)]
        if not up:
            add(ts, "request", "loadgen", status="refused", replica="-")
            continue
        r = up[rr % len(up)]
        rr += 1
        add(ts, "request", "loadgen", status="ok", replica=f"replica{r}",
            digest=digest_at(r, ts), generation=0)

    t_end = t_load_end + 1.0
    add(t_end, "lint", "supervisor", rc=0)
    add(t_end + 0.1, "scenario_end", "supervisor", ok=True, failures=0)
    ev.sort(key=lambda r: r["ts"])
    return ev


def sim_runner(spec: ScenarioSpec,
               bugs: Sequence[str] = ()) -> List[Violation]:
    """The fast fuzz runner: correct-behavior simulation → checkers.
    Any violation is a checker/model disagreement worth a human look."""
    return check_invariants(simulate_events(spec, bugs=bugs), spec,
                            require_lint=True)


class DrillRunner:
    """The slow fuzz runner: the spec through the real
    `ScenarioSupervisor` (subprocesses, real faults, every child on
    `device`). Lint is skipped per case (S4 has its own lane). A
    supervisor rc != 0 without a checker violation still fails the case
    (invariant "RUN")."""

    def __init__(self, out_root: str, skip_lint: bool = True,
                 device: str = "cuda"):
        self.out_root = out_root
        self.skip_lint = skip_lint
        self.device = device
        self.cases = 0

    def __call__(self, spec: ScenarioSpec) -> List[Violation]:
        from ..obs.events import read_events
        from .supervisor import ScenarioSupervisor

        self.cases += 1
        out = os.path.join(self.out_root, f"case{self.cases:04d}")
        events_path = os.path.join(out, "events.jsonl")
        sup = ScenarioSupervisor(spec, out, events_path,
                                 skip_lint=self.skip_lint, device=self.device)
        rc = sup.run()
        events = read_events(events_path)
        restarts = os.path.join(out, "restarts.log")
        out_v = check_invariants(
            events, spec,
            restarts_logs=[restarts] if os.path.exists(restarts) else None,
            require_lint=not self.skip_lint)
        if rc != 0 and not out_v:
            out_v = [Violation("RUN", f"supervisor rc={rc}: "
                                      + "; ".join(sup.failures[:3]))]
        return out_v


# --------------------------------------------------------------- shrinker --

def _clone(raw: dict) -> dict:
    return json.loads(json.dumps(raw))


def _atoms(raw: dict, side: str, idx: str) -> List[str]:
    return [a for a in raw[side]["fault_specs"].get(idx, "").split(",") if a]


def _set_atoms(raw: dict, side: str, idx: str, atoms: List[str]) -> None:
    if atoms:
        raw[side]["fault_specs"][idx] = ",".join(atoms)
    else:
        raw[side]["fault_specs"].pop(idx, None)


def _shrink_candidates(raw: dict) -> List[dict]:
    """One round of delta cuts, most-aggressive first within each class:
    drop fault atoms → drop timeline items → shrink timing → shrink
    topology. Each candidate is a full clone; invalid ones are discarded
    by the parse step in `shrink_spec`."""
    cands: List[dict] = []

    # 1. drop individual fault atoms
    for side in ("trainer", "serve"):
        for idx in sorted(raw[side]["fault_specs"]):
            atoms = _atoms(raw, side, idx)
            for i in range(len(atoms)):
                c = _clone(raw)
                _set_atoms(c, side, idx, atoms[:i] + atoms[i + 1:])
                cands.append(c)

    # 2. drop timeline items
    for i in range(len(raw["timeline"])):
        c = _clone(raw)
        del c["timeline"][i]
        cands.append(c)

    # 3. shrink timing: collapse ranges, halve offsets and deadlines
    for side in ("trainer", "serve"):
        for idx in sorted(raw[side]["fault_specs"]):
            atoms = _atoms(raw, side, idx)
            for i, atom in enumerate(atoms):
                f = chaoslib.FaultPlan.parse(atom).faults[0]
                smaller = []
                if f.hi != f.lo:
                    smaller.append(chaoslib.Fault(f.kind, f.unit, f.lo, f.lo))
                if f.lo > 0:
                    smaller.append(
                        chaoslib.Fault(f.kind, f.unit, f.lo // 2,
                                       f.lo // 2 if f.hi == f.lo else f.hi))
                for s in smaller:
                    c = _clone(raw)
                    new_atoms = list(atoms)
                    new_atoms[i] = str(s)
                    _set_atoms(c, side, idx, new_atoms)
                    cands.append(c)
    for i, item in enumerate(raw["timeline"]):
        kind, val = item["at"].split(":")
        if int(val) > 0:
            c = _clone(raw)
            c["timeline"][i]["at"] = f"{kind}:{int(val) // 2}"
            cands.append(c)
    for key in ("adopt_deadline_s", "deadline_s"):
        if raw[key] > 16:
            c = _clone(raw)
            c[key] = raw[key] / 2
            cands.append(c)

    # 4. shrink topology (re-homing dropped indices' faults onto 0)
    def with_hosts(n: int) -> dict:
        c = _clone(raw)
        c["trainer"]["hosts"] = n
        c["trainer"]["min_processes"] = min(
            c["trainer"]["min_processes"], n)
        merged: List[str] = []
        keep: Dict[str, str] = {}
        for idx in sorted(c["trainer"]["fault_specs"], key=int):
            if int(idx) >= n:
                merged.extend(_atoms(c, "trainer", idx))
            else:
                keep[idx] = c["trainer"]["fault_specs"][idx]
        if merged:
            keep["0"] = ",".join([keep.get("0", "")] + merged).strip(",")
        c["trainer"]["fault_specs"] = keep
        return c

    def with_replicas(n: int) -> dict:
        c = _clone(raw)
        c["serve"]["replicas"] = n
        keep = {}
        merged = []
        for idx in sorted(c["serve"]["fault_specs"], key=int):
            if int(idx) >= n:
                merged.extend(_atoms(c, "serve", idx))
            else:
                keep[idx] = c["serve"]["fault_specs"][idx]
        if merged:
            keep["0"] = ",".join([keep.get("0", "")] + merged).strip(",")
        c["serve"]["fault_specs"] = keep
        if c["serve"]["max_replicas"]:
            c["serve"]["max_replicas"] = max(c["serve"]["max_replicas"] - (
                raw["serve"]["replicas"] - n), n + 1)
        for item in c["timeline"]:
            if item.get("replica", 0) >= n:
                item["replica"] = 0
        return c

    if raw["trainer"]["hosts"] > 1:
        cands.append(with_hosts(1))
        cands.append(with_hosts(raw["trainer"]["hosts"] - 1))
    if raw["serve"]["replicas"] > 1:
        cands.append(with_replicas(1))
        cands.append(with_replicas(raw["serve"]["replicas"] - 1))
    if raw["trainer"]["epochs"] > 1:
        c = _clone(raw)
        c["trainer"]["epochs"] = raw["trainer"]["epochs"] - 1
        cands.append(c)
    if raw["trainer"]["synthetic_size"] > raw["trainer"]["batchsize"]:
        c = _clone(raw)
        c["trainer"]["synthetic_size"] = raw["trainer"]["synthetic_size"] // 2
        cands.append(c)
    if raw["serve"]["max_replicas"] and not any(
            i["action"] == "spike_load" for i in raw["timeline"]):
        c = _clone(raw)
        c["serve"]["max_replicas"] = 0
        cands.append(c)
    return cands


def shrink_spec(spec: ScenarioSpec,
                fails: Callable[[ScenarioSpec], bool],
                max_runs: int = 200) -> Tuple[ScenarioSpec, int]:
    """Greedy delta-minimization to a fixpoint: apply the first cut that
    still fails, restart the pass list, stop when no cut helps (or the
    run cap trips). Deterministic: cut order is a pure function of the
    current raw dict. Returns (minimized spec, failure-predicate runs)."""
    raw = spec_to_raw(spec)
    runs = 0
    progress = True
    while progress and runs < max_runs:
        progress = False
        for cand in _shrink_candidates(raw):
            if runs >= max_runs:
                break
            try:
                s = parse_spec(_clone(cand))
            except SpecError:
                continue  # an invalid cut is simply not taken
            runs += 1
            if fails(s):
                raw = spec_to_raw(s)
                progress = True
                break
    return parse_spec(_clone(raw)), runs


# ----------------------------------------------------------------- fuzzer --

@dataclass
class FuzzResult:
    found: bool
    specs_run: int
    shrink_runs: int = 0
    seed_spec: Optional[ScenarioSpec] = None   # the original failing draw
    minimized: Optional[ScenarioSpec] = None
    violations: List[Violation] = field(default_factory=list)


class Fuzzer:
    """sample → record coverage → run → (on red) shrink. The runner is
    any ``spec -> List[Violation]`` callable: `sim_runner` (fast,
    checker-vs-model), a `DrillRunner` (real processes), or a planted
    test fixture. Shrinking preserves the ORIGINAL failure's invariant
    labels so a cut cannot slide the case onto a different bug."""

    def __init__(self, runner: Callable[[ScenarioSpec], List[Violation]],
                 seed: int = 0, candidates: int = 4,
                 ledger: Optional[CoverageLedger] = None,
                 max_shrink_runs: int = 200,
                 log: Callable[[str], None] = lambda s: None):
        self.runner = runner
        self.sampler = SpecSampler(seed=seed, candidates=candidates)
        self.ledger = ledger if ledger is not None else CoverageLedger()
        self.max_shrink_runs = max_shrink_runs
        self.log = log

    def run(self, budget: int) -> FuzzResult:
        for i in range(budget):
            spec = self.sampler.sample(self.ledger)
            keys = coverage_keys(spec)
            self.ledger.record(keys)
            violations = self.runner(spec)
            self.log(f"spec {i + 1}/{budget}: {len(keys)} pair(s), "
                     f"{self.ledger.distinct()} distinct total, "
                     f"{len(violations)} violation(s)")
            if not violations:
                continue
            labels = {v.invariant for v in violations}

            def same_failure(s: ScenarioSpec) -> bool:
                return bool(labels & {v.invariant for v in self.runner(s)})

            minimized, shrink_runs = shrink_spec(
                spec, same_failure, self.max_shrink_runs)
            return FuzzResult(found=True, specs_run=i + 1,
                              shrink_runs=shrink_runs, seed_spec=spec,
                              minimized=minimized,
                              violations=self.runner(minimized))
        return FuzzResult(found=False, specs_run=budget)
