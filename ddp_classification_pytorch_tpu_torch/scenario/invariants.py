"""S1–S5 invariant checkers over a parsed scenario event timeline — the
port's copy of the JAX package's `scenario/invariants.py`: the same
contracts, and the same violation messages word for word, so one
events.jsonl gets one verdict from either package.

The contracts:

- **S1 verified-serve** — no request was ever answered by params whose
  digest was not sha256-verified: every ``request`` event with
  ``status=ok`` must carry the digest of a checkpoint the SAME replica
  logged ``verify_ok`` for, no later than the answer (small slack for
  the adopt-at-batch-start window). The sentinel digest ``"fresh"``
  (warmup/template params, never restored from disk) is exempt — there
  is no checkpoint to verify.
- **S2 availability floor** — in every sliding ``window_s`` window over
  the request stream, alive responses (ok + 503-busy + 503-draining:
  backpressure is degraded-but-alive) ÷ all attempts ≥ ``floor``.
  Connection-refused and timeouts count against the floor — a dead
  socket is not backpressure. Windows with fewer than ``min_samples``
  attempts are skipped (one unlucky probe is not an outage).
- **S3 bounded adoption** — every *good* publish (its write neither
  torn nor quarantined; condemnation is per write, so a clean
  re-publish of a once-torn path is a fresh candidate) must be
  followed, on every replica, by a
  ``swap`` of that epoch or newer within ``adopt_deadline_s``; a replica
  that restarts (new ``serve_ready``) gets its deadline re-based so a
  deliberate drain/relaunch in the timeline is not an instant red.
  The companion `check_restarts_log` proves the trainer side from logs
  alone: every `cli/supervise.py` restart line must still carry the
  ``gen=``/``world=`` fields elastic re-formation stamps (an rc 11
  re-form with those fields missing would blind this check).
- **S4 analyzer gate** — the run must end with a ``lint`` event of
  rc 0: the port's gate is the rc-catalogue pass (`analysis/lint.py` over
  `cli/`), still green after the whole drill (no rc-discipline
  regression: supervisors sort restart from stop by rc). The message
  keeps the JAX package's wording ("lint.sh") so verdicts compare.
- **S5 fleet** — the serve-fleet control plane held shape under load:
  (a) *rolling wave exclusivity*: replaying the
  ``drain_token_acquire``/``release``/``takeover`` stream, at most one
  replica holds the drain token — i.e. is draining — at any instant (a
  ``takeover`` force-closes the wedged holder's interval, exactly the
  last-writer-wins semantics of the token file); (b) *digest
  convergence*: every surviving (non-retired) replica's final ``swap``
  lands on ONE digest, and it is the digest of the newest good publish;
  (c) *scale-out deadline*: when the spec arms the autoscaler
  (``max_replicas > replicas``), every ``spike_load`` must be answered
  by a ``scale_out`` within ``scale_out_deadline_s`` — unless the fleet
  already sits at ``max_replicas`` when the spike lands (there is
  nothing left to scale into). A timeline with
  no fleet events passes vacuously (pre-fleet runs stay checkable).
  S3 composes with retirement: a ``replica_retire``\\ d replica is
  excused from publishes whose adoption deadline falls after it left
  (it will never swap again — that is the point of scale-in).

Checkers only READ the timeline; they never mutate it. Each returns the
violations it found, so `cli/scenario.py --check_only` can replay a saved
events.jsonl from a red run and print every broken contract at once.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .spec import ScenarioSpec

# adopt-at-batch-start: a request may be *answered* a moment before its
# batch's verify_ok line hits the shared file (two processes, one file)
_S1_SLACK_S = 0.5

# cli/supervise.py restart-log line; gen=/world= are the elastic-membership
# fields S3 needs to follow a re-form from logs alone (host= is the
# hostname falling back to FLEET_HOST_ID — not necessarily numeric)
_RESTART_LINE_RE = re.compile(
    r"host=\S+ proc=\d+ rc=-?\d+ .*gen=(\S+) world=(\S+) "
    r"action=(restart|stop|give-up|exit)")


@dataclass
class Violation:
    invariant: str  # "S1" | "S2" | "S3" | "S4" | "S5"
    message: str

    def __str__(self) -> str:
        return f"[{self.invariant}] {self.message}"


def _requests(events: Sequence[Dict]) -> List[Dict]:
    return [e for e in events if e.get("kind") == "request"]


def check_s1_verified_serve(events: Sequence[Dict]) -> List[Violation]:
    out: List[Violation] = []
    # replica source -> digest -> earliest verify_ok ts
    verified: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.get("kind") == "verify_ok":
            src = str(e.get("source", ""))
            d = verified.setdefault(src, {})
            digest = str(e.get("digest", ""))
            if digest and digest not in d:
                d[digest] = float(e.get("ts", 0.0))
    for e in _requests(events):
        if e.get("status") != "ok":
            continue
        digest = e.get("digest")
        replica = str(e.get("replica", ""))
        if digest is None:
            out.append(Violation(
                "S1", f"ok request at ts={e.get('ts')} answered by "
                      f"{replica or '<unknown>'} carries no params digest"))
            continue
        if digest == "fresh":
            continue
        seen = verified.get(replica, {}).get(str(digest))
        if seen is None:
            out.append(Violation(
                "S1", f"{replica or '<unknown>'} answered with digest "
                      f"{str(digest)[:12]}… never verified by that replica "
                      f"(ts={e.get('ts')})"))
        elif seen > float(e.get("ts", 0.0)) + _S1_SLACK_S:
            out.append(Violation(
                "S1", f"{replica} answered with digest {str(digest)[:12]}… "
                      f"at ts={e.get('ts')} before verifying it at ts={seen}"))
    return out


def check_s2_availability(events: Sequence[Dict],
                          spec: ScenarioSpec) -> List[Violation]:
    reqs = _requests(events)
    if not reqs:
        return [Violation("S2", "no request events at all — the load "
                                "generator never ran, availability unproven")]
    floor = spec.availability.floor
    window = spec.availability.window_s
    min_samples = spec.availability.min_samples
    alive_states = ("ok", "busy", "draining")
    samples = [(float(r.get("ts", 0.0)), r.get("status") in alive_states)
               for r in reqs]
    t0, t_end = samples[0][0], samples[-1][0]
    out: List[Violation] = []
    start = t0
    while start <= t_end:
        in_win = [alive for ts, alive in samples if start <= ts < start + window]
        if len(in_win) >= min_samples:
            ratio = sum(in_win) / len(in_win)
            if ratio < floor:
                out.append(Violation(
                    "S2", f"availability {ratio:.2f} < floor {floor} in "
                          f"window [{start:.1f}, {start + window:.1f}) "
                          f"({sum(in_win)}/{len(in_win)} alive)"))
                # one violation per outage is enough to go red; skip past
                # this window so a single incident doesn't print 10 rows
                start += window
                continue
        start += 1.0
    return out


def good_publishes(events: Sequence[Dict]) -> List[Dict]:
    """publish events whose candidate was neither torn at write time nor
    later quarantined by any verifier.

    Condemnation is per-WRITE, not per-path-forever: a ``publish_torn``
    or ``quarantine`` marks only the most recent preceding ``publish``
    of that path bad, so a clean RE-publish of the same path (a
    restarted trainer resuming past a quarantined epoch re-writes it)
    is a fresh candidate the fleet must adopt. The old path-forever set
    silently excused every later write of a once-torn path from the S3
    adoption and S5(b) convergence contracts — found while building the
    scenario fuzzer's simulator (torn-then-republish shape)."""
    latest: Dict[str, int] = {}  # path -> index of its most recent publish
    bad: set = set()             # indices of condemned publish events
    pubs: List = []              # (index, event), in timeline order
    for i, e in enumerate(events):
        kind = e.get("kind")
        if kind == "publish":
            latest[str(e.get("path"))] = i
            pubs.append((i, e))
        elif kind in ("publish_torn", "quarantine"):
            j = latest.get(str(e.get("path")))
            if j is not None:
                bad.add(j)
    return [e for i, e in pubs if i not in bad]


def replica_retire_times(events: Sequence[Dict]) -> Dict[str, float]:
    """replica source -> ts of its LAST replica_retire (scale-in). The
    supervisor emits these, so the replica name is in the `replica`
    field, not `source`."""
    out: Dict[str, float] = {}
    for e in events:
        if e.get("kind") == "replica_retire":
            out[str(e.get("replica", ""))] = float(e.get("ts", 0.0))
    return out


def check_s3_adoption(events: Sequence[Dict],
                      spec: ScenarioSpec) -> List[Violation]:
    out: List[Violation] = []
    goods = good_publishes(events)
    # replicas are whoever ever came up serving
    ready: Dict[str, List[float]] = {}
    for e in events:
        if e.get("kind") == "serve_ready":
            ready.setdefault(str(e.get("source", "")), []).append(
                float(e.get("ts", 0.0)))
    if not ready:
        return [Violation("S3", "no serve_ready events — no replica ever "
                                "came up, adoption unproven")]
    retired = replica_retire_times(events)
    swaps: Dict[str, List[Dict]] = {}
    for e in events:
        if e.get("kind") == "swap":
            swaps.setdefault(str(e.get("source", "")), []).append(e)
    for pub in goods:
        epoch = int(pub.get("epoch", -1))
        t_pub = float(pub.get("ts", 0.0))
        for replica, ready_times in ready.items():
            # a restart after the publish re-bases the clock: the fresh
            # process cannot adopt earlier than its own warmup
            base = max([t_pub] + [t for t in ready_times if t >= t_pub])
            deadline = base + spec.adopt_deadline_s
            retire_ts = retired.get(replica)
            if retire_ts is not None and retire_ts <= deadline \
                    and not any(t > retire_ts for t in ready_times):
                # scale-in excusal: the replica left the fleet before its
                # adoption deadline and never came back — it will never
                # swap again, and that is the point of retirement
                continue
            adopted = [s for s in swaps.get(replica, [])
                       if int(s.get("epoch", -1)) >= epoch
                       and float(s.get("ts", 0.0)) <= deadline]
            if not adopted:
                late = [s for s in swaps.get(replica, [])
                        if int(s.get("epoch", -1)) >= epoch]
                if late:
                    out.append(Violation(
                        "S3", f"{replica} adopted epoch {epoch} only at "
                              f"ts={late[0].get('ts')} — past deadline "
                              f"{deadline:.1f} (published ts={t_pub:.1f})"))
                else:
                    out.append(Violation(
                        "S3", f"{replica} never adopted good publish epoch "
                              f"{epoch} (published ts={t_pub:.1f}, digest "
                              f"{str(pub.get('digest', ''))[:12]}…)"))
    if not goods:
        out.append(Violation("S3", "no good publish events — trainer never "
                                   "published a clean checkpoint"))
    return out


def check_restarts_log(path: str) -> List[Violation]:
    """S3's from-logs-alone leg: every supervisor bookkeeping line must
    still carry gen=/world= so a re-form is traceable without events."""
    out: List[Violation] = []
    try:
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
    except OSError as e:
        return [Violation("S3", f"cannot read restarts.log {path}: {e}")]
    for i, ln in enumerate(lines, 1):
        if not _RESTART_LINE_RE.search(ln):
            out.append(Violation(
                "S3", f"{path}:{i} missing gen=/world=/action= fields "
                      f"(elastic bookkeeping regressed): {ln!r}"))
    return out


def check_s5_fleet(events: Sequence[Dict],
                   spec: ScenarioSpec) -> List[Violation]:
    """Fleet control-plane contract: wave exclusivity, survivor digest
    convergence, spike→scale-out deadline (see module docstring). A
    timeline without fleet events passes vacuously."""
    out: List[Violation] = []

    # (a) rolling wave exclusivity — replay the token stream
    holder: Optional[str] = None
    for e in events:
        kind = e.get("kind")
        src = str(e.get("source", ""))
        if kind == "drain_token_takeover":
            # the new holder proved the old one stale (lease TTL) and
            # atomically replaced the token: the wedged interval is over
            holder = None
        elif kind == "drain_token_acquire":
            if holder is not None and holder != src:
                out.append(Violation(
                    "S5", f"two replicas draining at once: {src} acquired "
                          f"the drain token at ts={e.get('ts')} while "
                          f"{holder} still held it"))
            holder = src
        elif kind == "drain_token_release" and src == holder:
            holder = None

    # (b) survivor digest convergence — every non-retired replica's last
    # swap must land on ONE digest: the newest good publish's
    swaps: Dict[str, Dict] = {}
    for e in events:
        if e.get("kind") == "swap":
            swaps[str(e.get("source", ""))] = e
    retired = set(replica_retire_times(events))
    finals = {src: str(e.get("digest", "")) for src, e in swaps.items()
              if src not in retired}
    if finals:
        distinct = sorted(set(finals.values()))
        if len(distinct) > 1:
            out.append(Violation(
                "S5", "fleet did not converge: surviving replicas ended on "
                      f"{len(distinct)} digests "
                      f"({ {s: d[:12] for s, d in sorted(finals.items())} })"))
        goods = good_publishes(events)
        if goods and len(distinct) == 1:
            newest = max(goods, key=lambda e: int(e.get("epoch", -1)))
            want = str(newest.get("digest", ""))
            if want and distinct[0] != want:
                out.append(Violation(
                    "S5", f"fleet converged on digest {distinct[0][:12]}… "
                          f"but the newest good publish (epoch "
                          f"{newest.get('epoch')}) is {want[:12]}…"))

    # (c) spike → scale-out deadline, only when the spec arms the scaler
    if spec.serve.max_replicas > spec.serve.replicas:
        scale_ts = [float(e.get("ts", 0.0)) for e in events
                    if e.get("kind") == "scale_out"]
        scale_in_ts = [float(e.get("ts", 0.0)) for e in events
                       if e.get("kind") == "scale_in"]
        for e in events:
            if e.get("kind") != "spike_load":
                continue
            t_spike = float(e.get("ts", 0.0))
            # a spike landing when the fleet already sits at max_replicas
            # has nothing left to scale into — demanding a scale_out here
            # was a false red (fuzzer-found; regression:
            # tests/data/scenarios/spike-at-max-fleet)
            fleet_now = (spec.serve.replicas
                         + sum(1 for t in scale_ts if t <= t_spike)
                         - sum(1 for t in scale_in_ts if t <= t_spike))
            if fleet_now >= spec.serve.max_replicas:
                continue
            limit = t_spike + spec.serve.scale_out_deadline_s
            if not any(t_spike <= t <= limit for t in scale_ts):
                out.append(Violation(
                    "S5", f"spike_load at ts={t_spike:.1f} "
                          f"(rps={e.get('rps')}) was never answered by a "
                          f"scale_out within {spec.serve.scale_out_deadline_s}s"))
    return out


def check_s4_analyzer(events: Sequence[Dict]) -> List[Violation]:
    lints = [e for e in events if e.get("kind") == "lint"]
    if not lints:
        return [Violation("S4", "no lint event — the run did not end with "
                                "the analyzer gate")]
    rc = lints[-1].get("rc")
    if rc != 0:
        return [Violation("S4", f"analyzer gate red: lint.sh rc={rc}")]
    return []


def check_invariants(events: Sequence[Dict], spec: ScenarioSpec,
                     restarts_logs: Optional[Sequence[str]] = None,
                     require_lint: bool = True) -> List[Violation]:
    """Replay a full timeline; returns every violation (empty == green)."""
    out: List[Violation] = []
    out.extend(check_s1_verified_serve(events))
    out.extend(check_s2_availability(events, spec))
    out.extend(check_s3_adoption(events, spec))
    for path in restarts_logs or ():
        out.extend(check_restarts_log(path))
    if require_lint:
        out.extend(check_s4_analyzer(events))
    out.extend(check_s5_fleet(events, spec))
    return out
