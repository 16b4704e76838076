"""Serve-fleet control plane: replica registry, rolling reload waves,
admission control, and SLO-driven autoscaling — the port's copy of the
JAX package's `serve/fleet.py`, stdlib only, file format for file format
(a lease or token written by either package reads the same in the other).

- **Registry** — every replica rewrites `$OUT/serve_fleet/lease.r<id>`
  each watcher poll tick (atomic tmp + `os.replace`: the write IS the
  heartbeat; mtime vs TTL is freshness). The payload carries the replica
  id, wave state (`joining|serving|draining`), the digest + generation it
  is serving. `scan_replica_leases` derives the live membership; the
  lowest live id is the leader (pure arithmetic — no election traffic).
  A wedged watcher thread therefore shows up as a stale lease, not a
  silently frozen replica.
- **Rolling wave** — hot reload is serialized by a single drain token
  (`$OUT/serve_fleet/wave.token`, exclusive-create). Only the holder may
  enter `draining`, so at most one replica is out of rotation at any
  instant; the engine swap itself happens at a batch boundary, so zero
  in-flight requests are dropped. A holder that dies mid-wave leaves a
  token whose mtime goes stale past the lease TTL — the next replica
  takes it over by atomic replace (last-writer-wins, confirmed by
  read-back), so a kill mid-wave hands the wave on instead of wedging it.
- **Admission** — `AdmissionController` sits above the engine queue:
  per-tenant weighted fair shares, deadline-based shedding driven by the
  *measured* queue wait (depth / observed service rate), not the fixed
  queue bound. The shed tenant and measured depth ride the 503 body and
  an `admission_shed` event.
- **Autoscaler** — pure decision logic over the `obs/` gauges (queue
  depth, batch fill ratio, p99). Whoever owns the replica processes
  applies the decisions.

Everything here is plain files + host math: deterministic to test
in-process (several `FleetMember`s over one tmp dir, `os.utime` to age
leases) and safe on any shared filesystem a run dir already lives on.
All fleet instruments are registered at construction, so 0-valued
families expose on `/metrics` before the first heartbeat.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from ..obs.events import emit

__all__ = [
    "ReplicaLease", "FleetMember", "AdmissionController", "AdmissionShed",
    "Autoscaler", "serve_fleet_dir", "replica_lease_path",
    "wave_token_path", "scan_replica_leases", "parse_tenants",
    "WAVE_STATES",
]

WAVE_STATES = ("joining", "serving", "draining")


# ------------------------------------------------------------ registry --
def serve_fleet_dir(run_dir: str) -> str:
    """`$OUT/serve_fleet`: the serve fleet's namespace inside a run dir
    (the JAX trainer pod's is `$OUT/fleet`; disjoint files, so a trainer
    and a serve fleet can share one run dir)."""
    return os.path.join(run_dir, "serve_fleet")


def replica_lease_path(run_dir: str, replica_id: int) -> str:
    return os.path.join(serve_fleet_dir(run_dir), f"lease.r{int(replica_id)}")


def wave_token_path(run_dir: str) -> str:
    return os.path.join(serve_fleet_dir(run_dir), "wave.token")


@dataclass
class ReplicaLease:
    """Parsed view of one fresh replica lease."""

    replica: int
    state: str = "joining"
    digest: str = ""
    generation: int = -1
    age_s: float = 0.0


def _atomic_write(path: str, body: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(body)
    os.replace(tmp, path)


def scan_replica_leases(run_dir: str, *, ttl_s: float,
                        now: Optional[float] = None
                        ) -> Dict[int, ReplicaLease]:
    """Fresh serve leases: {replica_id: ReplicaLease}. A lease older
    than `ttl_s` is a dead
    replica; torn or vanishing files are skipped, and a listdir failure
    returns {} (a scan must never take down a serving replica)."""
    d = serve_fleet_dir(run_dir)
    now = time.time() if now is None else now
    fresh: Dict[int, ReplicaLease] = {}
    try:
        names = os.listdir(d)
    except OSError:
        return fresh
    for name in names:
        suffix = name[len("lease.r"):]
        if not name.startswith("lease.r") or not suffix.isdigit():
            continue
        path = os.path.join(d, name)
        try:
            age = now - os.stat(path).st_mtime
            if age > ttl_s:
                continue
            lease = ReplicaLease(replica=int(suffix), age_s=max(age, 0.0))
            with open(path) as f:
                for tok in f.read().split():
                    if tok.startswith("state="):
                        lease.state = tok[len("state="):] or "joining"
                    elif tok.startswith("digest="):
                        lease.digest = tok[len("digest="):]
                    elif tok.startswith("gen="):
                        try:
                            lease.generation = int(tok[len("gen="):])
                        except ValueError:
                            pass
            fresh[int(suffix)] = lease
        except OSError:
            continue
    return fresh


class FleetMember:
    """One replica's handle on the shared serve-fleet namespace.

    Construction registers every fleet instrument into `registry` (or a
    caller-shared `ServeMetrics.registry`) so the 0-valued families
    expose before the first heartbeat. `heartbeat()` is designed to ride
    the watcher poll tick — the lease rewrite is the liveness signal, so
    watcher wedge == stale lease by construction.
    """

    def __init__(self, run_dir: str, replica_id: int, *,
                 ttl_s: float = 15.0, registry=None):
        if not run_dir:
            raise ValueError("fleet run_dir must be non-empty")
        if int(replica_id) < 0:
            raise ValueError(f"fleet replica_id must be >= 0, got {replica_id}")
        if float(ttl_s) <= 0:
            raise ValueError(f"fleet ttl_s must be > 0, got {ttl_s}")
        self.run_dir = run_dir
        self.replica_id = int(replica_id)
        self.ttl_s = float(ttl_s)
        self.state = "joining"
        self.digest = ""
        self.generation = -1
        if registry is None:
            from ..obs.registry import Registry

            registry = Registry()
        self.registry = registry
        self._alive_gauge = registry.gauge(
            "fleet_replicas_alive", "fresh serve leases at last scan")
        self._draining_gauge = registry.gauge(
            "fleet_wave_draining", "1 while this replica holds the drain token")
        self._converged_gauge = registry.gauge(
            "fleet_digest_converged",
            "1 when every live replica serves one non-empty digest")
        self._generation_gauge = registry.gauge(
            "fleet_lease_generation", "checkpoint generation on our lease")
        self._heartbeats_total = registry.counter(
            "fleet_heartbeats_total", "lease rewrites (each IS the heartbeat)")
        self._wave_swaps_total = registry.counter(
            "fleet_wave_swaps_total", "token-gated reload waves completed here")
        self._takeovers_total = registry.counter(
            "fleet_token_takeovers_total",
            "stale drain tokens taken over after holder death")
        os.makedirs(serve_fleet_dir(run_dir), exist_ok=True)

    # --------------------------------------------------------- heartbeat --
    def heartbeat(self, *, digest: Optional[str] = None,
                  generation: Optional[int] = None,
                  now: Optional[float] = None) -> Dict[int, ReplicaLease]:
        """Atomically rewrite our lease (the write IS the heartbeat) and
        return the fresh membership scan. Also refreshes the wave token
        mtime while we hold it, so a live drain never looks stale."""
        if digest is not None:
            self.digest = digest
        if generation is not None:
            self.generation = int(generation)
        if self.state == "joining" and self.digest:
            self.state = "serving"
        _atomic_write(
            replica_lease_path(self.run_dir, self.replica_id),
            f"replica={self.replica_id} state={self.state} "
            f"digest={self.digest} gen={self.generation}\n")
        self._heartbeats_total.inc()
        if self.state == "draining":
            try:
                os.utime(wave_token_path(self.run_dir))
            except OSError:
                pass
        peers = self.peers(now=now)
        self._alive_gauge.set(len(peers))
        self._generation_gauge.set(self.generation)
        self._converged_gauge.set(1.0 if _converged(peers) else 0.0)
        return peers

    def peers(self, *, now: Optional[float] = None) -> Dict[int, ReplicaLease]:
        return scan_replica_leases(self.run_dir, ttl_s=self.ttl_s, now=now)

    def role(self, *, now: Optional[float] = None) -> str:
        """'leader' when we are the lowest live id, else 'follower' —
        pure arithmetic over the lease scan, no election traffic."""
        peers = self.peers(now=now)
        live = sorted(peers) or [self.replica_id]
        return "leader" if self.replica_id <= live[0] else "follower"

    def fleet_converged(self, *, now: Optional[float] = None) -> bool:
        return _converged(self.peers(now=now))

    # ------------------------------------------------------ rolling wave --
    @property
    def holds_token(self) -> bool:
        return self.state == "draining"

    def try_begin_drain(self, digest: str,
                        now: Optional[float] = None) -> bool:
        """Try to acquire the fleet's single drain token for a reload to
        `digest`. Success flips us to `draining` (healthz reflects it,
        admission keeps running — the engine swap is what stays
        serialized). Exclusive-create wins the common case; a token whose
        mtime is past the lease TTL is a dead holder's — take it over by
        atomic replace and confirm by read-back (two racing takeovers
        resolve to whichever write landed last)."""
        if self.state == "draining":
            return True
        path = wave_token_path(self.run_dir)
        os.makedirs(serve_fleet_dir(self.run_dir), exist_ok=True)
        body = f"holder={self.replica_id} digest={digest}\n"
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            with os.fdopen(fd, "w") as f:
                f.write(body)
        except FileExistsError:
            t = time.time() if now is None else now
            try:
                stale = t - os.stat(path).st_mtime > self.ttl_s
            except OSError:
                return False  # vanished mid-look: holder released; next tick
            if not stale:
                return False
            _atomic_write(path, body)
            holder = _token_holder(path)
            if holder != self.replica_id:
                return False  # raced another takeover and lost
            self._takeovers_total.inc()
            emit("drain_token_takeover", replica=self.replica_id,
                 digest=digest)
        except OSError:
            return False
        self.state = "draining"
        self._draining_gauge.set(1.0)
        self.heartbeat(now=now)
        emit("drain_token_acquire", replica=self.replica_id, digest=digest)
        return True

    def end_drain(self, *, digest: Optional[str] = None,
                  generation: Optional[int] = None,
                  now: Optional[float] = None) -> None:
        """Finish our wave slot: record the adopted digest/generation,
        return to `serving`, release the token (only if still ours — a
        TTL takeover may have claimed it while we were wedged)."""
        path = wave_token_path(self.run_dir)
        self.state = "serving"
        self._draining_gauge.set(0.0)
        self._wave_swaps_total.inc()
        self.heartbeat(digest=digest, generation=generation, now=now)
        # The release event must land in events.jsonl BEFORE the unlink:
        # the next replica can win O_CREAT|O_EXCL the instant the token
        # vanishes, and its acquire event racing ahead of our release
        # would read as two replicas draining at once. A crash in the gap leaves a
        # stale token — reclaimed by TTL takeover, which re-clears the
        # holder in the event stream.
        emit("drain_token_release", replica=self.replica_id,
             digest=self.digest, generation=self.generation)
        if _token_holder(path) == self.replica_id:
            try:
                os.remove(path)
            except OSError:
                pass

    def leave(self) -> None:
        """Graceful exit: drop our lease so peers stop counting us
        immediately instead of waiting out the TTL."""
        if self.state == "draining":
            self.end_drain()
        try:
            os.remove(replica_lease_path(self.run_dir, self.replica_id))
        except OSError:
            pass


def _converged(peers: Dict[int, ReplicaLease]) -> bool:
    digests = {p.digest for p in peers.values()}
    return len(digests) == 1 and "" not in digests


def _token_holder(path: str) -> int:
    try:
        with open(path) as f:
            for tok in f.read().split():
                if tok.startswith("holder="):
                    return int(tok[len("holder="):])
    except (OSError, ValueError):
        pass
    return -1


# ----------------------------------------------------------- admission --
class AdmissionShed(RuntimeError):
    """A request was shed by admission policy (not by the fixed queue
    bound). Carries the forensics the 503 body and events.jsonl need."""

    def __init__(self, tenant: str, queue_depth: int, est_wait_ms: float):
        super().__init__(
            f"admission shed tenant={tenant} queue_depth={queue_depth} "
            f"est_wait_ms={est_wait_ms:.1f}")
        self.tenant = tenant
        self.queue_depth = int(queue_depth)
        self.est_wait_ms = float(est_wait_ms)


def parse_tenants(spec: str) -> Dict[str, float]:
    """'name:weight,name:weight' -> {name: weight}. '' -> {'default': 1}.
    Raises ValueError (the cli.serve rc-2 family) on malformed specs."""
    if not spec.strip():
        return {"default": 1.0}
    out: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"admission tenant spec {spec!r}: empty name")
        try:
            weight = float(w) if sep else 1.0
        except ValueError:
            raise ValueError(
                f"admission tenant spec {spec!r}: weight {w!r} not a number")
        if weight <= 0:
            raise ValueError(
                f"admission tenant spec {spec!r}: weight must be > 0")
        if name in out:
            raise ValueError(f"admission tenant spec {spec!r}: "
                             f"duplicate tenant {name!r}")
        out[name] = weight
    if not out:
        raise ValueError(f"admission tenant spec {spec!r}: no tenants")
    return out


class AdmissionController:
    """Deadline-based load shedding above the engine queue.

    The engine's `queue_depth` bound is a memory guard, not a latency
    policy: a queue can be far under its bound and still represent more
    wait than any caller will tolerate. Admission computes the *measured*
    expected wait — current depth divided by the observed service rate
    (EWMA of completions between submits) — and sheds when it exceeds the
    deadline:

    - a tenant **over** its weighted fair share of in-flight admissions
      is shed as soon as the wait exceeds `deadline_ms` (fairness shed);
    - **any** tenant is shed once the wait exceeds 2x the deadline (hard
      shed) — with a single tenant the fair share is the whole queue, so
      only the hard threshold applies.

    `QueueFull` from the engine (the memory guard tripping first) is
    folded into the same `AdmissionShed` surface so callers have one 503
    path with one forensic shape.
    """

    HARD_FACTOR = 2.0

    def __init__(self, engine, *, tenants: str = "", deadline_ms: float = 250.0,
                 registry=None, rate_fn: Optional[Callable[[], float]] = None):
        if float(deadline_ms) <= 0:
            raise ValueError(
                f"admission deadline_ms must be > 0, got {deadline_ms}")
        self.engine = engine
        self.deadline_ms = float(deadline_ms)
        self.tenants = parse_tenants(tenants)
        self._rate_fn = rate_fn
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {t: 0 for t in self.tenants}
        self._rate_rps = 0.0  # EWMA of measured completions/sec
        self._last_completed = 0.0
        self._last_t = time.monotonic()
        if registry is None:
            registry = getattr(getattr(engine, "metrics", None), "registry",
                               None)
        if registry is None:
            from ..obs.registry import Registry

            registry = Registry()
        self.registry = registry
        self._est_wait_gauge = registry.gauge(
            "admission_est_wait_ms",
            "measured queue wait estimate at last admission decision")
        self._admitted_total: Dict[str, object] = {}
        self._shed_total: Dict[str, object] = {}
        for t in self.tenants:  # 0-valued per-tenant families expose now
            self._admitted_total[t] = registry.counter(
                "admission_admitted_total", "requests admitted past policy",
                labels={"tenant": t})
            self._shed_total[t] = registry.counter(
                "admission_shed_total", "requests shed by admission policy",
                labels={"tenant": t})

    # ------------------------------------------------------------- rate --
    def _service_rate(self) -> float:
        """Completions/sec EWMA, fed by the engine metrics counter at
        each admission decision. Floor of one batch per deadline so a
        cold start (no completions yet) cannot divide by ~zero and shed
        everything before the first batch lands."""
        if self._rate_fn is not None:
            return max(float(self._rate_fn()), 1e-6)
        m = getattr(self.engine, "metrics", None)
        completed = float(getattr(m, "completed", 0) or 0)
        t = time.monotonic()
        dt = t - self._last_t
        if dt >= 0.05:
            inst = (completed - self._last_completed) / dt
            self._rate_rps = (0.7 * self._rate_rps + 0.3 * inst
                              if self._rate_rps else inst)
            self._last_completed, self._last_t = completed, t
        floor = 1000.0 / self.deadline_ms  # >= one request per deadline
        return max(self._rate_rps, floor)

    def est_wait_ms(self) -> float:
        depth = int(getattr(self.engine, "queue_depth", 0))
        return 1000.0 * depth / self._service_rate()

    # ----------------------------------------------------------- submit --
    def submit(self, image, tenant: str = "default", *, _submit=None):
        """Admit or shed, then delegate to `engine.submit`. Returns the
        engine future on admit; raises AdmissionShed on shed (callers map
        it to 503 + Retry-After). Unknown tenants are tracked ad hoc at
        weight 1 — admission is a policy layer, not an authn layer."""
        depth = int(getattr(self.engine, "queue_depth", 0))
        wait_ms = 1000.0 * depth / self._service_rate()
        self._est_wait_gauge.set(wait_ms)
        with self._lock:
            if tenant not in self._inflight:
                self._inflight[tenant] = 0
            total = sum(self._inflight.values()) + 1
            weight = self.tenants.get(tenant, 1.0)
            share = weight / (sum(self.tenants.values())
                              + (0.0 if tenant in self.tenants else weight))
            ratio = (self._inflight[tenant] + 1) / total
            over_share = ratio > share + 1e-9
        hard = wait_ms > self.HARD_FACTOR * self.deadline_ms
        if hard or (wait_ms > self.deadline_ms and over_share):
            self._shed(tenant, depth, wait_ms)
        submit_fn = self.engine.submit if _submit is None else _submit
        try:
            fut = submit_fn(image)
        except Exception as e:
            if type(e).__name__ == "QueueFull":
                self._shed(tenant, depth, wait_ms)  # one 503 surface
            raise
        with self._lock:
            self._inflight[tenant] += 1
        fut.add_done_callback(lambda _f, t=tenant: self._done(t))
        self._admitted(tenant)
        return fut

    def submit_image(self, img, tenant: str = "default"):
        """Admission-gated counterpart of `engine.submit_image`. The policy
        decision runs here; the decode stays the engine's business (the
        val Transform takes (img, rng) — do not call it directly)."""
        if getattr(self.engine, "transform", None) is None:
            raise RuntimeError("engine has no serve transform configured")
        return self.submit(img, tenant=tenant,
                           _submit=self.engine.submit_image)

    def _done(self, tenant: str) -> None:
        with self._lock:
            self._inflight[tenant] = max(self._inflight.get(tenant, 1) - 1, 0)

    def _admitted(self, tenant: str) -> None:
        c = self._admitted_total.get(tenant)
        if c is None:
            c = self.registry.counter("admission_admitted_total",
                                      "requests admitted past policy",
                                      labels={"tenant": tenant})
            self._admitted_total[tenant] = c
        c.inc()

    def _shed(self, tenant: str, depth: int, wait_ms: float):
        c = self._shed_total.get(tenant)
        if c is None:
            c = self.registry.counter("admission_shed_total",
                                      "requests shed by admission policy",
                                      labels={"tenant": tenant})
            self._shed_total[tenant] = c
        c.inc()
        m = getattr(self.engine, "metrics", None)
        if m is not None:
            m.record_reject()
        emit("admission_shed", tenant=tenant, queue_depth=depth,
             est_wait_ms=round(wait_ms, 1))
        raise AdmissionShed(tenant, depth, wait_ms)


# ---------------------------------------------------------- autoscaler --
@dataclass
class Autoscaler:
    """SLO-driven replica-count policy over the obs/ gauges.

    Pure decision logic — `decide(sample, now)` returns the new desired
    replica count given {queue_depth, fill_ratio, p99_ms}; whoever owns
    the processes (a supervisor; a k8s operator in a real deployment)
    applies it and reports back via `applied()`. Scale-out triggers on
    sustained queue depth or a breached p99 SLO and is deliberately
    aggressive (a new replica is cheap to add);
    scale-in requires an empty queue AND a cold fill ratio, and both
    directions honor a cooldown so one spike cannot flap the fleet.
    """

    min_replicas: int = 1
    max_replicas: int = 1
    p99_slo_ms: float = 0.0        # 0 = ignore latency signal
    queue_high: int = 8            # scale out at/above this depth
    fill_low: float = 0.25         # scale in below this batch fill
    cooldown_s: float = 10.0
    replicas: int = field(default=-1)
    last_action_t: float = field(default=-1.0e18)

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"autoscaler min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"autoscaler max_replicas {self.max_replicas} < "
                f"min_replicas {self.min_replicas}")
        if self.replicas < 0:
            self.replicas = self.min_replicas

    def decide(self, sample: Dict, now: float) -> int:
        """New desired replica count for an aggregate metrics sample."""
        if now - self.last_action_t < self.cooldown_s:
            return self.replicas
        depth = float(sample.get("queue_depth", 0) or 0)
        fill = float(sample.get("fill_ratio", 0.0) or 0.0)
        p99 = float(sample.get("p99_ms", 0.0) or 0.0)
        want = self.replicas
        slo_breached = self.p99_slo_ms > 0 and p99 > self.p99_slo_ms
        if (depth >= self.queue_high or slo_breached) \
                and self.replicas < self.max_replicas:
            want = self.replicas + 1
        elif (depth == 0 and fill < self.fill_low and not slo_breached
              and self.replicas > self.min_replicas):
            want = self.replicas - 1
        return want

    def applied(self, replicas: int, now: float) -> None:
        """Owner confirms the fleet now targets `replicas` — starts the
        cooldown window when the count actually moved."""
        if replicas != self.replicas:
            self.last_action_t = now
        self.replicas = int(replicas)
