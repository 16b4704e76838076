"""The scenario orchestrator behind `cli/scenario.py` (standard library
only) — the port's counterpart of the JAX package's `scenario/supervisor.py`.

One process supervises the whole drill: it launches an elastic trainer pod
(every host under `cli/supervise.py` over `cli/train.py`, in its own
session), N serve replicas (`cli/serve.py --watch` over the shared run
dir, each a member of the serve fleet via `--fleet_dir`), and a
load-generator thread sustaining offered RPS with replica failover; drives
the declarative timeline (drain/kill a replica at a wall-clock offset or
when a given epoch publishes; step the offered load with `spike_load`;
SIGKILL the drain-token holder with `kill_replica_during_wave`);
relaunches a host the chaos plan SIGKILLed once the survivors re-form
around its absence (at once when it has no survivors: a pod of one); and
on completion runs the end-of-run gate, the rc-catalogue lint
(`python -m ddp_classification_pytorch_tpu_torch.analysis.lint`). Every
transition lands in the shared `events.jsonl` — the supervisor's own
record plus what the trainer/serve processes emit through
`obs/events.py::emit` — which the invariant checker then replays.

Every child runs on `device` (default `cuda`; `cpu` only when asked) and
gets `--device` on its command line; its banner (`[trainer] …
device=…`, `[serve] … device=…` in its log) must name that device, or the
run fails. The children's environment carries no JAX variable. The load
generator's `request` events also carry the client's `latency_ms` (an
extra field: the schema lets producers add them).

When `serve.max_replicas > replicas` the supervisor also runs the
autoscaler loop: it aggregates the replicas' /metrics.json gauges (sum of
queue depth, mean batch fill, max p99) into `serve.fleet.Autoscaler`
samples and applies the decisions — launching fresh replicas (`scale_out`)
or retiring the highest-index one (`scale_in` + `replica_retire`, a
graceful SIGTERM drain that is NOT relaunched). The reactive gauges are
supplemented with the demand signal the supervisor owns anyway: a
closed-loop single-flight load generator can never build a server-side
queue (it waits for each answer before sending the next), so the offered
rps relative to the baseline provisioning ratio (load.rps / replicas)
also raises the desired count — which is what makes a `spike_load` step
deterministically produce the `scale_out` S5 audits.

Process-level faults are NOT injected here: each trainer host and serve
replica gets its own ``CHAOS_FAULT_SPEC`` (utils/chaos.py), so the fault
fires inside the process under test and the supervisor only observes the
consequences, the same separation a real outage has.

`run()` returns 0 when every process converged clean (trainer hosts rc 0
through their restarts, replicas drained rc 0, lint green) and 1 otherwise;
the INVARIANT verdict is separate — `cli/scenario.py` replays the events
through `scenario.invariants` afterwards, so a run can fail for an ugly
process exit even when no contract broke, and vice versa.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..obs.events import ENV_EVENTS, ENV_SOURCE, EventLog, read_events
from ..serve.fleet import Autoscaler  # standard library only
from .invariants import good_publishes
from .spec import ScenarioSpec

_PKG = (__package__ or "scenario").split(".")[0]
# the banner each child prints once it holds its device: `[trainer] …
# device=cuda:0 …` (train/loop.py), `[serve] arch=… device=cuda:0`
# (cli/serve.py)
_BANNER_RE = re.compile(r"^\[(trainer|serve)\] .*\bdevice=(\S+)", re.M)


def repo_root() -> str:
    """The checkout holding the package — two levels above this module."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def child_env(env: Dict[str, str]) -> Dict[str, str]:
    """A copy of `env` without JAX's variables (``JAX_*``, ``XLA_*``): the
    port's children import no JAX, and none of its knobs may reach them."""
    return {k: v for k, v in env.items()
            if not k.startswith(("JAX_", "XLA_"))}


def png_bytes(img) -> bytes:
    """(H, W, 3) uint8 RGB → an 8-bit RGB PNG, written with zlib and
    struct (no image library): filter 0 on every row, one IDAT chunk."""
    import struct
    import zlib

    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def payload_pixels(size: int):
    """The load generator's request image: (size, size, 3) uint8 from
    ``default_rng(0)`` — the JAX supervisor's `_make_payload` pixels."""
    import numpy as np

    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (size, size, 3)).astype(np.uint8)


def final_adoption_pending(events: List[Dict], want) -> set:
    """The replicas of `want` the final stop must still wait for: those
    that have not swapped to the newest good publish, and those still
    starting (no `serve_ready` after their last `replica_start`: one
    relaunched late adopts the publish in its start-up restore, before it
    holds its drain handler, so a SIGTERM then would kill it, not drain
    it). Empty when there is no good publish (S3 flags that run)."""
    goods = good_publishes(events)
    if not goods:
        return set()
    last_epoch = max(int(e.get("epoch", -1)) for e in goods)
    adopted = {str(e.get("source", "")) for e in events
               if e.get("kind") == "swap"
               and int(e.get("epoch", -1)) >= last_epoch}
    started: Dict[str, float] = {}
    ready: Dict[str, float] = {}
    for e in events:
        if e.get("kind") == "replica_start":
            started[str(e.get("replica", ""))] = float(e.get("ts", 0.0))
        elif e.get("kind") == "serve_ready":
            ready[str(e.get("source", ""))] = float(e.get("ts", 0.0))
    return {r for r in want if r not in adopted
            or ready.get(r, -1.0) < started.get(r, -1.0)}


def banner_devices(log_text: str) -> List[Tuple[str, str]]:
    """(`trainer` | `serve`, device type) for each banner in a child's
    log, in order (`device=cuda:0` → `cuda`)."""
    return [(m.group(1), m.group(2).split(":")[0])
            for m in _BANNER_RE.finditer(log_text)]


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Replica:
    def __init__(self, index: int, port: int):
        self.index = index
        self.port = port
        self.proc: Optional[subprocess.Popen] = None
        self.log_fh = None
        # "running" | "draining" | "killed" (deliberate stops pending
        # relaunch) | "retired" (autoscaler scale-in: drains, is NOT
        # relaunched, and stops being a load/adoption target) — an exit
        # in state "running" is an unexpected death
        self.state = "running"

    @property
    def source(self) -> str:
        return f"replica{self.index}"


class _Host:
    def __init__(self, index: int):
        self.index = index
        self.proc: Optional[subprocess.Popen] = None
        self.log_fh = None
        # "running" | "lost_waiting" | "done" | "failed"
        self.state = "running"
        self.relaunched = False


class ScenarioSupervisor:
    def __init__(self, spec: ScenarioSpec, out_dir: str,
                 events_path: str = "", skip_lint: bool = False,
                 device: str = "cuda"):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {device!r}")
        self.spec = spec
        self.device = device
        self.out_dir = os.path.abspath(out_dir)
        self.events_path = (os.path.abspath(events_path) if events_path
                            else os.path.join(self.out_dir, "events.jsonl"))
        self.skip_lint = skip_lint
        self.repo = repo_root()
        self.log = EventLog(self.events_path, "supervisor")
        self.failures: List[str] = []
        self.hosts: List[_Host] = []
        self.replicas: List[_Replica] = []
        self.coord_port = 0
        self._load_stop = threading.Event()
        self._load_thread: Optional[threading.Thread] = None
        self._fired_timeline: set = set()
        self._t0 = 0.0
        # offered-load target, stepped by spike_load timeline items; the
        # load thread re-reads it every period (float store is atomic)
        self._rps = float(spec.load.rps)
        self._scaler: Optional[Autoscaler] = None
        self._next_replica_index = spec.serve.replicas
        self._last_scale_sample = -1.0e18

    # ------------------------------------------------------------ launches --
    def _trainer_env(self, host: int) -> Dict[str, str]:
        sp = self.spec.trainer
        env = child_env(os.environ)
        env.update({
            "FLEET_COORDINATOR": f"localhost:{self.coord_port}",
            "FLEET_NUM_PROCESSES": str(sp.hosts),
            "FLEET_PROCESS_ID": str(host),
            "FLEET_HOST_ID": str(host),
            "FLEET_MIN_PROCESSES": str(sp.min_processes),
            # the same short-latency knobs as chaos_drill.sh phase 6: lease
            # expiry and rendezvous in seconds, not production minutes
            "FLEET_LEASE_TTL_S": "25",
            "FLEET_LEASE_SETTLE_S": "2",
            "FLEET_RENDEZVOUS_ATTEMPTS": "8",
            "FLEET_RENDEZVOUS_BACKOFF_S": "2",
            "FLEET_RENDEZVOUS_BACKOFF_CAP_S": "5",
            "FLEET_RENDEZVOUS_TIMEOUT_S": "15",
            "FLEET_RENDEZVOUS_DEADLINE_S": "240",
            "MAX_RESTARTS": "8",
            "RUNTIME_BACKOFF_S": "1",
            "OUTAGE_BACKOFF_S": "2",
            "REFORM_BACKOFF_S": "1",
            "CHAOS_FAULT_SPEC": sp.fault_specs.get(host, ""),
            ENV_EVENTS: self.events_path,
            ENV_SOURCE: f"trainer.h{host}",
        })
        if sp.elastic:
            env["FLEET_ELASTIC"] = "1"
        return env

    def _trainer_cmd(self) -> List[str]:
        sp = self.spec.trainer
        cmd = [sys.executable, "-m", f"{_PKG}.cli.supervise",
               "baseline", "--dataset", "synthetic",
               "--synthetic_size", str(sp.synthetic_size),
               "--device", self.device,
               "--model", sp.model, "--variant", sp.variant,
               "--dtype", "float32",
               "--image_size", str(sp.image_size),
               "--num_classes", str(sp.num_classes),
               "--batchsize", str(sp.batchsize),
               "--num_workers", "1", "--log_every", "2",
               "--epochs", str(sp.epochs),
               "--out", self.out_dir]
        if sp.hosts > 1:
            cmd += ["--multihost", "--hang_timeout_s", "120"]
        return cmd

    def _launch_host(self, host: _Host) -> None:
        log_path = os.path.join(self.out_dir, f"host{host.index}.log")
        host.log_fh = open(log_path, "a")
        # own session: a host_lost fault SIGKILLs the whole group (trainer
        # AND its cli/supervise.py) without touching this supervisor
        host.proc = subprocess.Popen(
            self._trainer_cmd(), env=self._trainer_env(host.index),
            stdout=host.log_fh, stderr=subprocess.STDOUT,
            start_new_session=True, cwd=self.repo)
        host.state = "running"

    def _replica_env(self, index: int) -> Dict[str, str]:
        env = child_env(os.environ)
        env.update({
            "CHAOS_FAULT_SPEC": self.spec.serve.fault_specs.get(index, ""),
            ENV_EVENTS: self.events_path,
            ENV_SOURCE: f"replica{index}",
        })
        # replicas must not join the trainer fleet
        for k in list(env):
            if k.startswith("FLEET_"):
                del env[k]
        return env

    def _replica_cmd(self, rep: _Replica) -> List[str]:
        sp, sv = self.spec.trainer, self.spec.serve
        rep_out = os.path.join(self.out_dir, f"replica{rep.index}")
        cmd = [sys.executable, "-m", f"{_PKG}.cli.serve", "baseline",
               "--model", sp.model, "--variant", sp.variant,
               "--dtype", "float32",
               "--num_classes", str(sp.num_classes),
               "--image_size", str(sp.image_size),
               "--topk", str(min(5, sp.num_classes)),
               "--device", self.device,
               "--watch", self.out_dir,
               "--reload_poll_s", str(sv.poll_s),
               "--port", str(rep.port),
               "--queue_depth", str(sv.queue_depth),
               "--buckets", sv.buckets,
               "--max_batch", str(sv.max_batch),
               # every replica is a fleet member over the shared run dir:
               # leases + the drain token turn concurrent reloads into a
               # rolling wave (at most one replica draining — S5)
               "--fleet_dir", self.out_dir,
               "--fleet_replica", str(rep.index),
               "--fleet_ttl_s", str(sv.fleet_ttl_s),
               "--out", rep_out,
               "--log_every_s", "10"]
        if sv.admission_deadline_ms > 0:
            cmd += ["--admission_deadline_ms", str(sv.admission_deadline_ms)]
        return cmd

    def _launch_replica(self, rep: _Replica) -> None:
        os.makedirs(os.path.join(self.out_dir, f"replica{rep.index}"),
                    exist_ok=True)
        log_path = os.path.join(self.out_dir, f"replica{rep.index}.log")
        rep.log_fh = open(log_path, "a")
        rep.proc = subprocess.Popen(
            self._replica_cmd(rep), env=self._replica_env(rep.index),
            stdout=rep.log_fh, stderr=subprocess.STDOUT, cwd=self.repo)
        rep.state = "running"
        self.log.emit("replica_start", replica=rep.source, port=rep.port)

    def _wait_replicas_healthy(self, timeout_s: float = 300.0) -> bool:
        """Block until every replica answers /healthz (model build + warmup
        compiles happen before the socket opens)."""
        import urllib.request

        deadline = time.monotonic() + timeout_s
        pending = {r.index for r in self.replicas}
        while pending and time.monotonic() < deadline:
            for rep in self.replicas:
                if rep.index not in pending:
                    continue
                if rep.proc is not None and rep.proc.poll() is not None:
                    self.failures.append(
                        f"{rep.source} died during startup "
                        f"(rc={rep.proc.returncode})")
                    return False
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{rep.port}/healthz",
                            timeout=2.0):
                        pending.discard(rep.index)
                except Exception:
                    pass
            time.sleep(1.0)
        if pending:
            self.failures.append(
                f"replicas never became healthy: {sorted(pending)}")
            return False
        return True

    # ------------------------------------------------------------ load gen --
    def _make_payload(self) -> bytes:
        return png_bytes(payload_pixels(self.spec.trainer.image_size))

    def _load_loop(self) -> None:
        import urllib.error
        import urllib.request

        log = EventLog(self.events_path, "loadgen")
        payload = self._make_payload()
        n = 0
        # period is re-derived every iteration: spike_load steps self._rps
        # mid-run, and the autoscaler grows/retires self.replicas mid-run
        # (snapshot the list; retired replicas stop being targets)
        while not self._load_stop.wait(1.0 / self._rps):
            reps = [r for r in self.replicas if r.state != "retired"]
            if not reps:
                log.emit("request", status="refused", replica="-")
                continue
            order = [(n + k) % len(reps) for k in range(len(reps))]
            n += 1
            answered = False
            for i in order:
                rep = reps[i]
                req = urllib.request.Request(
                    f"http://127.0.0.1:{rep.port}/predict", data=payload,
                    headers={"Content-Type": "image/png"})
                # the client's latency of the answer, one extra field of
                # each answered `request` (the schema lets producers add)
                t_req = time.perf_counter()
                try:
                    with urllib.request.urlopen(
                            req, timeout=self.spec.load.timeout_s) as resp:
                        body = json.loads(resp.read().decode())
                    log.emit("request", status="ok", replica=rep.source,
                             digest=body.get("digest"),
                             generation=body.get("generation"),
                             latency_ms=1e3 * (time.perf_counter() - t_req))
                    answered = True
                    break
                except urllib.error.HTTPError as e:
                    try:
                        body = json.loads(e.read().decode())
                    except Exception:
                        body = {}
                    ms = 1e3 * (time.perf_counter() - t_req)
                    if e.code == 503:
                        # backpressure/drain: degraded-but-ALIVE for S2
                        status = ("draining"
                                  if body.get("state") == "draining"
                                  else "busy")
                        log.emit("request", status=status,
                                 replica=rep.source, code=503, latency_ms=ms)
                    else:
                        log.emit("request", status="error",
                                 replica=rep.source, code=e.code,
                                 latency_ms=ms)
                    answered = True
                    break
                except Exception:
                    continue  # refused/timeout: fail over to the next replica
            if not answered:
                # no replica answered at all — the S2 floor counts this
                log.emit("request", status="refused", replica="-")

    # ------------------------------------------------------------ timeline --
    def _wave_kill_target(self, events: List[Dict]) -> Optional[_Replica]:
        """The replica currently holding the fleet's drain token (or the
        most recent acquirer when the wave just closed): replay the
        drain_token_acquire/release stream the fleet members emit. A
        takeover acquire overwrites the wedged holder — exactly the
        last-writer-wins semantics of the token file itself."""
        holder = None
        last_acquirer = None
        for e in events:
            kind = e.get("kind")
            if kind == "drain_token_acquire":
                holder = last_acquirer = str(e.get("source", ""))
            elif kind == "drain_token_release" \
                    and str(e.get("source", "")) == holder:
                holder = None
        name = holder or last_acquirer
        if name is None:
            return None
        for rep in self.replicas:
            if rep.source == name:
                return rep
        return None

    def _fire_timeline(self, events: List[Dict], elapsed: float) -> None:
        for idx, item in enumerate(self.spec.timeline):
            if idx in self._fired_timeline:
                continue
            due = (elapsed >= item.at_value if item.at_kind == "t" else
                   any(e.get("kind") == "publish"
                       and int(e.get("epoch", -1)) >= item.at_value
                       for e in events))
            if not due:
                continue
            if item.action == "spike_load":
                self._fired_timeline.add(idx)
                self.log.emit("timeline", action=str(item))
                self._rps = float(item.rps)
                # the S5 scale-out deadline is measured from this event
                self.log.emit("spike_load", rps=item.rps)
                continue
            if item.action == "kill_replica_during_wave":
                # stays ARMED past its fire time until a rolling wave is
                # actually in flight — the 0.5s poll would otherwise race
                # short acquire→release windows and kill nobody
                target = self._wave_kill_target(events)
                if target is None or target.proc is None \
                        or target.proc.poll() is not None \
                        or target.state != "running":
                    continue
                self._fired_timeline.add(idx)
                self.log.emit("timeline", action=str(item),
                              target=target.source)
                target.state = "killed"
                target.proc.kill()
                continue
            self._fired_timeline.add(idx)
            rep = self.replicas[item.replica]
            if rep.proc is None or rep.proc.poll() is not None:
                continue  # already down; the relaunch path owns it
            if item.action == "drain_replica":
                # SIGTERM mid-traffic: the reload-during-drain window — the
                # watcher may be mid-swap while the engine flushes its queue
                self.log.emit("timeline", action=str(item))
                rep.state = "draining"
                rep.proc.send_signal(signal.SIGTERM)
            elif item.action == "kill_replica":
                self.log.emit("timeline", action=str(item))
                rep.state = "killed"
                rep.proc.kill()

    # ------------------------------------------------------------- polling --
    def _membership_world(self) -> Optional[List[int]]:
        try:
            with open(os.path.join(self.out_dir, "fleet", "membership")) as f:
                line = f.read().strip()
        except OSError:
            return None
        m = re.search(r"world=([0-9,]+)", line)
        if not m:
            return None
        return [int(x) for x in m.group(1).split(",") if x]

    def _poll_hosts(self) -> None:
        for host in self.hosts:
            if host.state == "lost_waiting":
                # relaunch once the survivors have re-formed WITHOUT the dead
                # host (its lease expired) — relaunching earlier would have
                # the zombie lease readmitted before it ever expired. With
                # no survivor (a pod of one, or every peer gone) nobody
                # re-forms: the host comes back at once and resumes alone
                world = self._membership_world()
                survivors = [h for h in self.hosts
                             if h is not host and h.state == "running"]
                if not survivors or (world is not None
                                     and host.index not in world):
                    self.log.emit("host_relaunch", host=host.index)
                    host.relaunched = True
                    self._launch_host(host)
                continue
            if host.proc is None or host.state in ("done", "failed"):
                continue
            rc = host.proc.poll()
            if rc is None:
                continue
            if rc == 0:
                host.state = "done"
            elif rc in (137, -signal.SIGKILL) and \
                    self.spec.trainer.relaunch_lost and not host.relaunched:
                # the chaos plan took the whole session (host_lost);
                # wait for the survivors to shrink the world, then rejoin
                self.log.emit("host_lost_observed", host=host.index, rc=rc)
                host.state = "lost_waiting"
            else:
                host.state = "failed"
                self.failures.append(
                    f"trainer host {host.index} exited rc={rc} "
                    f"(see host{host.index}.log)")

    def _poll_replicas(self) -> None:
        for rep in self.replicas:
            if rep.proc is None:
                continue
            rc = rep.proc.poll()
            if rc is None:
                continue
            if rep.state == "retired":
                # scale-in: the drain was deliberate and FINAL — no
                # relaunch; a dirty exit still fails the run
                if rc != 0:
                    self.failures.append(
                        f"{rep.source} retire drain exited rc={rc}, want 0")
                self.log.emit("replica_stop", replica=rep.source, rc=rc,
                              deliberate=True)
                if rep.log_fh is not None:
                    rep.log_fh.close()
                    rep.log_fh = None
                rep.proc = None
                continue
            if rep.state in ("draining", "killed"):
                if rep.state == "draining" and rc != 0:
                    self.failures.append(
                        f"{rep.source} drain exited rc={rc}, want 0")
                self.log.emit("replica_stop", replica=rep.source, rc=rc,
                              deliberate=True)
                self._launch_replica(rep)
            else:
                self.failures.append(
                    f"{rep.source} died unexpectedly (rc={rc}, see "
                    f"replica{rep.index}.log)")
                self.log.emit("replica_stop", replica=rep.source, rc=rc,
                              deliberate=False)
                self._launch_replica(rep)  # keep the fleet at strength

    # ---------------------------------------------------------- autoscale --
    def _sample_metrics(self) -> Optional[Dict]:
        """Aggregate the live replicas' /metrics.json into one Autoscaler
        sample: queue depth SUMS (total backlog), fill averages, p99 takes
        the worst replica (an SLO is only as good as the slowest path)."""
        import urllib.request

        depth, fills, p99s = 0.0, [], []
        for rep in self.replicas:
            if rep.state == "retired" or rep.proc is None \
                    or rep.proc.poll() is not None:
                continue
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{rep.port}/metrics.json",
                        timeout=2.0) as resp:
                    snap = json.loads(resp.read().decode())
            except Exception:
                continue  # warming up / mid-drain: not a sample
            depth += float(snap.get("queue_depth", 0) or 0)
            fills.append(float(snap.get("fill_ratio", 0.0) or 0.0))
            p99s.append(float(snap.get("p99_ms", 0.0) or 0.0))
        if not fills:
            return None
        return {"queue_depth": depth,
                "fill_ratio": sum(fills) / len(fills),
                "p99_ms": max(p99s)}

    def _autoscale(self, now: float) -> None:
        if self._scaler is None or now - self._last_scale_sample < 2.0:
            return
        self._last_scale_sample = now
        sample = self._sample_metrics()
        if sample is None:
            return
        live = [r for r in self.replicas
                if r.state != "retired" and r.proc is not None]
        current = len(live)
        if current < 1:
            return
        # reconcile with reality before deciding: kills/relaunches move the
        # count under the scaler's feet
        self._scaler.replicas = current
        want = self._scaler.decide(sample, now)
        # demand supplement (see module docstring): offered rps over the
        # baseline provisioning ratio raises the target too, one step per
        # cycle, honoring the same cooldown the reactive path uses
        per_rep = self.spec.load.rps / max(self.spec.serve.replicas, 1)
        demand = -(-self._rps // per_rep) if per_rep > 0 else current
        demand = max(self._scaler.min_replicas,
                     min(int(demand), self._scaler.max_replicas))
        if demand > current and \
                now - self._scaler.last_action_t >= self._scaler.cooldown_s:
            want = max(want, current + 1)
        elif want < current and demand >= current:
            # the offered load still justifies the current count: an empty
            # queue is the closed-loop generator's artifact, not slack —
            # scaling in here would flap against the demand floor forever
            want = current
        if want > current:
            rep = _Replica(self._next_replica_index, free_port())
            self._next_replica_index += 1
            self.replicas.append(rep)
            self._launch_replica(rep)
            self.log.emit("scale_out", replica=rep.source,
                          replicas=current + 1,
                          queue_depth=sample["queue_depth"],
                          p99_ms=sample["p99_ms"], offered_rps=self._rps)
            self._scaler.applied(current + 1, now)
        elif want < current:
            victim = max(live, key=lambda r: r.index)
            if victim.proc is None or victim.proc.poll() is not None:
                return
            victim.state = "retired"
            victim.proc.send_signal(signal.SIGTERM)
            self.log.emit("scale_in", replica=victim.source,
                          replicas=current - 1,
                          queue_depth=sample["queue_depth"],
                          fill_ratio=sample["fill_ratio"])
            # S3 reads this: the replica is excused from adopting
            # publishes whose deadline lands after its retirement
            self.log.emit("replica_retire", replica=victim.source)
            self._scaler.applied(current - 1, now)

    def _hosts_done(self) -> bool:
        return all(h.state == "done" for h in self.hosts)

    def _hosts_failed(self) -> bool:
        return any(h.state == "failed" for h in self.hosts)

    # ---------------------------------------------------------- completion --
    def _await_final_adoption(self) -> None:
        """Before stopping load: give every replica its chance to pick up
        the last good publish (S3's deadline is the bound) and to finish
        its start (`final_adoption_pending`)."""
        deadline = time.monotonic() + self.spec.adopt_deadline_s
        while time.monotonic() < deadline:
            # recomputed every pass: a scale-out adds sources that must
            # adopt too; a retirement removes one that never will again
            want = {r.source for r in self.replicas if r.state != "retired"}
            if not final_adoption_pending(read_events(self.events_path),
                                          want):
                return
            time.sleep(1.0)

    def _stop_replicas(self) -> None:
        for rep in self.replicas:
            if rep.proc is None or rep.proc.poll() is not None:
                continue
            rep.state = "draining"
            rep.proc.send_signal(signal.SIGTERM)
        for rep in self.replicas:
            if rep.proc is None:
                continue
            try:
                rc = rep.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                rep.proc.kill()
                rc = rep.proc.wait()
                self.failures.append(f"{rep.source} did not drain in 60s")
            if rc != 0:
                self.failures.append(
                    f"{rep.source} final drain exited rc={rc}, want 0")
            self.log.emit("replica_stop", replica=rep.source, rc=rc,
                          deliberate=True)
            if rep.log_fh is not None:
                rep.log_fh.close()
                rep.log_fh = None

    def _run_lint(self) -> None:
        env = child_env(os.environ)
        env.pop(ENV_EVENTS, None)  # the analyzer is not a scenario actor
        try:
            proc = subprocess.run(
                [sys.executable, "-m", f"{_PKG}.analysis.lint"],
                cwd=self.repo, env=env, capture_output=True, text=True,
                timeout=120)
            rc = proc.returncode
            if rc != 0:
                tail = (proc.stdout + proc.stderr)[-2000:]
                self.failures.append(f"lint exited rc={rc}: …{tail}")
        except subprocess.TimeoutExpired:
            rc = 124
            self.failures.append("lint timed out")
        self.log.emit("lint", rc=rc)

    def _check_devices(self, aborted: bool) -> None:
        """Every child's banner names `self.device`; after a clean run at
        least one trainer and one replica banner are there to read."""
        seen = {"trainer": 0, "serve": 0}
        logs = ([f"host{h.index}.log" for h in self.hosts]
                + [f"replica{r.index}.log" for r in self.replicas])
        for name in logs:
            try:
                with open(os.path.join(self.out_dir, name)) as f:
                    text = f.read()
            except OSError:
                continue
            for who, device in banner_devices(text):
                seen[who] += 1
                if device != self.device:
                    self.failures.append(
                        f"{name}: a {who} ran on {device}, not the "
                        f"{self.device} asked for")
        missing = [k for k, n in seen.items() if n == 0]
        if missing and not aborted:
            self.failures.append(
                f"no {'/'.join(missing)} banner naming a device in the "
                "children's logs")

    def _kill_everything(self) -> None:
        for host in self.hosts:
            if host.proc is not None and host.proc.poll() is None:
                try:  # the host runs in its own session: kill the group
                    os.killpg(host.proc.pid, signal.SIGKILL)
                except OSError:
                    host.proc.kill()
            if host.log_fh is not None:
                host.log_fh.close()
                host.log_fh = None
        for rep in self.replicas:
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.kill()
            if rep.log_fh is not None:
                rep.log_fh.close()
                rep.log_fh = None

    # ---------------------------------------------------------------- run --
    def run(self) -> int:
        os.makedirs(self.out_dir, exist_ok=True)
        self.coord_port = free_port()
        self._t0 = time.monotonic()
        self.log.emit("scenario_start", out=self.out_dir,
                      hosts=self.spec.trainer.hosts,
                      replicas=self.spec.serve.replicas)
        try:
            self.hosts = [_Host(i) for i in range(self.spec.trainer.hosts)]
            self.replicas = [_Replica(i, free_port())
                             for i in range(self.spec.serve.replicas)]
            sv = self.spec.serve
            if sv.max_replicas > sv.replicas:
                self._scaler = Autoscaler(
                    min_replicas=sv.replicas, max_replicas=sv.max_replicas,
                    p99_slo_ms=sv.admission_deadline_ms,
                    queue_high=max(sv.queue_depth // 2, 2),
                    cooldown_s=5.0, replicas=sv.replicas)
            for host in self.hosts:
                self._launch_host(host)
            for rep in self.replicas:
                self._launch_replica(rep)
            if not self._wait_replicas_healthy():
                return self._finish(aborted=True)
            self._load_thread = threading.Thread(
                target=self._load_loop, daemon=True, name="scenario-load")
            self._load_thread.start()

            while True:
                elapsed = time.monotonic() - self._t0
                if elapsed > self.spec.deadline_s:
                    self.failures.append(
                        f"scenario deadline {self.spec.deadline_s}s exceeded")
                    return self._finish(aborted=True)
                events = read_events(self.events_path)
                self._fire_timeline(events, elapsed)
                self._poll_hosts()
                self._poll_replicas()
                self._autoscale(time.monotonic() - self._t0)
                if self._hosts_failed():
                    return self._finish(aborted=True)
                if self._hosts_done():
                    break
                time.sleep(0.5)

            self._await_final_adoption()
            return self._finish(aborted=False)
        except Exception as e:
            self.failures.append(f"supervisor error: {type(e).__name__}: {e}")
            return self._finish(aborted=True)

    def _finish(self, aborted: bool) -> int:
        self._load_stop.set()
        if self._load_thread is not None:
            self._load_thread.join(timeout=10)
        if aborted:
            self._kill_everything()
        else:
            self._stop_replicas()
            for host in self.hosts:
                if host.log_fh is not None:
                    host.log_fh.close()
                    host.log_fh = None
        self._check_devices(aborted)
        if not aborted and not self.skip_lint:
            self._run_lint()
        self.log.emit("scenario_end", ok=not self.failures,
                      failures=self.failures)
        return 1 if self.failures else 0
