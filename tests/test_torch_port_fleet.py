"""The port's serve-fleet control plane (`serve/fleet.py`) against the JAX
package's, on the CPU: the same scripted sequences through both modules
give equal results.

- `parse_tenants` on valid specs and on each error (equal messages);
- leases written by one package and scanned by the other give equal
  memberships and leaders, and a lease aged past the TTL (`os.utime`)
  drops out of both scans;
- the drain token's acquire, refusal, takeover of a stale token and
  release, with the members of the two packages interleaved;
- `AdmissionController`'s shed decisions on an injected clock and
  service rate;
- `Autoscaler`'s decisions on the same gauge sequences;
- the events the port emits read back through JAX's `read_events` and
  pass its `validate_events`.
"""

import os
import types
from concurrent.futures import Future

import pytest

from ddp_classification_pytorch_tpu.obs import events as jax_events
from ddp_classification_pytorch_tpu.serve import fleet as jax_fleet
from ddp_classification_pytorch_tpu_torch.obs import events as port_events
from ddp_classification_pytorch_tpu_torch.serve import fleet as port_fleet

from torch_port_threads import one_torch_thread  # noqa: F401

PACKAGES = {"jax": jax_fleet, "port": port_fleet}

VALID = ["", "  ", "a:3,b:1", "a", " a : 2 , b ", "x:0.5,y", "a:1,,b:2"]
INVALID = ["a:0", "a:-1", ":3", "a:x", "a:1,a:2", ",", " , ", "a:1,:2"]


def _parse(mod, spec):
    try:
        return ("ok", mod.parse_tenants(spec))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec", VALID + INVALID)
def test_parse_tenants_matches_jax(spec):
    want, got = _parse(jax_fleet, spec), _parse(port_fleet, spec)
    assert got == want
    assert got[0] == ("ok" if spec in VALID else "error")


def _leases(scan):
    return {r: (l.replica, l.state, l.digest, l.generation)
            for r, l in scan.items()}


def test_leases_cross_read_between_packages(tmp_path):
    run = str(tmp_path)
    # replica 0 from the JAX package, 1 and 2 from the port
    members = {0: jax_fleet.FleetMember(run, 0, ttl_s=15.0),
               1: port_fleet.FleetMember(run, 1, ttl_s=15.0),
               2: port_fleet.FleetMember(run, 2, ttl_s=15.0)}
    members[0].heartbeat(digest="d0", generation=3)
    members[1].heartbeat(digest="d0", generation=3)
    members[2].heartbeat()  # still joining: no digest yet
    scans = {name: _leases(mod.scan_replica_leases(run, ttl_s=15.0))
             for name, mod in PACKAGES.items()}
    assert scans["port"] == scans["jax"]
    assert scans["jax"] == {0: (0, "serving", "d0", 3),
                            1: (1, "serving", "d0", 3),
                            2: (2, "joining", "", -1)}
    roles = {r: m.role() for r, m in members.items()}
    assert roles == {0: "leader", 1: "follower", 2: "follower"}
    assert (members[1].fleet_converged() is members[0].fleet_converged()
            is False)  # replica 2 serves no digest yet
    # the JAX replica's lease goes stale: both scans drop it, the port's
    # replica 1 leads
    old = os.path.getmtime(jax_fleet.replica_lease_path(run, 0)) - 60
    os.utime(jax_fleet.replica_lease_path(run, 0), (old, old))
    for mod in PACKAGES.values():
        assert sorted(mod.scan_replica_leases(run, ttl_s=15.0)) == [1, 2]
    assert members[1].role() == "leader"
    # the stale replica 0 reads the scan as its own package does: a port
    # member of the same id decides as the JAX one
    assert port_fleet.FleetMember(run, 0).role() == members[0].role()
    # a torn or foreign file in the namespace is skipped by both
    with open(os.path.join(port_fleet.serve_fleet_dir(run), "lease.rx"), "w"):
        pass
    assert (_leases(jax_fleet.scan_replica_leases(run, ttl_s=15.0))
            == _leases(port_fleet.scan_replica_leases(run, ttl_s=15.0)))
    members[2].leave()
    assert sorted(jax_fleet.scan_replica_leases(run, ttl_s=15.0)) == [1]


def _token_script(run, kinds):
    """The drain token between two replicas of the packages `kinds`:
    acquire, refusal, re-acquire while held, takeover of a stale token,
    the evicted holder's release, the new holder's release."""
    a = PACKAGES[kinds[0]].FleetMember(run, 0, ttl_s=10.0)
    b = PACKAGES[kinds[1]].FleetMember(run, 1, ttl_s=10.0)
    token = port_fleet.wave_token_path(run)
    out = []

    def snap(tag, result=None):
        body = open(token).read() if os.path.exists(token) else None
        out.append((tag, result, a.state, b.state, a.holds_token,
                    b.holds_token, body))

    for m in (a, b):
        m.heartbeat(digest="d0", generation=0)
    snap("a acquires", a.try_begin_drain("d1"))
    snap("b refused", b.try_begin_drain("d1"))
    snap("a again", a.try_begin_drain("d1"))
    old = os.path.getmtime(token) - 60  # a wedged holder: stale token
    os.utime(token, (old, old))
    snap("b takes over", b.try_begin_drain("d2"))
    a.end_drain(digest="d1", generation=1)  # not its token any more
    snap("a released (token kept)")
    b.end_drain(digest="d2", generation=2)
    snap("b released")
    snap("a acquires again", a.try_begin_drain("d3"))
    a.leave()
    snap("a left")
    peers = PACKAGES[kinds[1]].scan_replica_leases(run, ttl_s=10.0)
    out.append(("peers", _leases(peers)))
    return out


@pytest.mark.parametrize("kinds", [("port", "port"), ("jax", "port"),
                                   ("port", "jax")],
                         ids=["port-port", "jax-port", "port-jax"])
def test_drain_token_sequence_matches_jax(tmp_path, kinds):
    want = _token_script(str(tmp_path / "jax"), ("jax", "jax"))
    got = _token_script(str(tmp_path / "x"), kinds)
    assert got == want
    assert want[0][1] is True and want[1][1] is False
    assert want[3][1] is True  # the stale token was taken over


class _Clock:
    """Injected `time` for both modules: monotonic() and time() read t."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


class _Engine:
    """A stand-in engine: a queue depth the script sets, a completion
    counter, and submits that return pending futures."""

    def __init__(self):
        self.queue_depth = 0
        self.metrics = types.SimpleNamespace(completed=0, rejected=0)
        self.metrics.record_reject = self._reject
        self.futures = []
        self.full = False

    def _reject(self):
        self.metrics.rejected += 1

    def submit(self, image):
        if self.full:
            raise port_fleet_queue_full()
        f = Future()
        self.futures.append(f)
        return f


def port_fleet_queue_full():
    # the admission layer matches the engine's QueueFull by name
    return type("QueueFull", (RuntimeError,), {})("queue full")


# (advance clock s, completions since last step, queue depth, tenant,
# finish the oldest pending future first, engine queue full)
ADMISSION_SCRIPT = [
    (0.0, 0, 0, "a", False, False),
    (0.1, 4, 1, "a", False, False),
    (0.1, 4, 2, "b", False, False),
    (0.1, 1, 6, "a", False, False),
    (0.1, 0, 8, "a", False, False),
    (0.1, 0, 8, "b", True, False),
    (0.2, 10, 3, "c", False, False),
    (0.02, 0, 3, "a", False, False),
    (0.1, 2, 12, "b", False, False),
    (0.1, 30, 0, "a", True, True),
    (0.1, 30, 0, "b", True, False),
]


def _admission_run(mod, monkeypatch, tmp_path, name):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    events = str(tmp_path / f"{name}.jsonl")
    monkeypatch.setenv("SCENARIO_EVENTS", events)
    engine = _Engine()
    adm = mod.AdmissionController(engine, tenants="a:3,b:1",
                                  deadline_ms=50.0)
    out = []
    for dt, done, depth, tenant, finish, full in ADMISSION_SCRIPT:
        clock.t += dt
        engine.metrics.completed += done
        engine.queue_depth = depth
        engine.full = full
        if finish and engine.futures:
            engine.futures.pop(0).set_result(None)
        try:
            adm.submit(object(), tenant=tenant)
            out.append(("admit", tenant, round(adm._rate_rps, 9)))
        except mod.AdmissionShed as e:
            out.append(("shed", e.tenant, e.queue_depth,
                        round(e.est_wait_ms, 9)))
    out.append(sorted(adm._inflight.items()))
    out.append(adm.registry.expose())
    out.append(engine.metrics.rejected)
    return out, jax_events.read_events(events)


def test_admission_decisions_match_jax(monkeypatch, tmp_path):
    want, want_ev = _admission_run(jax_fleet, monkeypatch, tmp_path, "jax")
    got, got_ev = _admission_run(port_fleet, monkeypatch, tmp_path, "port")
    assert got == want
    kinds = [r[0] for r in want[:-2]]
    assert "admit" in kinds and "shed" in kinds  # the script hits both
    strip = [{k: v for k, v in r.items() if k not in ("ts", "source")}
             for r in got_ev]
    assert strip == [{k: v for k, v in r.items() if k not in ("ts", "source")}
                     for r in want_ev]
    assert strip and jax_events.validate_events(got_ev) == []


def test_admission_with_injected_rate_matches_jax():
    out = {}
    for name, mod in PACKAGES.items():
        engine = _Engine()
        rates = iter([0.5, 5.0, 50.0, 500.0, 5.0, 0.5])
        adm = mod.AdmissionController(engine, tenants="", deadline_ms=100.0,
                                      rate_fn=lambda: next(rates))
        seq = []
        for depth in (1, 1, 1, 1, 0, 3):
            engine.queue_depth = depth
            try:
                adm.submit(object())
                seq.append("admit")
            except mod.AdmissionShed as e:
                seq.append(("shed", e.queue_depth, e.est_wait_ms))
        out[name] = seq
    assert out["port"] == out["jax"]


GAUGES = [
    {"queue_depth": 0, "fill_ratio": 0.9, "p99_ms": 10},
    {"queue_depth": 9, "fill_ratio": 1.0, "p99_ms": 40},
    {"queue_depth": 9, "fill_ratio": 1.0, "p99_ms": 40},
    {"queue_depth": 2, "fill_ratio": 1.0, "p99_ms": 300},
    {"queue_depth": 0, "fill_ratio": 0.1, "p99_ms": 10},
    {"queue_depth": 0, "fill_ratio": 0.1, "p99_ms": 10},
    {"queue_depth": 0, "fill_ratio": 0.1, "p99_ms": None},
    {},
]


@pytest.mark.parametrize("kw", [
    dict(min_replicas=1, max_replicas=3, p99_slo_ms=200, cooldown_s=5),
    dict(min_replicas=2, max_replicas=2),
    dict(min_replicas=1, max_replicas=4, queue_high=2, fill_low=0.5,
         cooldown_s=0),
], ids=["slo", "pinned", "eager"])
def test_autoscaler_decisions_match_jax(kw):
    runs = {}
    for name, mod in PACKAGES.items():
        scaler = mod.Autoscaler(**kw)
        seq = []
        for i, sample in enumerate(GAUGES):
            now = 3.0 * i
            want = scaler.decide(sample, now)
            scaler.applied(want, now)
            seq.append((want, scaler.replicas, scaler.last_action_t))
        runs[name] = seq
    assert runs["port"] == runs["jax"]


@pytest.mark.parametrize("kw", [dict(min_replicas=0),
                                dict(min_replicas=3, max_replicas=2)])
def test_autoscaler_refusals_match_jax(kw):
    msgs = []
    for mod in PACKAGES.values():
        with pytest.raises(ValueError) as e:
            mod.Autoscaler(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_fleet_events_pass_jax_validation(monkeypatch, tmp_path):
    """The token sequence's events, port vs JAX: the same kinds and fields
    in the same order, and JAX's reader and schema accept the port's."""
    logs = {}
    for name in ("jax", "port"):
        path = str(tmp_path / f"{name}.jsonl")
        monkeypatch.setenv("SCENARIO_EVENTS", path)
        monkeypatch.setenv("SCENARIO_SOURCE", f"replica-{name}")
        _token_script(str(tmp_path / name), (name, name))
        logs[name] = jax_events.read_events(path)
    assert jax_events.validate_events(logs["port"]) == []
    assert [r["source"] for r in logs["port"]] == ["replica-port"] * len(
        logs["port"])

    def strip(log):
        return [{k: v for k, v in r.items() if k not in ("ts", "source")}
                for r in log]

    assert strip(logs["port"]) == strip(logs["jax"])
    assert [r["kind"] for r in logs["port"]] == [
        "drain_token_acquire", "drain_token_takeover", "drain_token_acquire",
        "drain_token_release", "drain_token_release", "drain_token_acquire",
        "drain_token_release"]
    # the port's own reader and schema are the JAX package's
    assert port_events.EVENT_SCHEMA == jax_events.EVENT_SCHEMA
    assert port_events.read_events(str(tmp_path / "port.jsonl")) == logs["port"]
