"""The port's scenario fuzzer (`scenario/fuzz.py`, `cli/fuzz.py`) against
the JAX package's, byte for byte: sampler draws, coverage keys, the pair
universe, simulated events with and without each bug model, shrinks,
whole fuzz runs and the saved ledger.

All of it is in-process standard library (no process, no sleep), except
the `slow` drill at the bottom: JAX phase 8's spec through the port's
`cli/scenario.py` with two gloo trainer hosts on the CPU.
"""

import json
import os

import pytest

from ddp_classification_pytorch_tpu.scenario import fuzz as jax_fuzz
from ddp_classification_pytorch_tpu.scenario import invariants as jax_inv
from ddp_classification_pytorch_tpu.scenario import spec as jax_spec
from ddp_classification_pytorch_tpu_torch.cli import fuzz as fuzz_cli
from ddp_classification_pytorch_tpu_torch.obs.events import (read_events,
                                                             validate_events)
from ddp_classification_pytorch_tpu_torch.scenario import fuzz
from ddp_classification_pytorch_tpu_torch.scenario import invariants as inv
from ddp_classification_pytorch_tpu_torch.scenario import spec as port_spec

from torch_port_threads import one_torch_thread  # noqa: F401

BUGS = [(), ("adopt_unverified",), ("spike_unanswered",),
        ("adopt_unverified", "spike_unanswered")]


def _both(raw):
    return port_spec.parse_spec(json.loads(json.dumps(raw))), \
        jax_spec.parse_spec(json.loads(json.dumps(raw)))


@pytest.mark.parametrize("seed", [0, 7, 23])
@pytest.mark.parametrize("steered", [False, True])
def test_sampler_draws_equal_jax(seed, steered):
    """50 draws, with a ledger recording each draw's keys (steered: the
    candidates are scored against it) and without one."""
    ours, theirs = fuzz.SpecSampler(seed, 3), jax_fuzz.SpecSampler(seed, 3)
    led, jled = fuzz.CoverageLedger(), jax_fuzz.CoverageLedger()
    for _ in range(50):
        a = ours.sample(led if steered else None)
        b = theirs.sample(jled if steered else None)
        assert a.to_json() == b.to_json()
        assert [(c.to_json(), n) for c, n in ours.last_candidates] == \
            [(c.to_json(), n) for c, n in theirs.last_candidates]
        keys = fuzz.coverage_keys(a)
        assert keys == jax_fuzz.coverage_keys(b)
        led.record(keys)
        jled.record(keys)
    assert led.pairs == jled.pairs and led.specs_run == jled.specs_run


def test_pair_universe_and_ledger_file_equal_jax(tmp_path):
    assert fuzz.pair_universe() == jax_fuzz.pair_universe()
    assert fuzz.ACTION_SUBSYSTEM == jax_fuzz.ACTION_SUBSYSTEM
    paths = [str(tmp_path / "ours" / "l.json"),
             str(tmp_path / "theirs" / "l.json")]
    leds = [fuzz.CoverageLedger(paths[0]), jax_fuzz.CoverageLedger(paths[1])]
    for mod, led in zip((fuzz, jax_fuzz), leds):
        mod.Fuzzer(mod.sim_runner, seed=1, candidates=4, ledger=led).run(6)
        led.save()
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    again = fuzz.CoverageLedger.load(paths[1])
    assert again.pairs == leds[1].pairs
    assert again.uncovered() == leds[1].uncovered()
    assert again.distinct() >= 20


def _sampled_specs(n=12, seed=3):
    s = jax_fuzz.SpecSampler(seed, 1)
    return [json.loads(s.sample().to_json()) for _ in range(n)]


_HAND = [
    {"trainer": {"hosts": 2, "epochs": 3,
                 "fault_specs": {"0": "ckpt_io@epoch=0"}},
     "serve": {"replicas": 2, "fault_specs": {"0": "watcher_io@poll=2"}},
     "timeline": [{"at": "t:10", "action": "kill_replica", "replica": 1}]},
    {"serve": {"replicas": 1, "max_replicas": 2},
     "timeline": [{"at": "t:10", "action": "spike_load", "rps": 12.0}]},
    {"trainer": {"hosts": 1, "epochs": 1}, "serve": {"replicas": 2},
     "timeline": [{"at": "t:0", "action": "kill_replica_during_wave"},
                  {"at": "t:0", "action": "kill_replica_during_wave"}]},
    {"trainer": {"hosts": 3, "epochs": 3, "fault_specs": {
        "0": "publish_corrupt@epoch=1", "2": "host_lost@step=9",
        "1": "sigterm@step=3,peer_slow@step=14"}},
     "serve": {"replicas": 3, "max_replicas": 4,
               "fault_specs": {"2": "watcher_io@poll=1..3"}},
     "timeline": [{"at": "publish:0", "action": "drain_replica",
                   "replica": 2},
                  {"at": "t:18", "action": "spike_load", "rps": 12.0},
                  {"at": "t:26", "action": "kill_replica_during_wave"}]},
]


@pytest.mark.parametrize("bugs", BUGS, ids=lambda b: "+".join(b) or "none")
def test_simulated_events_and_verdicts_equal_jax(bugs):
    for raw in _HAND + _sampled_specs():
        ours, theirs = _both(raw)
        ev = fuzz.simulate_events(ours, bugs=bugs)
        assert ev == jax_fuzz.simulate_events(theirs, bugs=bugs)
        assert validate_events(ev) == []
        assert [str(v) for v in inv.check_invariants(ev, ours)] == \
            [str(v) for v in jax_inv.check_invariants(ev, theirs)]
    if not bugs:
        for raw in _HAND:
            assert fuzz.sim_runner(port_spec.parse_spec(raw)) == []


def _planted(spec):
    tr = ",".join(spec.trainer.fault_specs.values())
    sv = ",".join(spec.serve.fault_specs.values())
    if "nan_loss" in tr and "watcher_io" in sv:
        return [inv.Violation("PLANTED", "nan_loss x watcher_io co-occur")]
    return []


def _result(r):
    return (r.found, r.specs_run, r.shrink_runs,
            r.seed_spec.to_json() if r.seed_spec else None,
            r.minimized.to_json() if r.minimized else None,
            [str(v) for v in r.violations])


@pytest.mark.parametrize("seed,candidates,budget", [(0, 2, 30), (4, 3, 30)])
def test_fuzzer_on_the_planted_pair_equals_jax(seed, candidates, budget):
    """JAX's planted-pair fixture: the same find, the same shrink runs and
    the same minimized spec."""
    ours = fuzz.Fuzzer(_planted, seed=seed, candidates=candidates)
    theirs = jax_fuzz.Fuzzer(_planted, seed=seed, candidates=candidates)
    a, b = ours.run(budget), theirs.run(budget)
    assert _result(a) == _result(b)
    assert a.found and a.minimized.trainer.hosts == 1 \
        and a.minimized.serve.replicas == 1
    assert ours.ledger.pairs == theirs.ledger.pairs


@pytest.mark.parametrize("max_runs", [5, 200])
def test_shrink_spec_equals_jax(max_runs):
    raw = {"trainer": {"hosts": 3, "fault_specs": {"2": "nan_loss@step=4"}},
           "serve": {"replicas": 2, "fault_specs": {"1": "watcher_io@poll=3"}}}
    ours, theirs = _both(raw)
    a, ra = fuzz.shrink_spec(ours, lambda s: bool(_planted(s)), max_runs)
    b, rb = jax_fuzz.shrink_spec(theirs, lambda s: bool(_planted(s)),
                                 max_runs)
    assert (a.to_json(), ra) == (b.to_json(), rb)


def test_label_preserving_shrink_and_bug_model_fuzz_equal_jax():
    """A shrink keyed to the first failure's labels, and a whole fuzz run
    over the adopt-unverified bug model (S1 red), as JAX's."""
    def runner(spec):
        out = []
        tr = ",".join(spec.trainer.fault_specs.values())
        if "nan_loss" in tr and "host_lost" in tr:
            out.append(inv.Violation("A", "pair bug"))
        if spec.trainer.hosts == 1:
            out.append(inv.Violation("B", "unrelated small-topology red"))
        return out

    raw = {"trainer": {"hosts": 2, "fault_specs": {
        "0": "nan_loss@step=2", "1": "host_lost@step=4"}}}
    ours, theirs = _both(raw)

    def fails(s):
        return bool({"A"} & {v.invariant for v in runner(s)})

    a, ra = fuzz.shrink_spec(ours, fails)
    b, rb = jax_fuzz.shrink_spec(theirs, fails)
    assert (a.to_json(), ra) == (b.to_json(), rb)

    def buggy(mod, i):
        return lambda s: i.check_invariants(
            mod.simulate_events(s, bugs=("adopt_unverified",)), s)

    r1 = fuzz.Fuzzer(buggy(fuzz, inv), seed=0, candidates=2).run(10)
    r2 = jax_fuzz.Fuzzer(buggy(jax_fuzz, jax_inv), seed=0,
                         candidates=2).run(10)
    assert _result(r1) == _result(r2)
    assert r1.found and any(v.invariant == "S1" for v in r1.violations)


def test_cli_fuzz_green_red_and_bad_args(tmp_path, monkeypatch, capsys):
    """`cli/fuzz.py --runner sim`: a green budget saves the ledger JAX's
    CLI saves; a red run (the adopt-unverified bug model as the sim)
    writes the minimized spec, seed spec, events and report; bad
    arguments are rc 2; the drill runner without a card is rc 3."""
    from ddp_classification_pytorch_tpu.cli import fuzz as jax_cli

    out, jout = str(tmp_path / "fuzz"), str(tmp_path / "jfuzz")
    fuzz_cli.main(["--seed", "0", "--budget", "6", "--out", out])
    jax_cli.main(["--seed", "0", "--budget", "6", "--out", jout])
    assert "GREEN" in capsys.readouterr().out
    with open(os.path.join(out, "fuzz_ledger.json"), "rb") as a, \
            open(os.path.join(jout, "fuzz_ledger.json"), "rb") as b:
        assert a.read() == b.read()

    real = fuzz.simulate_events

    def buggy(spec, bugs=()):
        return real(spec, bugs=tuple(bugs) + ("adopt_unverified",))

    monkeypatch.setattr(fuzz, "simulate_events", buggy)
    red = str(tmp_path / "red")
    with pytest.raises(SystemExit) as exc:
        fuzz_cli.main(["--seed", "0", "--budget", "4", "--out", red,
                       "--max_shrink_runs", "40"])
    assert exc.value.code == 1
    mini = os.path.join(red, "minimized")
    assert sorted(os.listdir(mini)) == ["events.jsonl", "report.json",
                                        "seed_spec.json", "spec.json"]
    with open(os.path.join(mini, "spec.json")) as f:
        text = f.read()
    assert port_spec.parse_spec(json.loads(text)).to_json() == text
    events = read_events(os.path.join(mini, "events.jsonl"))
    assert validate_events(events) == []
    assert "VIOLATION [S1]" in capsys.readouterr().err

    for argv in (["--budget", "0"], ["--candidates", "0"],
                 ["--max_shrink_runs", "-1"]):
        with pytest.raises(SystemExit) as exc:
            fuzz_cli.main(argv + ["--out", str(tmp_path / "x")])
        assert exc.value.code == 2
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        fuzz_cli.main(["--runner", "drill", "--budget", "1",
                       "--out", str(tmp_path / "drill")])
    assert exc.value.code == 3
    assert not (tmp_path / "drill" / "drills").exists()


# ------------------------------------------------------------ slow drill --

# JAX drill phase 8's spec (scripts/scenario.sh's default): two elastic
# gloo hosts, resnet18 cifar at 16 px, every fault family, a drain at the
# epoch-1 publish
PHASE8 = {
    "trainer": {"hosts": 2, "elastic": True, "min_processes": 1,
                "epochs": 4,
                "fault_specs": {"0": "ckpt_io@epoch=0,publish_corrupt@epoch=2",
                                "1": "nan_loss@step=2..3,host_lost@step=10"}},
    "serve": {"replicas": 2, "poll_s": 1.0,
              "fault_specs": {"0": "watcher_io@poll=3"}},
    "load": {"rps": 4.0, "timeout_s": 20.0},
    "availability": {"floor": 0.5, "window_s": 10.0, "min_samples": 3},
    "adopt_deadline_s": 180.0,
    "deadline_s": 900.0,
    "timeline": [{"at": "publish:1", "action": "drain_replica",
                  "replica": 1}],
}


@pytest.mark.slow
def test_cpu_drill_of_jax_phase8(tmp_path, capsys):
    """The port's whole drill on the CPU: `cli/scenario.py --device cpu`
    over two gloo trainer hosts and two replicas; green, with every
    child on the CPU and the events the spec's faults must leave."""
    from ddp_classification_pytorch_tpu_torch.cli import scenario

    out = str(tmp_path / "drill")
    scenario.main(["--scenario_spec", json.dumps(PHASE8), "--out", out,
                   "--device", "cpu"])
    assert "GREEN" in capsys.readouterr().out
    kinds = {e["kind"] for e in read_events(os.path.join(out,
                                                         "events.jsonl"))}
    for want in ("publish_torn", "quarantine", "host_lost_observed",
                 "host_relaunch", "reform", "verify_ok", "swap",
                 "drain_begin", "watcher_error", "lint"):
        assert want in kinds, want
