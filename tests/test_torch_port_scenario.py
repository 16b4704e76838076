"""The port's scenario runner (`scenario/spec.py`, `scenario/invariants.py`,
`scenario/supervisor.py`, `analysis/lint.py`, `cli/scenario.py`) against
the JAX package's, on the same inputs.

The code under test is standard library, so every comparison is exact
(tolerance zero): equal `to_json` bytes or a `SpecError` from both, equal
lists of violation strings, equal findings. Nothing here starts a process:
the supervisor's command lines are parsed, not run, and the restart log
is written by `cli/supervise.py` over a stubbed `subprocess.run`.
"""

import json
import os
import sys

import numpy as np
import pytest

from ddp_classification_pytorch_tpu.analysis import lint as jax_lint
from ddp_classification_pytorch_tpu.scenario import invariants as jax_inv
from ddp_classification_pytorch_tpu.scenario import spec as jax_spec
from ddp_classification_pytorch_tpu.scenario import supervisor as jax_sup
from ddp_classification_pytorch_tpu_torch.analysis import lint
from ddp_classification_pytorch_tpu_torch.cli import scenario as scenario_cli
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
from ddp_classification_pytorch_tpu_torch.cli import supervise
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.obs.events import validate_events
from ddp_classification_pytorch_tpu_torch.scenario import invariants as inv
from ddp_classification_pytorch_tpu_torch.scenario import spec as port_spec
from ddp_classification_pytorch_tpu_torch.scenario import supervisor as sup

from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "data", "scenarios")
PORT = "ddp_classification_pytorch_tpu_torch"


# ------------------------------------------------------------------ spec --

_FULL = {
    "trainer": {"hosts": 2, "epochs": 4, "min_processes": 1,
                "fault_specs": {"0": "ckpt_io@epoch=0",
                                "1": "host_lost@step=10"}},
    "serve": {"replicas": 2, "poll_s": 0.5,
              "fault_specs": {"1": "watcher_io@poll=3"}},
    "load": {"rps": 2.0, "timeout_s": 10},
    "availability": {"floor": 0.8, "window_s": 5, "min_samples": 2},
    "adopt_deadline_s": 60,
    "timeline": [{"at": "publish:1", "action": "drain_replica",
                  "replica": 1},
                 {"at": "t:30", "action": "kill_replica"}],
}
_FLEET = {
    "serve": {"replicas": 2, "max_replicas": 3, "fleet_ttl_s": 2.5,
              "admission_deadline_ms": 250.0,
              "scale_out_deadline_s": 30.0},
    "timeline": [{"at": "t:30", "action": "spike_load", "rps": 12},
                 {"at": "t:40", "action": "kill_replica_during_wave"}],
}
# the scenario on the card (chip_smoke.py phase 30)
_CARD = {
    "trainer": {"hosts": 1, "elastic": True, "min_processes": 1, "epochs": 4,
                "model": "tresnet_m", "variant": "imagenet",
                "num_classes": 2173, "image_size": 224, "batchsize": 32,
                "synthetic_size": 256, "relaunch_lost": True,
                "fault_specs": {"0": "ckpt_io@epoch=0,nan_loss@step=2..3,"
                                     "host_lost@step=12,"
                                     "publish_corrupt@epoch=2"}},
    "serve": {"replicas": 2, "poll_s": 1.0, "queue_depth": 16,
              "max_batch": 8, "buckets": "1,8", "max_replicas": 3,
              "fleet_ttl_s": 6.0, "admission_deadline_ms": 250.0,
              "scale_out_deadline_s": 60.0,
              "fault_specs": {"0": "watcher_io@poll=3"}},
    "load": {"rps": 4.0, "timeout_s": 20.0},
    "availability": {"floor": 0.5, "window_s": 10.0, "min_samples": 3},
    "adopt_deadline_s": 120.0, "deadline_s": 600.0,
    "timeline": [{"at": "publish:1", "action": "drain_replica", "replica": 1},
                 {"at": "t:40", "action": "kill_replica_during_wave"},
                 {"at": "t:60", "action": "spike_load", "rps": 12.0}],
}
GOOD_SPECS = ["{}", json.dumps(_FULL), json.dumps(_FLEET), json.dumps(_CARD)]
# tests/test_scenario.py's malformed specs, each an rc 2
BAD_SPECS = [
    "",
    "/nonexistent/spec.json",
    '{"trainer": "x"}',
    '{"bogus": 1}',
    '{"trainer": {"hosts": 0}}',
    '{"trainer": {"min_processes": 3}}',
    '{"serve": {"replicas": 0}}',
    '{"availability": {"floor": 1.5}}',
    '{"adopt_deadline_s": -1}',
    '{"trainer": {"fault_specs": {"0": "frobnicate@step=1"}}}',
    '{"trainer": {"fault_specs": {"9": "ckpt_io@epoch=0"}}}',
    '{"serve": {"fault_specs": {"0": "watcher_io@step=3"}}}',
    '{"timeline": [{"at": "epoch:1", "action": "drain_replica"}]}',
    '{"timeline": [{"at": "t:1", "action": "explode"}]}',
    '{"timeline": [{"at": "t:1", "action": "drain_replica", "replica": 7}]}',
    '{"serve": {"replicas": 2, "max_replicas": 1}}',
    '{"serve": {"fleet_ttl_s": 0}}',
    '{"serve": {"admission_deadline_ms": -1}}',
    '{"serve": {"scale_out_deadline_s": 0}}',
    '{"timeline": [{"at": "t:1", "action": "spike_load"}]}',
    '{"timeline": [{"at": "t:1", "action": "spike_load", "rps": 0}]}',
    '{"timeline": [{"at": "t:1", "action": "spike_load", "rps": "x"}]}',
    '{"timeline": [{"at": "publish:1", "action": "spike_load", "rps": 2}]}',
    '{"timeline": [{"at": "t:1", "action": "spike_load", "rps": 2, '
    '"replica": 0}]}',
    '{"timeline": [{"at": "t:1", "action": "kill_replica", "rps": 2}]}',
    '{"timeline": [{"at": "t:1", "action": "kill_replica_during_wave", '
    '"replica": 1}]}',
]


@pytest.mark.parametrize("text", GOOD_SPECS)
def test_spec_dump_equals_jax(text, tmp_path):
    """Inline and file forms parse to the same canonical dump as JAX's,
    timeline items render alike, and the dump is a fixpoint."""
    path = tmp_path / "spec.json"
    path.write_text(text)
    for arg in (text, str(path)):
        ours, theirs = port_spec.load_spec(arg), jax_spec.load_spec(arg)
        assert ours.to_json() == theirs.to_json()
        assert [str(t) for t in ours.timeline] == \
            [str(t) for t in theirs.timeline]
        assert port_spec.parse_spec(json.loads(ours.to_json())).to_json() \
            == ours.to_json()


@pytest.mark.parametrize("text", BAD_SPECS)
def test_spec_errors_equal_jax(text):
    with pytest.raises(port_spec.SpecError) as ours:
        port_spec.load_spec(text)
    with pytest.raises(jax_spec.SpecError) as theirs:
        jax_spec.load_spec(text)
    assert str(ours.value) == str(theirs.value)


# ----------------------------------------------------- invariant replays --
# tests/test_scenario.py's synthetic timelines: the clean one and each
# mutation that makes one checker fire (or not)


def _clean_timeline():
    E = []

    def mk(ts, kind, src, **kw):
        E.append({"ts": ts, "kind": kind, "source": src, **kw})

    mk(0.0, "scenario_start", "supervisor")
    for r in ("replica0", "replica1"):
        mk(1.0, "serve_ready", r, port=1, epoch=-1)
    mk(5.0, "publish", "trainer.h0", epoch=0, path="c0", digest="D0",
       world_size=2)
    for r in ("replica0", "replica1"):
        mk(6.0, "verify_ok", r, epoch=0, path="c0", digest="D0")
        mk(6.1, "swap", r, epoch=0, digest="D0")
    mk(8.0, "publish", "trainer.h0", epoch=1, path="c1", digest="D1",
       world_size=2)
    mk(8.0, "publish_torn", "trainer.h0", epoch=1, path="c1")
    mk(9.0, "quarantine", "replica0", path="c1", reason="checksum mismatch")
    for i in range(20):
        ts = 3.0 + i
        status = "busy" if i == 7 else "ok"
        if status != "ok":
            kw = {"code": 503}
        elif ts < 6.0:
            kw = {"digest": "fresh", "generation": -1}
        else:
            kw = {"digest": "D0", "generation": 0}
        mk(ts, "request", "loadgen", status=status,
           replica=f"replica{i % 2}", **kw)
    mk(30.0, "lint", "supervisor", rc=0)
    mk(31.0, "scenario_end", "supervisor", ok=True)
    return sorted(E, key=lambda r: r["ts"])


_SPEC = ('{"availability": {"floor": 0.5, "window_s": 10.0, '
         '"min_samples": 3}, "adopt_deadline_s": 20}')
_FLEET_SPEC = ('{"serve": {"replicas": 2, "max_replicas": 3, '
               '"scale_out_deadline_s": 30.0}, "availability": {"floor": '
               '0.5, "window_s": 10.0, "min_samples": 3}, '
               '"adopt_deadline_s": 20}')


def _ev(ts, kind, source, **kw):
    return {"ts": ts, "kind": kind, "source": source, **kw}


def _pub(ts, epoch, path, digest):
    return _ev(ts, "publish", "trainer.h0", epoch=epoch, path=path,
               digest=digest, world_size=1)


def _acq(ts, r):
    return _ev(ts, "drain_token_acquire", f"replica{r}", replica=r,
               digest="D0")


def _rel(ts, r):
    return _ev(ts, "drain_token_release", f"replica{r}", replica=r,
               digest="D0", generation=0)


_SPIKE = _ev(40.0, "spike_load", "supervisor", rps=10.0)
_PUB2 = _pub(25.0, 2, "c2", "D2")
_TORN_REWRITE = [
    _pub(1.0, 1, "c1", "TORN"),
    _ev(1.1, "publish_torn", "trainer.h0", epoch=1, path="c1"),
    _ev(2.0, "quarantine", "replica0", path="c1",
        reason="checksum mismatch"),
    _pub(5.0, 1, "c1", "CLEAN")]
# name -> (events added to the clean timeline, or a function of it; spec)
CASES = {
    "clean": ([], _SPEC),
    "s1_unverified_digest": ([_ev(25.0, "request", "loadgen", status="ok",
                                  replica="replica1", digest="DEVIL",
                                  generation=9)], _SPEC),
    "s1_missing_digest": ([_ev(25.0, "request", "loadgen", status="ok",
                               replica="replica0", digest=None)], _SPEC),
    "s1_verified_late": ([_ev(24.0, "request", "loadgen", status="ok",
                              replica="replica0", digest="LATE"),
                          _ev(26.0, "verify_ok", "replica0", epoch=3,
                              path="c3", digest="LATE")], _SPEC),
    "s2_refused_window": ([_ev(40.0 + i, "request", "loadgen",
                               status="refused", replica="-")
                           for i in range(8)], _SPEC),
    "s2_busy_is_alive": ([_ev(40.0 + i, "request", "loadgen", status="busy",
                              replica="replica0", code=503)
                          for i in range(8)], _SPEC),
    "s2_no_requests": (lambda E: [e for e in E if e["kind"] != "request"],
                       _SPEC),
    "s3_missed_adoption": ([_PUB2], _SPEC),
    "s3_late_adoption": ([_PUB2] + [_ev(55.0, "swap", r, epoch=2,
                                        digest="D2")
                                    for r in ("replica0", "replica1")],
                         _SPEC),
    "s3_late_adoption_rebased": (
        [_PUB2, _ev(50.0, "serve_ready", "replica0", port=1, epoch=2)]
        + [_ev(55.0, "swap", r, epoch=2, digest="D2")
           for r in ("replica0", "replica1")], _SPEC),
    "s3_no_good_publish": (lambda E: [e for e in E if e["kind"] not in (
        "publish", "verify_ok", "swap")], _SPEC),
    "s3_no_serve_ready": (lambda E: [e for e in E
                                     if e["kind"] != "serve_ready"], _SPEC),
    "s3_retired_excused": ([_PUB2, _ev(26.0, "swap", "replica0", epoch=2,
                                       digest="D2"),
                            _ev(30.0, "replica_retire", "supervisor",
                                replica="replica1")], _SPEC),
    "s3_retired_rejoined": ([_PUB2, _ev(26.0, "swap", "replica0", epoch=2,
                                        digest="D2"),
                             _ev(30.0, "replica_retire", "supervisor",
                                 replica="replica1"),
                             _ev(35.0, "serve_ready", "replica1", port=1,
                                 epoch=2)], _SPEC),
    "s3_torn_rewrite_clean": (_TORN_REWRITE, _SPEC),
    "s3_torn_rewrite_requarantined": (
        _TORN_REWRITE + [_ev(6.0, "quarantine", "replica0", path="c1",
                             reason="checksum mismatch")], _SPEC),
    "s4_no_lint": (lambda E: [e for e in E if e["kind"] != "lint"], _SPEC),
    "s4_red_lint": (lambda E: [e for e in E if e["kind"] != "lint"]
                    + [_ev(30.0, "lint", "supervisor", rc=1)], _SPEC),
    "s5_serialized_wave": ([_acq(40.0, 0), _rel(41.0, 0), _acq(42.0, 1),
                            _rel(43.0, 1)], _SPEC),
    "s5_overlapping_drains": ([_acq(40.0, 0), _acq(41.0, 1)], _SPEC),
    "s5_takeover": ([_acq(40.0, 0),
                     _ev(50.0, "drain_token_takeover", "replica1", replica=1,
                         digest="D0"),
                     _acq(50.1, 1), _rel(51.0, 1)], _SPEC),
    "s5_divergence": ([_ev(25.0, "swap", "replica1", epoch=0,
                           digest="DX")], _SPEC),
    "s5_divergence_retired": ([_ev(25.0, "swap", "replica1", epoch=0,
                                   digest="DX"),
                               _ev(26.0, "replica_retire", "supervisor",
                                   replica="replica1")], _SPEC),
    "s5_stale_convergence": ([_ev(25.0, "swap", r, epoch=0, digest="STALE")
                              for r in ("replica0", "replica1")], _SPEC),
    "s5_spike_unarmed": ([_SPIKE], _SPEC),
    "s5_spike_unanswered": ([_SPIKE], _FLEET_SPEC),
    "s5_spike_late": ([_SPIKE, _ev(75.0, "scale_out", "supervisor",
                                   replica="replica2", replicas=3)],
                      _FLEET_SPEC),
    "s5_spike_answered": ([_SPIKE, _ev(55.0, "scale_out", "supervisor",
                                       replica="replica2", replicas=3)],
                          _FLEET_SPEC),
    "s5_spike_at_max": ([_ev(30.0, "scale_out", "supervisor",
                             replica="replica2", replicas=3), _SPIKE],
                        _FLEET_SPEC),
    "s5_spike_after_scale_in": ([_ev(30.0, "scale_out", "supervisor",
                                     replica="replica2", replicas=3),
                                 _ev(35.0, "scale_in", "supervisor",
                                     replica="replica2", replicas=2),
                                 _SPIKE], _FLEET_SPEC),
}


def _timeline(name):
    change, spec = CASES[name]
    E = _clean_timeline()
    E = change(E) if callable(change) else E + [dict(e) for e in change]
    return sorted(E, key=lambda r: r["ts"]), spec


def _checks(mod, spec_mod, events, spec_text):
    spec = spec_mod.load_spec(spec_text)
    return {
        "s1": [str(v) for v in mod.check_s1_verified_serve(events)],
        "s2": [str(v) for v in mod.check_s2_availability(events, spec)],
        "s3": [str(v) for v in mod.check_s3_adoption(events, spec)],
        "s4": [str(v) for v in mod.check_s4_analyzer(events)],
        "s5": [str(v) for v in mod.check_s5_fleet(events, spec)],
        "all": [str(v) for v in mod.check_invariants(events, spec)],
        "no_lint": [str(v) for v in mod.check_invariants(
            events, spec, require_lint=False)],
        "goods": mod.good_publishes(events),
        "retired": mod.replica_retire_times(events),
    }


@pytest.mark.parametrize("name", sorted(CASES))
def test_invariants_equal_jax(name):
    events, spec_text = _timeline(name)
    ours = _checks(inv, port_spec, events, spec_text)
    assert ours == _checks(jax_inv, jax_spec, events, spec_text)
    # the cases are what the JAX suite says they are: the clean ones green
    green = name in ("clean", "s2_busy_is_alive",
                     "s3_retired_excused", "s3_torn_rewrite_requarantined",
                     "s5_serialized_wave",
                     "s5_takeover", "s5_divergence_retired",
                     "s5_spike_unarmed", "s5_spike_answered",
                     "s5_spike_at_max")
    assert (ours["all"] == []) == green, ours["all"]


def _restart_lines(tmp_path, monkeypatch, rcs, membership=None):
    """The port's `cli/supervise.py` writing restarts.log over a stub
    `subprocess.run` that returns `rcs` in turn (no process starts)."""
    out = str(tmp_path / "run")
    if membership:
        os.makedirs(os.path.join(out, "fleet"))
        with open(os.path.join(out, "fleet", "membership"), "w") as f:
            f.write(membership + "\n")
    it = iter(rcs)

    class Done:
        def __init__(self, rc):
            self.returncode = rc

    monkeypatch.setattr(supervise.subprocess, "run",
                        lambda *a, **k: Done(next(it)))
    rc = supervise.supervise(["baseline", "--out", out], command=["stub"],
                             env={"MAX_RESTARTS": "8", "FLEET_HOST_ID": "0"},
                             sleep=lambda s: None)
    return rc, os.path.join(out, "restarts.log")


@pytest.mark.parametrize("rcs,membership", [
    ([11, 1, -9, 0], "gen=3 world=0,1"),
    ([7, 143, 0], None),
    ([2], "gen=1 world=0"),
])
def test_restarts_log_from_the_port_supervisor(tmp_path, monkeypatch, rcs,
                                               membership):
    """The lines `cli/supervise.py` writes pass both packages'
    `check_restarts_log`; with gen=/world= cut out both flag each line
    with the same words."""
    rc, path = _restart_lines(tmp_path, monkeypatch, rcs, membership)
    assert rc == (rcs[-1] if rcs[-1] in (0, 2) else rc)
    assert inv.check_restarts_log(path) == []
    assert jax_inv.check_restarts_log(path) == []
    with open(path) as f:
        lines = f.read().splitlines()
    assert len(lines) == len(rcs)
    bad = tmp_path / "bad.log"
    bad.write_text("".join(
        " ".join(t for t in ln.split() if not t.startswith(("gen=", "world=")))
        + "\n" for ln in lines))
    ours = [str(v) for v in inv.check_restarts_log(str(bad))]
    assert ours == [str(v) for v in jax_inv.check_restarts_log(str(bad))]
    assert len(ours) == len(rcs)
    missing = str(tmp_path / "absent.log")
    assert [str(v) for v in inv.check_restarts_log(missing)] == \
        [str(v) for v in jax_inv.check_restarts_log(missing)]


# ------------------------------------------------------------------- CLI --


def _corpus():
    return sorted(os.listdir(CORPUS))


@pytest.mark.parametrize("name", _corpus())
def test_corpus_replays_with_its_expected_rc(name, capsys):
    d = os.path.join(CORPUS, name)
    with open(os.path.join(d, "expect")) as f:
        want = int(f.read().strip())
    argv = ["--scenario_spec", os.path.join(d, "spec.json"),
            "--events", os.path.join(d, "events.jsonl"),
            "--check_only", "--out", d]
    if want == 0:
        scenario_cli.main(argv)
        assert "GREEN" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit) as exc:
            scenario_cli.main(argv)
        assert exc.value.code == want


def test_cli_check_only_green_red_and_malformed(tmp_path, capsys):
    ev_path = tmp_path / "events.jsonl"

    def write(extra):
        with open(ev_path, "w") as f:
            for r in _clean_timeline() + extra:
                f.write(json.dumps(r) + "\n")

    argv = ["--scenario_spec", _SPEC, "--check_only", "--events",
            str(ev_path), "--out", str(tmp_path)]
    write([])
    scenario_cli.main(argv)
    assert "GREEN" in capsys.readouterr().out
    for extra, rc, words in (
            ([_ev(25.0, "request", "loadgen", status="ok",
                  replica="replica0", digest="BAD")], 1, "VIOLATION [S1]"),
            ([_ev(25.0, "warp_core_breach", "x")], 2, "unknown kind"),
            ([_ev(25.0, "publish", "trainer.h0", epoch=3, path="c3")], 2,
             "missing required field")):
        write(extra)
        with pytest.raises(SystemExit) as exc:
            scenario_cli.main(argv)
        assert exc.value.code == rc
        assert words in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        scenario_cli.main(["--scenario_spec", '{"bogus": 1}',
                           "--check_only"])
    assert exc.value.code == 2
    assert "spec error" in capsys.readouterr().err


def test_cli_without_a_card_names_the_device_and_starts_nothing(
        tmp_path, monkeypatch, capsys):
    """No CUDA device and no `--device cpu`: rc 3 naming the device, before
    any child, event or run dir exists."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "run"
    with pytest.raises(SystemExit) as exc:
        scenario_cli.main(["--scenario_spec", json.dumps(_CARD),
                           "--out", str(out)])
    assert exc.value.code == 3
    err = capsys.readouterr().err
    assert "--device cuda" in err and "CUDA is not available" in err
    assert not out.exists()
    assert scenario_cli.build_parser().parse_args(
        ["--scenario_spec", "{}"]).device == "cuda"


# ------------------------------------------------------------ supervisor --


def _strip_module(cmd, module):
    assert cmd[:3] == [sys.executable, "-m", module], cmd[:3]
    return cmd[3:]


@pytest.mark.parametrize("text", [json.dumps(_CARD), "{}"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_child_command_lines_parse_under_the_port_clis(text, device,
                                                       tmp_path, monkeypatch):
    """The trainer's and the replicas' command lines are the port's CLIs'
    (their own parsers and config checks take them), carry `--device`,
    and their environments hold no JAX variable; every knob of the JAX
    supervisor's environment stays."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    spec = port_spec.load_spec(text)
    s = sup.ScenarioSupervisor(spec, str(tmp_path), device=device)
    s.coord_port = 1234
    argv = _strip_module(s._trainer_cmd(), f"{PORT}.cli.supervise")
    targs = train_cli.build_parser().parse_args(argv)
    cfg = train_cli.config_from_args(targs)
    assert targs.device == device and targs.out == str(tmp_path)
    assert (cfg.model.arch, cfg.data.image_size, cfg.data.num_classes,
            cfg.data.batch_size, cfg.run.epochs) == (
        spec.trainer.model, spec.trainer.image_size,
        spec.trainer.num_classes, spec.trainer.batchsize,
        spec.trainer.epochs)
    assert targs.multihost == (spec.trainer.hosts > 1)
    rep = sup._Replica(1, 4321)
    argv = _strip_module(s._replica_cmd(rep), f"{PORT}.cli.serve")
    sargs = serve_cli.build_parser().parse_args(argv)
    scfg = serve_cli.config_from_args(sargs)
    assert sargs.device == device
    assert (scfg.serve.port, scfg.serve.watch_dir, scfg.serve.fleet_dir,
            scfg.serve.fleet_replica) == (4321, str(tmp_path),
                                          str(tmp_path), 1)
    assert scfg.model.arch == spec.trainer.model

    # the environments: the JAX supervisor's minus JAX's variables
    jsup = jax_sup.ScenarioSupervisor(jax_spec.load_spec(text),
                                      str(tmp_path / "jax"))
    jsup.coord_port = 1234
    for ours, theirs in ((s._trainer_env(0), jsup._trainer_env(0)),
                         (s._replica_env(1), jsup._replica_env(1))):
        assert not [k for k in ours if k.startswith(("JAX_", "XLA_"))]
        assert {k: v for k, v in theirs.items()
                if not k.startswith(("JAX_", "XLA_", "SCENARIO_"))} == {
            k: v for k, v in ours.items() if not k.startswith("SCENARIO_")}
    with pytest.raises(ValueError):
        sup.ScenarioSupervisor(spec, str(tmp_path), device="tpu")


@pytest.mark.parametrize("size", [16, 224])
def test_payload_decodes_to_the_jax_pixels(size, tmp_path):
    """The zlib PNG decodes through the port's `decode_image` to the array
    from which JAX's `_make_payload` builds its PNG, bitwise."""
    from PIL import Image
    import io

    from ddp_classification_pytorch_tpu_torch.serve.http import decode_image

    spec = {"trainer": {"image_size": size}}
    ours = sup.ScenarioSupervisor(port_spec.parse_spec(spec),
                                  str(tmp_path), device="cpu")._make_payload()
    theirs = jax_sup.ScenarioSupervisor(jax_spec.parse_spec(spec),
                                        str(tmp_path))._make_payload()
    want = np.asarray(Image.open(io.BytesIO(theirs)).convert("RGB"))
    got = decode_image(ours)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    assert np.array_equal(got, want)
    assert np.array_equal(want, sup.payload_pixels(size))


def test_banner_devices_and_the_device_check(tmp_path):
    text = ("[fleet] rendezvous ok\n"
            "[trainer] workload=baseline arch=tresnet_m params=1 "
            "device=cuda:0 world=1 ddp=off\n"
            "[serve] arch=tresnet_m classes=2173 topk=5 device=cpu\n")
    assert sup.banner_devices(text) == [("trainer", "cuda"), ("serve", "cpu")]
    s = sup.ScenarioSupervisor(port_spec.load_spec(
        '{"trainer": {"hosts": 1}, "serve": {"replicas": 1}}'),
        str(tmp_path), device="cuda")
    s.hosts, s.replicas = [sup._Host(0)], [sup._Replica(0, 1)]
    (tmp_path / "host0.log").write_text(text.splitlines()[1] + "\n")
    (tmp_path / "replica0.log").write_text(text.splitlines()[2] + "\n")
    s._check_devices(aborted=False)
    assert len(s.failures) == 1 and "replica0.log" in s.failures[0] \
        and "cpu" in s.failures[0]
    (tmp_path / "replica0.log").write_text("[serve] warm\n")
    s.failures = []
    s._check_devices(aborted=False)
    assert s.failures and "serve banner" in s.failures[0]
    s.failures = []
    s._check_devices(aborted=True)
    assert s.failures == []


# ------------------------------------------------------------------ lint --

LINT_FIXTURES = [
    "import sys\nsys.exit(13)\n",
    "raise SystemExit(99)\n",
    "import sys\nsys.exit(compute_rc())\n",
    "import os\nos._exit(255)\n",
    "raise SystemExit('bad')\n",
    "raise SystemExit(True)\n",
    "raise SystemExit(0 if ok else 12)\n",
    "import sys\nsys.exit(2)\nraise SystemExit(0 if ok else 1)\n"
    "raise SystemExit(SentinelDiverged.exit_code)\nraise SystemExit(e.code)\n"
    "raise SystemExit()\n",
]


@pytest.mark.parametrize("src", LINT_FIXTURES)
def test_lint_rc_source_equals_jax(src):
    ours = [(f.check, f.where, f.message, str(f))
            for f in lint.lint_rc_source(src, "fx.py")]
    assert ours == [(f.check, f.where, f.message, str(f))
                    for f in jax_lint.lint_rc_source(src, "fx.py")]
    assert lint.RC_CATALOGUE == jax_lint.RC_CATALOGUE


def test_port_cli_lints_clean(tmp_path, capsys):
    assert lint.lint_rc_sites() == []
    with pytest.raises(SystemExit) as exc:
        lint.main()
    assert exc.value.code == 0
    assert "rc-catalogue: 0 finding(s)" in capsys.readouterr().out
    bad = tmp_path / "bad.py"
    bad.write_text("import sys\nsys.exit(13)\n")
    assert [(f.check, f.where) for f in lint.lint_rc_sites([str(bad)])] == \
        [("rc-catalogue", "bad.py:2")]
    names = {os.path.basename(p) for p in os.listdir(
        os.path.join(REPO, PORT, "cli"))}
    assert {"scenario.py", "fuzz.py", "supervise.py"} <= names


def test_events_of_the_card_spec_validate(tmp_path):
    """The supervisor's own records fit the schema the replays hold it
    to (one of each kind it writes)."""
    s = sup.ScenarioSupervisor(port_spec.load_spec(json.dumps(_CARD)),
                               str(tmp_path), device="cpu")
    s.log.emit("scenario_start", out=str(tmp_path), hosts=1, replicas=2)
    s.log.emit("replica_start", replica="replica0", port=1)
    s.log.emit("host_lost_observed", host=0, rc=-9)
    s.log.emit("host_relaunch", host=0)
    s.log.emit("timeline", action=str(s.spec.timeline[0]))
    s.log.emit("spike_load", rps=12.0)
    s.log.emit("scale_out", replica="replica2", replicas=3)
    s.log.emit("lint", rc=0)
    from ddp_classification_pytorch_tpu_torch.obs.events import read_events

    events = read_events(s.events_path)
    assert len(events) == 8 and validate_events(events) == []


def test_lost_host_relaunch_waits_for_survivors_only(tmp_path, monkeypatch):
    """A lost host comes back once the survivors re-formed without it (the
    JAX supervisor's rule); a pod of one has no survivor and comes back at
    once."""
    launched = []

    def make(hosts):
        s = sup.ScenarioSupervisor(port_spec.load_spec(json.dumps(
            {"trainer": {"hosts": hosts}})), str(tmp_path / str(hosts)),
            device="cpu")
        s.hosts = [sup._Host(i) for i in range(hosts)]
        monkeypatch.setattr(s, "_launch_host",
                            lambda h: launched.append((hosts, h.index)))
        return s

    one = make(1)
    one.hosts[0].state = "lost_waiting"
    one._poll_hosts()
    assert launched == [(1, 0)] and one.hosts[0].relaunched

    two = make(2)
    two.hosts[0].state = "running"
    two.hosts[0].proc = type("P", (), {"poll": lambda self: None})()
    two.hosts[1].state = "lost_waiting"
    fleet = os.path.join(two.out_dir, "fleet")
    os.makedirs(fleet)
    with open(os.path.join(fleet, "membership"), "w") as f:
        f.write("gen=1 world=0,1\n")
    two._poll_hosts()
    assert launched == [(1, 0)]  # the survivor has not re-formed yet
    with open(os.path.join(fleet, "membership"), "w") as f:
        f.write("gen=2 world=0\n")
    two._poll_hosts()
    assert launched == [(1, 0), (2, 1)]
    from ddp_classification_pytorch_tpu_torch.obs.events import read_events

    assert [e["host"] for e in read_events(two.events_path)
            if e["kind"] == "host_relaunch"] == [1]


def test_timeline_report_reads_the_numbers_back():
    from ddp_classification_pytorch_tpu_torch.scenario.report import (
        nearest_rank, timeline_report)

    E = _clean_timeline()
    E += [_ev(3.5 + i, "request", "loadgen", status="ok", replica="replica0",
              digest="D0", latency_ms=float(10 * (i + 1))) for i in range(10)]
    E += [_ev(20.0, "spike_load", "supervisor", rps=12.0),
          _ev(21.5, "scale_out", "supervisor", replica="replica2",
              replicas=3),
          _ev(24.0, "replica_stop", "supervisor", replica="replica1", rc=-9,
              deliberate=True),
          _ev(25.0, "host_lost_observed", "supervisor", host=0, rc=-9),
          _ev(22.5, "request", "loadgen", status="refused", replica="-")]
    E.sort(key=lambda r: r["ts"])
    rep = timeline_report(E, port_spec.load_spec(_SPEC))
    # swaps at 6.1 s of a publish at 5.0 s
    assert rep["adoption_s"] == [{"epoch": 0, "at_s": 5.0, "digest": "D0",
                                  "replicas": {"replica0": 6.1 - 5.0,
                                               "replica1": 6.1 - 5.0}}]
    ms = [float(10 * (i + 1)) for i in range(10)]
    assert rep["request_ms"]["p50"] == nearest_rank(ms, 0.5) == 50.0
    assert rep["request_ms"]["p99"] == 100.0
    assert rep["request_ms"]["statuses"] == {"busy": 1, "ok": 29,
                                             "refused": 1}
    assert rep["spike_to_scale_out_s"] == [
        {"at_s": 20.0, "rps": 12.0, "to_scale_out_s": 1.5}]
    assert rep["replica_stops"][0]["rc"] == -9
    assert rep["host_lost"] == [{"host": 0, "rc": -9, "at_s": 25.0}]
    low = rep["min_availability"]
    assert low["ratio"] == low["alive"] / low["requests"] < 1.0
    assert low["start"] <= 22.5 < low["end"]
    assert inv.check_s2_availability(E, port_spec.load_spec(_SPEC)) == []


def test_final_stop_waits_for_adoption_and_for_a_replica_still_starting():
    """The final drain waits for every replica to swap to the newest good
    publish and to be serving: a replica relaunched late adopts it in its
    start-up restore, before its drain handler exists."""
    E = _clean_timeline() + [
        _ev(0.5, "replica_start", "supervisor", replica="replica0", port=1),
        _ev(0.5, "replica_start", "supervisor", replica="replica1", port=2)]
    want = {"replica0", "replica1"}
    E.sort(key=lambda r: r["ts"])
    assert sup.final_adoption_pending(E, want) == set()
    assert sup.final_adoption_pending(E, want | {"replica2"}) == {"replica2"}
    # replica0 killed and relaunched: its restore swaps, it is not ready
    E += [_ev(40.0, "replica_start", "supervisor", replica="replica0",
              port=1),
          _ev(45.0, "swap", "replica0", epoch=0, digest="D0")]
    assert sup.final_adoption_pending(E, want) == {"replica0"}
    E.append(_ev(46.0, "serve_ready", "replica0", port=1, epoch=0))
    assert sup.final_adoption_pending(E, want) == set()
    assert sup.final_adoption_pending(
        [e for e in E if e["kind"] != "publish"], want) == set()
