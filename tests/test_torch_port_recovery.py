"""The port's recovery chain on the CPU: the pod fleet (`parallel/fleet.py`)
against the JAX package's, the loader, checkpoint and watcher faults, the
hang watchdog, the supervisor (`cli/supervise.py`) against
`scripts/supervise.sh`, and the train CLI's new flags.

Parity is exact — equal bytes, dicts, files, schedules and exit codes —
with the JAX side's pure-Python `parallel/fleet.py` imported as it is.
Pods are simulated in one process by stubbing the collectives
(`_process_index`, `_process_count`, `_broadcast_host`,
`_allgather_host`), as `tests/test_fleet.py` does; the real two-rank run
(gloo) is in `tests/test_torch_port_ddp.py`. No JAX trainer runs.
"""

import errno
import os
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.parallel import fleet as jax_fleet
from ddp_classification_pytorch_tpu.parallel.mesh import MeshSpec
from ddp_classification_pytorch_tpu_torch.cli import supervise
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.data.loader import Loader
from ddp_classification_pytorch_tpu_torch.parallel import fleet
from ddp_classification_pytorch_tpu_torch.serve.reload import CheckpointWatcher
from ddp_classification_pytorch_tpu_torch.train import checkpoint
from ddp_classification_pytorch_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
from ddp_classification_pytorch_tpu_torch.utils import chaos
from ddp_classification_pytorch_tpu_torch.utils.backend_probe import (
    StepHeartbeat,
)
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_chaos_env(monkeypatch):
    for k in ("CHAOS_FAULT_SPEC", "CHAOS_STATE_DIR", "CHAOS_HOST",
              "FLEET_ELASTIC", "FLEET_COORDINATOR", "FLEET_NUM_PROCESSES",
              "FLEET_PROCESS_ID", "FLEET_HOST_ID", "SCENARIO_EVENTS"):
        monkeypatch.delenv(k, raising=False)


class _State:
    """A train state's protocol (state_dict / load_state_dict) over one
    tensor: a checkpoint of a few hundred bytes."""

    def __init__(self, v: float):
        self.w = torch.full((4,), float(v))

    def state_dict(self):
        return {"w": self.w.clone()}

    def load_state_dict(self, sd):
        self.w = sd["w"].clone()


def _pod(monkeypatch, index, count=2):
    monkeypatch.setattr(fleet, "_process_index", lambda: index)
    monkeypatch.setattr(fleet, "_process_count", lambda: count)


def _torn_run(tmp_path, name="run"):
    """ckpt_e0 (w=0) and ckpt_e1 (w=1), the latter torn by ckpt_io."""
    out = str(tmp_path / name)
    mgr = CheckpointManager(out, chaos=chaos.FaultPlan.parse("ckpt_io@epoch=1"))
    for e in (0, 1):
        mgr.save(_State(e), e)
    return out


# ------------------------------------------------------------ the wire --

@pytest.mark.parametrize("choice", [(1, 3, "ckpt_e2.pt", "ab" * 32),
                                    (0, 0, "", ""),
                                    (1, 7, "ckpt_best.pt", "0" * 64),
                                    (1, 1, "é" * 200, "f" * 64)])
def test_pack_choice_is_jax_s_wire(choice):
    buf = fleet.pack_choice(*choice)
    assert buf.dtype == np.uint8 and buf.tobytes() == jax_fleet.pack_choice(
        *choice).tobytes()
    assert fleet.unpack_choice(buf) == jax_fleet.unpack_choice(buf)
    if choice[2].isascii():
        assert fleet.unpack_choice(buf) == choice
    assert (fleet.FLAGS_BYTES, fleet.NAME_BYTES, fleet.DIGEST_BYTES,
            fleet.WIRE_BYTES) == (jax_fleet.FLAGS_BYTES, jax_fleet.NAME_BYTES,
                                  jax_fleet.DIGEST_BYTES, jax_fleet.WIRE_BYTES)


@pytest.mark.parametrize("args", [(5, 5.0, 60.0), (1, 5.0, 60.0),
                                  (8, 0.5, 3.0), (0, 1.0, 1.0)])
def test_backoff_schedule_matches_jax(args):
    assert fleet.backoff_schedule(*args) == jax_fleet.backoff_schedule(*args)


ENVS = [
    {},
    {"FLEET_COORDINATOR": "10.0.0.1:1234", "FLEET_NUM_PROCESSES": "2",
     "FLEET_PROCESS_ID": "1"},
    {"FLEET_COORDINATOR": "h:1", "FLEET_NUM_PROCESSES": "4",
     "FLEET_PROCESS_ID": "0", "FLEET_HOST_ID": "7", "FLEET_MIN_PROCESSES": "2",
     "FLEET_COORDINATOR_SELF": "h2:5", "FLEET_RENDEZVOUS_ATTEMPTS": "3",
     "FLEET_RENDEZVOUS_BACKOFF_S": "0.5", "FLEET_RENDEZVOUS_TIMEOUT_S": "9",
     "FLEET_LEASE_TTL_S": "30", "FLEET_LEASE_SETTLE_S": "0"},
    {"FLEET_NUM_PROCESSES": "x"},
    {"FLEET_COORDINATOR": "nohostport", "FLEET_NUM_PROCESSES": "2",
     "FLEET_PROCESS_ID": "0"},
    {"FLEET_COORDINATOR": "h:1"},
    {"FLEET_NUM_PROCESSES": "0"},
    {"FLEET_NUM_PROCESSES": "2", "FLEET_PROCESS_ID": "2"},
    {"FLEET_HOST_ID": "-1"},
    {"FLEET_RENDEZVOUS_BACKOFF_S": "soon"},
    {"FLEET_COORDINATOR": "h:p", "FLEET_NUM_PROCESSES": "1",
     "FLEET_PROCESS_ID": "0"},
]


def _validated(mod, env):
    try:
        return mod.validate_fleet_env(env)
    except mod.FleetConfigError as e:
        return ("FleetConfigError", e.exit_code, str(e))


@pytest.mark.parametrize("env", ENVS)
def test_validate_fleet_env_matches_jax(env):
    port, ref = _validated(fleet, env), _validated(jax_fleet, env)
    if isinstance(ref, dict):  # the port drives one card a process
        ref.pop("local_devices")
    assert port == ref
    assert fleet.elastic_enabled(dict(env, FLEET_ELASTIC="1")) == \
        jax_fleet.elastic_enabled(dict(env, FLEET_ELASTIC="1"))


def test_leases_and_membership_cross_read(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    fleet.write_lease(a, 3, generation=2, coordinator="h:1")
    jax_fleet.write_lease(a, 0, generation=2, coordinator="")
    jax_fleet.write_lease(b, 1, generation=5, coordinator="x:9")
    fleet.write_lease(b, 4)
    for d in (a, b):
        assert fleet.scan_leases(d, ttl_s=60) == jax_fleet.scan_leases(
            d, ttl_s=60)
    assert jax_fleet.scan_leases(a, ttl_s=60) == {3: "h:1", 0: ""}
    assert fleet.scan_leases(a, ttl_s=60, now=os.stat(
        fleet.lease_path(a, 3)).st_mtime + 61) == {}
    for world in ([0], [0, 2], [5, 1, 3]):
        assert fleet.membership_line(4, world) == jax_fleet.membership_line(
            4, world)
        assert fleet.membership_digest(world) == jax_fleet.membership_digest(
            world)
    fleet.write_membership(a, 6, [0, 2])
    assert jax_fleet.read_membership(a) == fleet.read_membership(a) == (6, [0, 2])
    jax_fleet.write_membership(b, 1, [1])
    assert fleet.read_membership(b) == (1, [1])
    assert fleet.advance_generation(fleet.generation_path(a), 3) == 3
    assert jax_fleet.read_generation(fleet.generation_path(a)) == 3


@pytest.mark.parametrize("world,min_p,dp", [
    ([0], 1, 0), ([0, 1], 3, 0), ([0, 2], 2, 2), ([0, 1, 2], 1, 2),
    ([1], 1, 1), ([], 1, 0), ([0, 1], 1, 4)])
def test_check_viable_matches_jax_s_mesh_test(world, min_p, dp):
    def verdict(fn):
        try:
            fn()
        except (fleet.PodUnviable, jax_fleet.PodUnviable) as e:
            return e.exit_code
        return 0

    assert verdict(lambda: fleet.check_viable(
        world, min_processes=min_p, data_parallel=dp)) == verdict(
        lambda: jax_fleet.check_viable(world, min_processes=min_p,
                                       mesh_spec=MeshSpec(dp, 1, 1)))


# ---------------------------------------------------------- consensus --

def test_consensus_picks_the_previous_file_when_the_latest_is_torn(
        tmp_path, monkeypatch):
    out = _torn_run(tmp_path)
    sent = {}
    _pod(monkeypatch, 0)
    monkeypatch.setattr(fleet, "_broadcast_host",
                        lambda p: sent.setdefault("choice", p))
    monkeypatch.setattr(fleet, "_allgather_host", lambda x: np.stack([x, x]))
    state, nxt = fleet.consensus_restore_latest(CheckpointManager(out),
                                                _State(-1))
    assert nxt == 1 and torch.equal(state.w, torch.zeros(4))
    assert os.path.exists(os.path.join(out, "ckpt_e1.pt.corrupt"))
    found, epoch, name, digest = fleet.unpack_choice(sent["choice"])
    assert (found, epoch, name) == (1, 1, "ckpt_e0.pt")
    assert digest == checkpoint.file_digest(os.path.join(out, "ckpt_e0.pt"))
    # a follower restores exactly that file and never quarantines
    _pod(monkeypatch, 1)
    monkeypatch.setattr(fleet, "_broadcast_host", lambda p: sent["choice"])
    before = sorted(os.listdir(out))
    state, nxt = fleet.consensus_restore_latest(CheckpointManager(out),
                                                _State(-1))
    assert nxt == 1 and torch.equal(state.w, torch.zeros(4))
    assert sorted(os.listdir(out)) == before


def test_consensus_digest_mismatch_is_pod_inconsistent(tmp_path, monkeypatch):
    out = _torn_run(tmp_path)
    _pod(monkeypatch, 0)
    monkeypatch.setattr(fleet, "_broadcast_host", lambda p: p)
    monkeypatch.setattr(fleet, "_allgather_host",
                        lambda x: np.stack([x, np.zeros_like(x)]))
    with pytest.raises(fleet.PodInconsistent) as e:
        fleet.consensus_restore_latest(CheckpointManager(out), _State(-1))
    assert e.value.exit_code == jax_fleet.PodInconsistent.exit_code == 9
    # a follower whose copy differs contributes a zero digest
    _pod(monkeypatch, 1)
    choice = fleet.pack_choice(1, 1, "ckpt_e0.pt", "0" * 64)
    monkeypatch.setattr(fleet, "_broadcast_host", lambda p: choice)
    monkeypatch.setattr(fleet, "_allgather_host", lambda x: np.stack(
        [fleet._encode_fixed("0" * 64, fleet.DIGEST_BYTES), x]))
    with pytest.raises(fleet.PodInconsistent):
        fleet.consensus_restore_latest(CheckpointManager(out), _State(-1))


def test_consensus_never_picks_a_file_without_its_sidecar(tmp_path,
                                                          monkeypatch):
    """ROADMAP.md §3: the JAX manager restores a sidecar-less file as
    "legacy"; the port's consensus quarantines it and takes the next."""
    out = str(tmp_path / "run")
    mgr = CheckpointManager(out)
    for e in (0, 1):
        mgr.save(_State(e), e)
    os.remove(checkpoint.checksum_path(os.path.join(out, "ckpt_e1.pt")))
    sent = {}
    _pod(monkeypatch, 0)
    monkeypatch.setattr(fleet, "_broadcast_host",
                        lambda p: sent.setdefault("choice", p))
    monkeypatch.setattr(fleet, "_allgather_host", lambda x: np.stack([x, x]))
    state, nxt = fleet.consensus_restore_latest(CheckpointManager(out),
                                                _State(-1))
    assert fleet.unpack_choice(sent["choice"])[:3] == (1, 1, "ckpt_e0.pt")
    assert nxt == 1 and torch.equal(state.w, torch.zeros(4))


def test_consensus_single_process_touches_no_collective(tmp_path,
                                                        monkeypatch):
    out = _torn_run(tmp_path)
    _pod(monkeypatch, 0, count=1)
    monkeypatch.setattr(fleet, "_broadcast_host",
                        lambda p: pytest.fail("collective at world 1"))
    monkeypatch.setattr(fleet, "_allgather_host",
                        lambda x: pytest.fail("collective at world 1"))
    _, nxt = fleet.consensus_restore_latest(CheckpointManager(out), _State(-1))
    assert nxt == 1


# ----------------------------------------------------- abort, rendezvous --

@pytest.mark.parametrize("rows", [[[0, 0], [143, 0]], [[8, 0], [143, 0]],
                                  [[8, 0], [8, 0], [0, 0]], [[0, 0], [0, 1]],
                                  [[0, 0], [0, 0]]])
def test_abort_exchange_raises_jax_s_code_and_origin(monkeypatch, rows):
    gathered = np.asarray(rows, np.int32)[:, None, :]
    outcomes = []
    for mod in (fleet, jax_fleet):
        monkeypatch.setattr(mod, "_allgather_host", lambda x: gathered)
        coord = mod.FleetCoordinator(process_index=0,
                                     process_count=len(rows))
        coord.note_abort(int(rows[0][0]), "why")
        coord.note_abort(99, "later intents lose")
        try:
            coord.check()
            outcomes.append(None)
        except mod.PodAbort as e:
            outcomes.append((e.code, e.origin, e.local_code, str(e)))
        except mod.PodReform as e:  # a member flagged a membership change
            outcomes.append((e.exit_code, str(e)))
    assert outcomes[0] == outcomes[1]
    want = max(r[0] for r in rows) or max(r[1] for r in rows) * 11
    assert (outcomes[0] or (0,))[0] == want


def test_rendezvous_failure_sleeps_jax_s_schedule_then_rc6(tmp_path):
    env = {"FLEET_COORDINATOR": "127.0.0.1:1", "FLEET_NUM_PROCESSES": "2",
           "FLEET_PROCESS_ID": "1", "FLEET_RENDEZVOUS_ATTEMPTS": "4",
           "FLEET_RENDEZVOUS_BACKOFF_S": "1.5"}
    runs = []
    for mod in (fleet, jax_fleet):
        calls, sleeps = [], []

        def fail(c, n, p):
            calls.append((c, n, p))
            raise ConnectionRefusedError("peer down")

        with pytest.raises(mod.RendezvousFailed) as e:
            mod.initialize_with_retry(str(tmp_path), initialize=fail,
                                      sleep=sleeps.append, env=env)
        runs.append((calls, sleeps, e.value.exit_code))
    assert runs[0] == runs[1]
    assert runs[0][1] == [1.5, 3.0, 6.0] and runs[0][2] == 6
    with pytest.raises(fleet.FleetConfigError) as e:  # rc 2, no retries
        fleet.initialize_with_retry(env={})
    assert e.value.exit_code == 2


def test_elastic_rendezvous_writes_jax_s_files(tmp_path, monkeypatch):
    env = {"FLEET_COORDINATOR": "127.0.0.1:9", "FLEET_NUM_PROCESSES": "1",
           "FLEET_PROCESS_ID": "0", "FLEET_ELASTIC": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = []
    for mod, d in ((fleet, tmp_path / "p"), (jax_fleet, tmp_path / "j")):
        monkeypatch.setattr(mod, "_CURRENT_MEMBERSHIP", None)
        mod.advance_generation(mod.generation_path(str(d)), 2)
        calls = []
        gen = mod.initialize_with_retry(
            str(d), initialize=lambda *a: calls.append(a), sleep=None,
            env=env)
        with open(mod.lease_path(str(d), 0)) as f:
            lease = f.read()
        seen.append((gen, calls, lease, mod.read_membership(str(d)),
                     sorted(os.listdir(mod.fleet_dir(str(d))))))
        coord = mod.FleetCoordinator(out_dir=str(d))
        assert coord.elastic and coord.membership == (2, (0,))
        coord.check()  # the world still matches its leases: no reform
    assert seen[0] == seen[1]
    assert seen[0][:2] == (2, [("127.0.0.1:9", 1, 0)])


# --------------------------------------------- loader, ckpt and watcher --

class _Items:
    def __len__(self):
        return 12

    def __getitem__(self, i, rng=None):
        return np.full((2, 2, 3), i, np.uint8), i % 3


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_io_fires_once(tmp_path, workers):
    plan = chaos.FaultPlan.parse("loader_io@batch=2", state_dir=str(tmp_path))
    loader = Loader(_Items(), 3, shuffle=False, num_workers=workers,
                    chaos=plan)
    with pytest.raises(IOError, match="loader_io@batch=2"):
        list(loader)
    assert len(list(loader)) == 4  # the one shot is spent
    again = Loader(_Items(), 3, shuffle=False, chaos=chaos.FaultPlan.parse(
        "loader_io@batch=2", state_dir=str(tmp_path)))
    assert len(list(again)) == 4  # and stays spent across a restart
    loader.close()


def test_ckpt_io_is_quarantined_on_auto_resume(tmp_path, monkeypatch):
    events = tmp_path / "events.jsonl"
    monkeypatch.setenv("SCENARIO_EVENTS", str(events))
    out = _torn_run(tmp_path)
    torn = os.path.join(out, "ckpt_e1.pt")
    assert checkpoint.verify(torn) is not None
    assert checkpoint.verify(os.path.join(out, "ckpt_e0.pt")) is None
    kinds = [line.split('"kind": "')[1].split('"')[0]
             for line in events.read_text().splitlines()]
    assert kinds == ["publish", "publish", "publish_torn"]
    state, nxt = CheckpointManager(out).restore_latest(_State(-1))
    assert nxt == 1 and torch.equal(state.w, torch.zeros(4))
    assert os.path.exists(torn + ".corrupt") and not os.path.exists(torn)


class _Engine:
    params_digest, params_generation, device = "", -1, "cpu"

    def __init__(self):
        self.swaps = []

    def swap_state(self, model, digest, generation):
        self.swaps.append(generation)


def test_watcher_io_backs_off_and_rearms(tmp_path):
    run = str(tmp_path / "run")
    CheckpointManager(run).save(_State(0), 0)
    engine = _Engine()
    watcher = CheckpointWatcher(
        run, engine, lambda sd: sd, poll_s=0.5, max_backoff_s=4.0,
        chaos=chaos.FaultPlan.parse("watcher_io@poll=2"))
    assert watcher.poll_once() == 0.5 and engine.swaps == [0]
    CheckpointManager(run).save(_State(1), 1)
    assert watcher.poll_once() == 1.0  # poll 2: EIO, backed off
    assert watcher.consecutive_errors == 1
    assert f"[Errno {errno.EIO}]" in watcher.last_error
    assert watcher.poll_once() == 0.5 and engine.swaps == [0, 1]  # re-armed
    assert watcher.consecutive_errors == 0


# ------------------------------------------------------------ heartbeat --

def test_heartbeat_exits_7_and_is_silent_at_zero():
    code = ("import time; from ddp_classification_pytorch_tpu_torch.utils."
            "backend_probe import StepHeartbeat as H; "
            "H(0).start(); time.sleep(0.3); H(0.2).start(); time.sleep(10)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, timeout=30,
                          capture_output=True, text=True)
    assert proc.returncode == 7, proc.stderr
    assert "hang_timeout_s=0" in proc.stderr
    assert subprocess.run(  # the watchdog alone does not load torch
        [sys.executable, "-c", "import sys; import ddp_classification_pytorch"
         "_tpu_torch.utils.backend_probe; print('torch' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=30).stdout == "False\n"
    quiet = StepHeartbeat(0).start()
    assert quiet._thread is None
    quiet.stop()


# ------------------------------------------------------------ supervisor --

STUB = """#!/usr/bin/env bash
state="${FAKE_STATE:?}"
n=$(cat "$state" 2>/dev/null || echo 0)
n=$((n+1)); echo "$n" > "$state"
echo "pid=${FLEET_PROCESS_ID:-?}/${FLEET_NUM_PROCESSES:-?} $*" >> "${FAKE_ENVLOG:?}"
rc=$(echo "${FAKE_RCS:?}" | tr ',' '\\n' | sed -n "${n}p")
[ -z "$rc" ] && rc=0
[ "$rc" = kill ] && kill -TERM $$
exit "$rc"
"""


def _stub(tmp_path, name, rcs, **env):
    """A fake trainer (`python` on PATH for the script, the command for
    the Python supervisor) exiting with `rcs` in turn."""
    d = tmp_path / name
    (d / "bin").mkdir(parents=True)
    stub = d / "bin" / "python"
    stub.write_text(STUB)
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    e = dict(os.environ, PATH=f"{d / 'bin'}:{os.environ['PATH']}",
             FAKE_STATE=str(d / "calls"), FAKE_RCS=rcs,
             FAKE_ENVLOG=str(d / "envlog"), **env)
    return d, str(stub), e


def _fields(out):
    """restarts.log without the timestamp and hostname."""
    with open(os.path.join(out, "restarts.log")) as f:
        return [" ".join(t for t in line.split()[1:]
                         if not t.startswith("host="))
                for line in f.read().splitlines()]


@pytest.mark.parametrize("rcs,env", [
    ("1,9,3,6,10,11,0", {"MAX_RESTARTS": "6"}),
    ("2", {}),
    ("8", {}),
    ("1,1,1", {"MAX_RESTARTS": "2"}),
    ("11,0", {"FLEET_ELASTIC": "1", "FLEET_HOST_ID": "2",
              "FLEET_PROCESS_ID": "2", "FLEET_NUM_PROCESSES": "3"}),
])
def test_supervisor_matches_supervise_sh(tmp_path, rcs, env):
    env = dict(env, RUNTIME_BACKOFF_S="0", OUTAGE_BACKOFF_S="0",
               REFORM_BACKOFF_S="0")
    results = []
    for kind in ("sh", "py"):
        d, stub, e = _stub(tmp_path, kind, rcs, **env)
        out = str(d / "out")
        if "FLEET_ELASTIC" in env:
            os.makedirs(os.path.join(out, "fleet"))
            fleet.write_membership(out, 3, [0, 2])
        args = ["baseline", "--out", out]
        if kind == "sh":
            rc = subprocess.run(
                ["bash", os.path.join(REPO, "scripts", "supervise.sh"), *args],
                env=e, capture_output=True, timeout=60).returncode
        else:
            rc = supervise.supervise(args, command=[stub, *supervise.TRAIN],
                                     env=e, sleep=lambda s: None)
        with open(d / "envlog") as f:  # the script runs the JAX CLI
            launches = [line.replace(str(d), "D").replace(
                " ddp_classification_pytorch_tpu.cli.",
                " ddp_classification_pytorch_tpu_torch.cli.") for line in f]
        results.append((rc, _fields(out), launches,
                        fleet.read_generation(fleet.generation_path(out))))
    assert results[0] == results[1]
    rc, fields, launches, gen = results[1]
    last = int(rcs.split(",")[-1])
    assert rc == (last if last in (0, 2, 8) else 1)
    assert all(line.endswith(" --auto_resume\n") for line in launches)


def test_supervisor_backoffs_signals_and_generation(tmp_path):
    d, stub, env = _stub(tmp_path, "py", "1,3,6,9,10,11,7,kill,0",
                         MAX_RESTARTS="8")
    for k in ("RUNTIME_BACKOFF_S", "OUTAGE_BACKOFF_S", "REFORM_BACKOFF_S"):
        env.pop(k, None)
    out = str(d / "out")
    slept = []
    assert supervise.supervise(["baseline", "--out", out], command=[stub],
                               env=env, sleep=slept.append) == 0
    assert slept == [30, 300, 300, 30, 300, 2, 2, 2]
    fields = _fields(out)
    assert [f.split()[1] for f in fields] == [
        "rc=1", "rc=3", "rc=6", "rc=9", "rc=10", "rc=11", "rc=7", "rc=143",
        "rc=0"]
    assert fields[0] == ("proc=- rc=1 backoff=30s attempt=1/8 gen=- world=- "
                         "action=restart")
    assert fields[-1].endswith("attempt=8/8 gen=- world=- action=exit")
    assert fleet.read_generation(fleet.generation_path(out)) == 8


# ------------------------------------------------------------------ CLI --

def test_cli_takes_the_compat_flags_and_refuses_a_bad_fault_spec(
        tmp_path, capsys):
    argv = ["baseline", "--dataset", "synthetic", "--synthetic_size", "8",
            "--model", "resnet18", "--image_size", "32", "--num_classes", "4",
            "--batchsize", "2", "--epochs", "1", "--device", "cpu",
            "--out", str(tmp_path), "--world_size", "2", "--local-rank=1",
            "--gpu", "0", "--hang_timeout_s", "600", "--max_bad_steps", "3"]
    args = train_cli.build_parser().parse_args(argv + ["--local_rank", "0"])
    cfg = train_cli.config_from_args(args)
    assert (cfg.run.hang_timeout_s, cfg.run.max_bad_steps) == (600.0, 3)
    with pytest.raises(SystemExit) as e:
        train_cli.main(argv + ["--fault_spec", "nan_loss@epoch=1"])
    assert e.value.code == 2
    out, err = capsys.readouterr()
    assert "[compat]" in out and "nan_loss is keyed by" in err
    with pytest.raises(SystemExit) as e:  # --multihost without FLEET_*
        train_cli.main(argv + ["--multihost"])
    assert e.value.code == 2
