"""The port's fault plan (`utils/chaos.py`) against the JAX package's, and
its nan_loss window in the port's train step, on the CPU.

Parity is exact: both `FaultPlan.parse` implementations give the same
faults (or the same ValueError) on a table of specs and on specs drawn
from `FAULT_GRAMMAR`; `should_fire`, `windows`, the one-shot marker
files, the ``CHAOS_HOST`` gate and ``CHAOS_FAULT_SPEC``'s precedence
agree, and a torn checkpoint keeps the same length under both. The step:
on a reduced ResNet, the steps inside the windows leave the parameters,
buffers and momentum bitwise as they were and advance the step counter;
the steps outside them are bitwise a step without chaos from the same
state; the skipped steps are the JAX plan's windows over the steps taken.
No JAX trainer or jitted step runs.
"""

import copy
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ddp_classification_pytorch_tpu.utils import chaos as jax_chaos
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.models import resnet
from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel
from ddp_classification_pytorch_tpu_torch.train import schedule, steps
from ddp_classification_pytorch_tpu_torch.train.state import TrainState
from ddp_classification_pytorch_tpu_torch.utils import chaos

from torch_port_threads import one_torch_thread  # noqa: F401

SPECS = [
    "", " ", "nan_loss@step=7", "nan_loss@step=7..9", "nan_loss@step=7..",
    "ckpt_io@epoch=1,loader_io@batch=3,sigterm@step=20",
    "loader_io@epoch=2, peer_slow@step=4 ,host_lost@step=9..",
    "publish_corrupt@epoch=0,watcher_io@poll=3..5,peer_dead@step=1",
    "sigterm@batch=2,ckpt_io@step=3..4,loader_io@step=0..",
    # malformed: each a ValueError with the same message on both sides
    "nan_loss@epoch=1", "watcher_io@step=1", "ckpt_io@poll=1", "bogus@step=1",
    "nan_loss@minute=1", "nan_loss", "nan_loss@step", "nan_loss@step=x",
    "nan_loss@step=9..7", "peer_dead@epoch=1", "publish_corrupt@step=1",
    "host_lost@batch=2", "nan_loss@step=1..2..3",
]


def _parsed(mod, spec, **kw):
    try:
        plan = mod.FaultPlan.parse(spec, **kw)
    except ValueError as e:
        return "ValueError", str(e)
    return [(f.kind, f.unit, f.lo, f.hi, f.key, str(f)) for f in plan.faults]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_jax(spec):
    assert _parsed(chaos, spec) == _parsed(jax_chaos, spec)


_range = st.one_of(
    st.integers(0, 40).map(str),
    st.tuples(st.integers(0, 40), st.integers(0, 40)).map(
        lambda t: f"{t[0]}..{t[1]}"),
    st.integers(0, 40).map(lambda v: f"{v}.."))
_fault = st.tuples(st.sampled_from(sorted(jax_chaos.FAULT_GRAMMAR)),
                   st.sampled_from(jax_chaos.UNITS), _range).map(
    lambda t: f"{t[0]}@{t[1]}={t[2]}")


@settings(max_examples=60, deadline=None)
@given(st.lists(_fault, min_size=1, max_size=4).map(",".join))
def test_drawn_specs_parse_as_jax_does(spec):
    assert _parsed(chaos, spec) == _parsed(jax_chaos, spec)


def test_grammar_and_env_names_are_jax_s():
    assert chaos.FAULT_GRAMMAR == {
        k: chaos.KindInfo(*(getattr(v, f) for f in
                            ("units", "side", "subsystem", "unit_error")))
        for k, v in jax_chaos.FAULT_GRAMMAR.items()}
    assert (chaos.KINDS, chaos.UNITS) == (jax_chaos.KINDS, jax_chaos.UNITS)
    assert [getattr(chaos, n) for n in ("ENV_SPEC", "ENV_STATE_DIR",
                                        "ENV_HOST", "ENV_PEER_SLOW_S")] == [
        getattr(jax_chaos, n) for n in ("ENV_SPEC", "ENV_STATE_DIR",
                                        "ENV_HOST", "ENV_PEER_SLOW_S")]


SPEC = ("nan_loss@step=2..3,nan_loss@step=9..,ckpt_io@epoch=1,"
        "loader_io@batch=3..4,sigterm@step=5,publish_corrupt@epoch=1..2,"
        "watcher_io@poll=2,peer_slow@step=0")


def _fire_sequence(mod, state_dir, index):
    """Every should_fire answer over a grid of coordinates, twice (the
    second pass sees the one-shot state), the windows, and the markers."""
    plan = mod.FaultPlan.parse(SPEC, state_dir=state_dir, process_index=index)
    fired = []
    for _ in range(2):
        for kind in mod.KINDS:
            for unit in mod.UNITS:
                for v in range(6):
                    f = plan.should_fire(kind, **{unit: v})
                    fired.append(None if f is None else str(f))
    return (fired, [plan.windows(k, u) for k in mod.KINDS for u in mod.UNITS],
            sorted(os.listdir(state_dir)) if os.path.isdir(state_dir) else [])


@pytest.mark.parametrize("host", ["", "0", "1", "x"])
def test_should_fire_windows_markers_and_host_gate_match_jax(
        tmp_path, monkeypatch, host):
    monkeypatch.delenv(chaos.ENV_STATE_DIR, raising=False)
    monkeypatch.setenv(chaos.ENV_HOST, host)
    for index in (0, 1):
        port = _fire_sequence(chaos, str(tmp_path / f"p{index}"), index)
        ref = _fire_sequence(jax_chaos, str(tmp_path / f"j{index}"), index)
        assert port == ref
        gated = host not in ("", "x") and int(host) != index
        assert (not any(port[0])) == gated
    # a restarted process reads the markers: nothing fires a second time
    again = chaos.FaultPlan.parse(SPEC, state_dir=str(tmp_path / "p0"))
    if host in ("", "0", "x"):
        assert again.should_fire("sigterm", step=5) is None


def test_env_spec_wins_and_state_dir(tmp_path, monkeypatch):
    monkeypatch.delenv(chaos.ENV_STATE_DIR, raising=False)
    monkeypatch.delenv(chaos.ENV_SPEC, raising=False)
    out = str(tmp_path)
    for spec in ("", "sigterm@step=3"):
        p, j = (m.plan_for_run(spec, out, 0) for m in (chaos, jax_chaos))
        assert (bool(p), str(p), p.state_dir) == (bool(j), str(j), j.state_dir)
    monkeypatch.setenv(chaos.ENV_SPEC, "loader_io@batch=1")
    p, j = (m.plan_for_run("sigterm@step=3", out, 1) for m in (chaos, jax_chaos))
    assert str(p) == str(j) == "loader_io@batch=1"
    assert p.state_dir == j.state_dir == os.path.join(out, "chaos")
    monkeypatch.setenv(chaos.ENV_STATE_DIR, str(tmp_path / "elsewhere"))
    p, j = (m.plan_for_run("", out, 0) for m in (chaos, jax_chaos))
    assert p.state_dir == j.state_dir == str(tmp_path / "elsewhere")
    # the index defaults to the rank: FLEET_PROCESS_ID before a group
    monkeypatch.setenv("FLEET_PROCESS_ID", "3")
    assert chaos.plan_for_run("", out).process_index == 3


@pytest.mark.parametrize("size", [1, 2, 3, 1001])
def test_tear_keeps_jax_s_length(tmp_path, monkeypatch, size):
    monkeypatch.delenv(chaos.ENV_STATE_DIR, raising=False)
    monkeypatch.delenv(chaos.ENV_HOST, raising=False)
    data = np.random.default_rng(size).bytes(size)
    sizes = []
    for mod, name in ((chaos, "p.pt"), (jax_chaos, "j.pt")):
        path = tmp_path / name
        path.write_bytes(data)
        plan = mod.FaultPlan.parse("ckpt_io@epoch=1")
        assert not plan.maybe_corrupt_checkpoint(str(path), epoch=0)
        assert plan.maybe_corrupt_checkpoint(str(path), epoch=1)
        assert not plan.maybe_corrupt_checkpoint(str(path), epoch=1)
        sizes.append(path.read_bytes())
    assert sizes[0] == sizes[1] == data[:max(size // 2, 1)]


# ------------------------------------------------------------- the step --

def _state(seed=0):
    torch.manual_seed(seed)
    model = ClassifierModel(resnet.ResNet(
        (1, 1, 1, 1), resnet.BasicBlock, num_classes=4, num_filters=4,
        cifar_stem=True, dtype=torch.float32))
    cfg = get_preset("baseline")
    cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
    cfg.optim.lr, cfg.optim.warmup_iters = 0.05, 0
    return cfg, TrainState(model, schedule.build_optimizer(
        cfg.optim, model.parameters()), schedule.build_schedule(cfg.optim, 1))


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()}
             for i, s in state.optimizer.state_dict()["state"].items()},
            state.step, state.opt_count)


def _equal(a, b):
    return (a[0].keys() == b[0].keys()
            and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
            and a[1].keys() == b[1].keys()
            and all(torch.equal(a[1][i][k], b[1][i][k])
                    for i in a[1] for k in a[1][i]))


@pytest.fixture
def one_thread():
    """torch 2.13's CPU backward of a channels_last convolution this
    narrow (4-8 channels) corrupts the heap now and then over several
    threads (an abort in `loss.backward()`); one thread never does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_nan_loss_window_skips_exactly_jax_s_steps(monkeypatch, one_thread):
    monkeypatch.delenv(chaos.ENV_HOST, raising=False)
    spec, taken = "nan_loss@step=1,nan_loss@step=3..", 5
    cfg, state = _state()
    clean = steps.make_train_step(cfg)
    chaotic = steps.make_train_step(cfg, chaos=chaos.FaultPlan.parse(spec))
    rng = np.random.default_rng(0)
    skipped = set()
    for k in range(taken):
        images = torch.from_numpy(
            rng.normal(size=(4, 16, 16, 3)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 4, 4).astype(np.int32))
        twin = copy.deepcopy(state)
        before = _snapshot(state)
        m = chaotic(state, images, labels)
        clean(twin, images, labels)
        after = _snapshot(state)
        assert state.step == k + 1
        if float(m["step_ok"]) == 0.0:
            skipped.add(k)
            assert np.isnan(float(m["loss"]))
            assert _equal(after, before) and after[3] == before[3]
        else:
            assert _equal(after, _snapshot(twin)) and after[3] == twin.opt_count
    windows = jax_chaos.FaultPlan.parse(spec).windows("nan_loss")
    assert skipped == {k for k in range(taken) for lo, hi in windows
                       if lo <= k and (hi is None or k <= hi)} == {1, 3, 4}
