"""The port's compile sentinel (`analysis/compile_sentinel.py`) against the
JAX package's class contract, its kernel-build events (`ops/_build.py`,
with a fake `nvcc`), the serving engine's warmup contract and batch-
boundary check on the CPU, and `--strict_compile` on both CLIs: a build
after arming is rc 2, as the JAX trainer's recompile is."""

import os
import subprocess
import types

import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.analysis import compile_sentinel as jax_cs
from ddp_classification_pytorch_tpu_torch.analysis import compile_sentinel as cs
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.ops import _build
from ddp_classification_pytorch_tpu_torch.serve.engine import EngineClosed
from ddp_classification_pytorch_tpu_torch.train.loop import Trainer

from torch_port_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """`_build.build` into an empty build dir with an `nvcc` that writes
    its `-o` file and counts its calls; returns (calls, a source file)."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\x7fELF fake library " + str(len(calls)).encode())
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info\n")

    monkeypatch.setattr(_build, "subprocess", types.SimpleNamespace(
        run=run, PIPE=subprocess.PIPE, STDOUT=subprocess.STDOUT))
    src = tmp_path / "k.cu"
    src.write_text("__global__ void k() {}\n")
    return calls, str(src)


def _drive(mod, record):
    """The same event sequence through a sentinel of `mod`: the outcome
    of each step of the shared contract."""
    s = mod.CompileSentinel(tag="t", log=lambda msg: None)
    out = [s.armed]
    s.arm()
    out.append(s.armed)
    record(s, "f", "sig1")
    record(s, "g", "sig2")
    out.append([e.name for e in s.take()])
    out.append(s.take())
    record(s, "h", "sig3")
    out.append([e.name for e in s.check(strict=False)])
    out.append(s.violations)
    record(s, "k", "sig4")
    with pytest.raises(mod.SteadyStateRecompile) as ei:
        s.check(strict=True)
    out.append("k sig4" in str(ei.value))
    out += [s.violations, s.total, s.check(strict=True)]
    s.disarm()
    s.disarm()  # idempotent
    out.append(s.armed)
    return out


def test_contract_matches_the_jax_sentinel():
    jax_out = _drive(jax_cs, lambda s, n, sig: s._record(n, sig))
    port_out = _drive(cs, lambda s, n, sig: s.record(n, sig))
    assert port_out == jax_out == [False, True, ["f", "g"], [], ["h"], 1,
                                   True, 2, 4, [], False]
    assert cs.SteadyStateRecompile.exit_code == \
        jax_cs.SteadyStateRecompile.exit_code == 2
    assert issubclass(cs.SteadyStateRecompile, RuntimeError)
    assert set(cs.CompileEvent._fields) == set(jax_cs.CompileEvent._fields)


def test_a_build_is_one_event_and_a_found_library_none(fake_nvcc):
    calls, src = fake_nvcc
    s = cs.CompileSentinel().arm()
    other = cs.CompileSentinel().arm()  # builds fan out to every armed one
    try:
        path = _build.build("fake", [src])
        assert len(calls) == 1
        events = s.take()
        assert [e.name for e in events] == ["build:fake"]
        assert events[0].signature == os.path.basename(path)
        assert _build.build("fake", [src]) == path  # found: no nvcc, no event
        assert len(calls) == 1 and s.take() == []
        with open(src, "a") as f:
            f.write("// changed\n")
        _build.build("fake", [src])  # a new source hash builds anew
        assert [e.name for e in s.take()] == ["build:fake"]
        assert len(other.take()) == 2
    finally:
        s.disarm()
        other.disarm()
    _build.build("fake", [src, src])  # nobody armed: nothing recorded
    assert s.take() == []


SERVE = ["baseline", "--model", "resnet18", "--variant", "cifar",
         "--image_size", "32", "--num_classes", "10", "--dtype", "float32",
         "--device", "cpu", "--max_batch", "2", "--batch_timeout_ms", "0"]


def _engine(strict=False):
    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
        SERVE + ["--selfcheck", "1"] + (["--strict_compile"] if strict else [])))
    return serve_cli.build_engine(cfg, CPU)


def _image(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (32, 32, 3)).astype(np.uint8)


@pytest.mark.parametrize("strict", [False, True], ids=["warn", "strict"])
def test_engine_steady_state_build_is_counted_or_fatal(strict, fake_nvcc):
    """The CPU engine's warmup records no capture and no build; a build
    after it is counted at the next batch boundary, and under
    strict_compile it sets fatal_error, stops intake and raises — after
    the batch has been answered."""
    _, src = fake_nvcc
    engine = _engine(strict)
    engine.warmup()
    assert engine.boot["captures"] == 0 and engine.boot["builds"] == 0
    assert engine.compile_sentinel.armed and not engine.aot_hit
    f = engine.submit(_image())
    assert engine.process_once() == 1  # quiet steady state
    assert engine.metrics.recompiles == 0
    _build.build("fake", [src])
    f2 = engine.submit(_image(1))
    if strict:
        with pytest.raises(cs.SteadyStateRecompile):
            engine.process_once()
        assert isinstance(engine.fatal_error, cs.SteadyStateRecompile)
        with pytest.raises(EngineClosed):
            engine.submit(_image())
    else:
        assert engine.process_once() == 1
        assert engine.fatal_error is None
    assert f.result(timeout=0).indices.shape == f2.result(timeout=0).indices.shape
    assert engine.metrics.recompiles == 1
    engine.drain()
    assert not engine.compile_sentinel.armed  # released with the engine


def test_warmup_counts_a_build_and_holds_the_library_bound(fake_nvcc,
                                                           monkeypatch):
    """A build during warmup is not a violation (the cold boot's own), but
    more builds than there are kernel libraries break the contract."""
    _, src = fake_nvcc
    engine = _engine()
    predict = engine._predict

    def building_predict(model, images):
        _build.build("fake", [src])
        return predict(model, images)

    engine._predict = building_predict
    engine.warmup()  # one library built at the first bucket, found after
    assert engine.boot["builds"] == 1 and engine.metrics.recompiles == 0
    engine.close()

    calls = iter(range(100))

    def fresh_library(model, images):
        with open(src, "a") as f:
            f.write(f"// {next(calls)}\n")
        _build.build("fake", [src])
        return predict(model, images)

    engine = _engine()
    engine._predict = fresh_library
    monkeypatch.setattr("ddp_classification_pytorch_tpu_torch.serve.aot."
                        "kernel_libraries", lambda: {"fake": [src]})
    with pytest.raises(RuntimeError, match="built 2 kernel libraries"):
        engine.warmup()
    assert engine.compile_sentinel is None
    engine.close()


def _rc(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        return int(e.code)
    return 0


@pytest.mark.parametrize("strict", [False, True], ids=["warn", "strict"])
def test_trainer_strict_compile_makes_a_late_build_rc_2(strict, fake_nvcc,
                                                        tmp_path, monkeypatch,
                                                        capsys):
    """The trainer arms at the top of the epoch after the first evaluated
    one; a kernel build during that epoch is rc 2 under --strict_compile
    (at the check after the last epoch), logged and counted otherwise."""
    _, src = fake_nvcc
    train_epoch = Trainer.train_epoch

    def building_epoch(self, epoch, eta):
        out = train_epoch(self, epoch, eta)
        if epoch == 1:
            assert self.compile_sentinel.armed
            _build.build("fake", [src])
        else:
            assert not self.compile_sentinel.armed
        return out

    monkeypatch.setattr(Trainer, "train_epoch", building_epoch)
    argv = ["baseline", "--dataset", "synthetic", "--synthetic_size", "8",
            "--model", "resnet18", "--variant", "cifar", "--image_size", "32",
            "--num_classes", "4", "--batchsize", "4", "--epochs", "2",
            "--dtype", "float32", "--device", "cpu",
            "--out", str(tmp_path / "r")] + (["--strict_compile"] if strict
                                             else [])
    rc = _rc(train_cli.main, argv)
    out = capsys.readouterr()
    assert "[compile-sentinel] armed" in out.out
    assert "steady-state build `build:fake`" in out.out
    if strict:
        assert rc == 2 and "steady-state recompile" in out.err
    else:
        assert rc == 0


def test_serve_cli_strict_compile_steady_state_build_is_rc_2(fake_nvcc,
                                                             monkeypatch,
                                                             capsys, caplog):
    """cli/serve.py --strict_compile: a build after warmup (here from the
    predict, at the first served batch) exits rc 2 once the selfcheck's
    requests are answered; without the flag it is logged and the
    selfcheck passes."""
    _, src = fake_nvcc
    from ddp_classification_pytorch_tpu_torch.train import steps

    make = steps.make_topk_predict_step

    def late_building(cfg, k):
        predict, n = make(cfg, k), [0]

        def step(model, images):
            n[0] += 1
            if n[0] > 2:  # after warmup's two buckets
                _build.build("fake", [src])
            return predict(model, images)

        return step

    monkeypatch.setattr(steps, "make_topk_predict_step", late_building)
    argv = SERVE + ["--selfcheck", "2"]
    assert _rc(serve_cli.main, argv + ["--strict_compile"]) == 2
    assert "steady-state build(s) after warmup" in capsys.readouterr().err
    with open(src, "a") as f:  # a library not built yet
        f.write("// again\n")
    caplog.clear()
    assert _rc(serve_cli.main, argv) == 0
    assert "selfcheck ok: 2 requests" in capsys.readouterr().out
    assert "steady-state build `build:fake`" in caplog.text
