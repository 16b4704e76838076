"""Async checkpoints in the torch port (`run.async_checkpoint`,
`CheckpointManager(async_save=True)`), on the CPU, as the JAX package's
`tests/test_checkpoint.py:20-90` holds its manager, plus what the port's
own order adds:

(a) saves of three epochs, then `wait()`: all three files, the newest
    restored, meta's best (JAX `test_async_save_and_restore`);
(b) pruning under async keeps exactly `keep` (JAX
    `test_keep_prunes_under_async`);
(c) a failed write surfaces once, at `wait()` or at the next save's
    implicit wait, as "async checkpoint write failed", and then clears
    (JAX `test_async_write_failure_surfaces`, `..._on_next_save_...`);
(d) a `ckpt_io` tear under async: `publish_torn` emitted, and on resume
    the torn file is quarantined and the previous epoch restored;
(e) the order on the writer thread: each file's bytes, then its sidecar,
    then `publish` (a watcher sees a file only once it verifies), then
    `meta.json`, whose `last_epoch` names a file already on disk;
(f) the host copy is a snapshot: parameters and momentum changed in
    place after `save` returns (the next SGD step) do not reach the file;
(g) the trainer: `run` returns with every write landed (its `finally`
    waits), the next save and a restore wait for the write in flight,
    and PLC writes δ into meta and `plc_labels.npy` only after the
    epoch's checkpoint has landed (one writer of `meta.json`).
"""

import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.train import checkpoint
from ddp_classification_pytorch_tpu_torch.train.checkpoint import CheckpointManager
from ddp_classification_pytorch_tpu_torch.train.loop import Trainer
from ddp_classification_pytorch_tpu_torch.train.plc_loop import PLCTrainer
from ddp_classification_pytorch_tpu_torch.utils import chaos

from torch_port_threads import one_torch_thread  # noqa: F401


class _State:
    """A train state's protocol over a tensor and an SGD optimizer: the
    weights and the momentum are updated in place, as in training."""

    def __init__(self, v: float):
        self.w = torch.nn.Parameter(torch.full((4,), float(v)))
        self.opt = torch.optim.SGD([self.w], lr=0.5, momentum=0.9)

    def sgd_step(self):
        self.w.grad = torch.ones_like(self.w)
        self.opt.step()

    def state_dict(self):
        return {"w": self.w.detach(), "optimizer": self.opt.state_dict()}

    def load_state_dict(self, sd):
        with torch.no_grad():
            self.w.copy_(sd["w"])
        self.opt.load_state_dict(sd["optimizer"])


def test_async_save_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    for e in range(3):
        mgr.save(_State(e), e, metric=float(e))
    mgr.wait()
    assert sorted(mgr._epoch_checkpoints()) == [0, 1, 2]
    state, next_epoch = mgr.restore_latest(_State(-1.0))
    assert next_epoch == 3
    assert torch.equal(state.w.detach(), torch.full((4,), 2.0))
    meta = mgr.read_meta()
    assert meta["best_epoch"] == 2 and meta["best_metric"] == 2.0
    assert meta["last_epoch"] == 2
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_keep_prunes_under_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for e in range(5):
        mgr.save(_State(e), e)
    mgr.wait()
    assert sorted(mgr._epoch_checkpoints()) == [3, 4]


def test_async_write_failure_surfaces_once(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(_State(0.0), 0)
    mgr.wait()
    shutil.rmtree(tmp_path)  # the next write fails
    mgr.save(_State(1.0), 1)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.wait()
    mgr.wait()  # surfaced once: clear


def test_async_failure_surfaces_on_next_save_and_then_clears(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(_State(0.0), 0)
    mgr.wait()
    shutil.rmtree(tmp_path)
    mgr.save(_State(1.0), 1)
    mgr._pending.join(timeout=30)  # the failure lands, not yet consumed
    assert not mgr._pending.is_alive()
    os.makedirs(tmp_path)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.save(_State(2.0), 2)  # the one-in-flight wait surfaces it
    mgr.save(_State(3.0), 3)
    mgr.wait()
    assert 3 in mgr._epoch_checkpoints()


def test_torn_write_under_async_is_quarantined_on_resume(tmp_path,
                                                         monkeypatch):
    events = []
    monkeypatch.setattr(checkpoint, "emit",
                        lambda kind, **kw: events.append((kind, kw)))
    out = str(tmp_path / "run")
    mgr = CheckpointManager(out, async_save=True,
                            chaos=chaos.FaultPlan.parse("ckpt_io@epoch=1"))
    for e in (0, 1):
        mgr.save(_State(e), e)
    mgr.wait()
    assert [k for k, _ in events] == ["publish", "publish", "publish_torn"]
    fresh = CheckpointManager(out)
    state, next_epoch = fresh.restore_latest(_State(-1.0))
    assert next_epoch == 1 and torch.equal(state.w.detach(), torch.zeros(4))
    assert os.path.exists(os.path.join(out, "ckpt_e1.pt.corrupt"))
    assert checkpoint.verify(fresh.epoch_path(0)) is None


def test_writer_order_sidecar_then_publish_then_meta(tmp_path, monkeypatch):
    seen = []
    out = str(tmp_path)

    def emit(kind, **kw):
        seen.append((kind, os.path.exists(checkpoint.checksum_path(kw["path"])),
                     checkpoint.verify(kw["path"]) is None,
                     threading.current_thread().name))

    real_meta = CheckpointManager._write_meta

    def write_meta(self, **kw):
        path = self.epoch_path(kw["last_epoch"])
        seen.append(("meta", os.path.exists(checkpoint.checksum_path(path)),
                     checkpoint.verify(path) is None,
                     threading.current_thread().name))
        real_meta(self, **kw)

    monkeypatch.setattr(checkpoint, "emit", emit)
    monkeypatch.setattr(CheckpointManager, "_write_meta", write_meta)
    mgr = CheckpointManager(out, async_save=True)
    mgr.save(_State(0.0), 0, metric=1.0)
    mgr.wait()
    assert seen == [("publish", True, True, "ckpt-writer"),
                    ("meta", True, True, "ckpt-writer")]
    assert checkpoint.verify(mgr.best_path) is None
    assert json.load(open(mgr.meta_path))["best_epoch"] == 0


def test_the_host_copy_is_a_snapshot(tmp_path, monkeypatch):
    go = threading.Event()
    real_save = checkpoint.save

    def slow_save(obj, path, tear=None):
        go.wait(10)  # the step loop moves on before the bytes are written
        return real_save(obj, path, tear)

    monkeypatch.setattr(checkpoint, "save", slow_save)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _State(1.0)
    state.sgd_step()
    want = {k: v.clone() for k, v in (
        ("w", state.w.detach()),
        ("m", state.opt.state[state.w]["momentum_buffer"]))}
    mgr.save(state, 0)
    state.sgd_step()  # in place: the live weights and momentum change
    assert not torch.equal(state.w.detach(), want["w"])
    go.set()
    mgr.wait()
    saved = checkpoint.restore(mgr.epoch_path(0))
    assert torch.equal(saved["w"], want["w"])
    assert torch.equal(saved["optimizer"]["state"][0]["momentum_buffer"],
                       want["m"])


def _argv(out, *extra):
    return ["baseline", "--dataset", "synthetic", "--synthetic_size", "8",
            "--model", "resnet18", "--variant", "cifar", "--image_size", "16",
            "--num_classes", "4", "--batchsize", "4", "--epochs", "2",
            "--dtype", "float32", "--device", "cpu", "--num_workers", "1",
            "--out", out, *extra]


def test_trainer_waits_at_the_next_save_at_restore_and_on_exit(tmp_path,
                                                              monkeypatch):
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
        _argv(str(tmp_path / "a"))))
    assert cfg.run.async_checkpoint  # JAX's default
    trainer = Trainer(cfg, torch.device("cpu"))
    assert trainer.ckpt.async_save
    waits = []
    real_wait = CheckpointManager.wait

    def wait(self):
        waits.append(self._pending is not None)
        real_wait(self)

    monkeypatch.setattr(CheckpointManager, "wait", wait)
    trainer.run()
    # epoch 1's save waited for epoch 0's write; run's exit for epoch 1's
    assert waits[-1] and sum(waits) == 2
    assert trainer.ckpt._pending is None
    for e in (0, 1):
        assert checkpoint.verify(trainer.ckpt.epoch_path(e)) is None
    resumed = Trainer(train_cli.config_from_args(
        train_cli.build_parser().parse_args(_argv(
            str(tmp_path / "b"), "--epochs", "3", "--resume",
            trainer.ckpt.epoch_path(1)))), torch.device("cpu"))
    assert resumed.start_epoch == 2
    assert resumed.state.step == trainer.state.step == 4


def test_plc_writes_delta_and_labels_after_the_checkpoint(tmp_path,
                                                         monkeypatch):
    out = str(tmp_path / "plc")
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
        ["plc", *_argv(out, "--synthetic_size", "16", "--batchsize", "8",
                       "--plc_warmup_epochs", "1")[1:]]))
    trainer = PLCTrainer(cfg, torch.device("cpu"))
    landed = []
    real_meta = CheckpointManager._write_meta

    def write_meta(self, **kw):
        if "plc_delta" in kw:  # PLC's own write, on the step loop's thread
            landed.append((self._pending is None, all(
                checkpoint.verify(self.epoch_path(e)) is None
                for e in range(self.read_meta()["last_epoch"] + 1))))
        real_meta(self, **kw)

    monkeypatch.setattr(CheckpointManager, "_write_meta", write_meta)
    trainer.run()
    assert landed == [(True, True), (True, True)]
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["last_epoch"] == 1 and "plc_delta" in meta
    labels = np.load(os.path.join(out, "plc_labels.npy"))
    assert labels.shape == (16,)


def test_a_fault_plan_lets_the_write_land_before_its_step_faults(tmp_path):
    """Under a fault plan the step loop waits for the write in flight
    before the step's host faults (a sigterm, a watchdog exit, a lost
    host), so a drill's kill never lands mid-write."""
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
        _argv(str(tmp_path), "--fault_spec", "sigterm@step=99")))
    trainer = Trainer(cfg, torch.device("cpu"))
    landed = []
    real = trainer.chaos.maybe_sigterm

    def maybe_sigterm(*, step):
        landed.append(trainer.ckpt._pending is None)
        real(step=step)

    trainer.chaos.maybe_sigterm = maybe_sigterm
    trainer.run()
    assert landed == [True] * 4  # 2 epochs × 2 steps, epoch 0's save landed
    assert checkpoint.verify(trainer.ckpt.epoch_path(1)) is None
