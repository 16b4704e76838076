"""Resume in the torch port, on the CPU, through the train CLI on an image
folder (the native dataplane, the uint8 wire, the train-time flip): full
TResNet-M at 64 px, f32, batch 4, 2 train steps and 1 eval batch an epoch.

- Two epochs straight against one epoch and then `--resume` (into a new
  out dir) or `--auto_resume` (into the same one): parameters, buffers,
  momentum, `step`/`opt_count` bitwise, and `history.json` bitwise but for
  `epoch_time` (a wall clock).
- `--auto_resume` quarantines a tampered newest checkpoint as `*.corrupt`
  and resumes from the one before; a tampered `--resume` exits rc 2.
- The checkpoint manager writes the files and `meta.json` the JAX
  package's writes under `save_best_only` and `keep_checkpoints`.
- The tensorboard scalars read back; the serve CLI serves the resumed
  checkpoint.
"""

import glob
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.train.checkpoint import (
    CheckpointManager as JaxManager,
)
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.config import OptimConfig
from ddp_classification_pytorch_tpu_torch.train import checkpoint, schedule
from ddp_classification_pytorch_tpu_torch.train.state import TrainState
from ddp_classification_pytorch_tpu_torch.utils.tensorboard import read_scalars

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_port_jpeg")


def _rc(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        return e.code
    return 0


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """train/{c0,c1}/ of 4 JPEGs each and val/{c0,c1}/ of 2, from the
    committed fixtures."""
    root = tmp_path_factory.mktemp("folder")
    files = sorted(glob.glob(os.path.join(FIXTURES, "*.jpg")))
    for split, n in (("train", 4), ("val", 2)):
        for c in range(2):
            d = root / split / f"c{c}"
            d.mkdir(parents=True)
            for i in range(n):
                shutil.copy(files[(4 * c + i) % len(files)], d / f"{i}.jpg")
    return root


def _argv(folder, out, epochs, *extra):
    return ["baseline", "--dataset", "imagefolder",
            "--train_dir", str(folder / "train"), "--val_dir", str(folder / "val"),
            "--model", "tresnet_m", "--image_size", "64", "--crop_size", "64",
            "--num_classes", "2", "--batchsize", "4", "--dtype", "float32",
            "--lr", "0.01", "--num_workers", "2", "--epochs", str(epochs),
            "--device", "cpu", "--out", str(out), *extra]


@pytest.fixture(scope="module")
def runs(folder, tmp_path_factory):
    """straight: 2 epochs; stopped: 1 epoch, then --auto_resume to 2 in
    place; resumed: --resume stopped/ckpt_e0.pt to 2 in a new dir."""
    base = tmp_path_factory.mktemp("runs")
    dirs = {k: base / k for k in ("straight", "stopped", "resumed")}
    assert _rc(train_cli.main, _argv(folder, dirs["straight"], 2,
                                     "--tensorboard")) == 0
    assert _rc(train_cli.main, _argv(folder, dirs["stopped"], 1,
                                     "--tensorboard")) == 0
    assert _rc(train_cli.main, _argv(
        folder, dirs["resumed"], 2, "--resume",
        str(dirs["stopped"] / "ckpt_e0.pt"))) == 0
    assert _rc(train_cli.main, _argv(folder, dirs["stopped"], 2,
                                     "--auto_resume", "--tensorboard")) == 0
    return dirs


def _assert_same_state(a, b):
    assert a["step"] == b["step"] == 4 and a["opt_count"] == b["opt_count"] == 4
    assert sorted(a["model"]) == sorted(b["model"])
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sorted(sa) == sorted(sb) and len(sa) > 100
    for k in sa:
        assert torch.equal(sa[k]["momentum_buffer"], sb[k]["momentum_buffer"]), k
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]


def _history(out):
    with open(os.path.join(out, "history.json")) as f:
        h = json.load(f)
    assert len(h.pop("epoch_time")) == 2  # a wall clock: the one key apart
    return h


def test_resume_and_auto_resume_continue_bitwise(runs):
    straight = checkpoint.restore(str(runs["straight"] / "ckpt_e1.pt"))
    for k in ("resumed", "stopped"):
        _assert_same_state(straight,
                           checkpoint.restore(str(runs[k] / "ckpt_e1.pt")))
    assert _history(runs["stopped"]) == _history(runs["straight"])
    with open(runs["stopped"] / "output.txt") as f:
        text = f.read()
    assert text.count("# native C++ dataplane active") == 2
    assert "epoch:0" in text and "epoch:1" in text
    metas = [json.loads((runs[k] / "meta.json").read_text())
             for k in ("straight", "stopped")]
    assert metas[0] == metas[1] and metas[0]["last_epoch"] == 1
    assert set(metas[0]) == {"last_epoch", "best_epoch", "best_metric"}


def test_tensorboard_scalars_read_back(runs):
    for k in ("straight", "stopped"):  # the resumed run appends a file
        events = sorted(glob.glob(str(runs[k] / "tb" / "events.out.tfevents.*")))
        assert len(events) == (1 if k == "straight" else 2)
        got = {}
        for path in events:
            for step, tag, value in read_scalars(path):
                got.setdefault(tag, {})[step] = value
        hist = json.loads((runs[k] / "history.json").read_text())
        for key, values in hist.items():
            tag = ("val/" if key.startswith("val_") else "train/") + key
            assert sorted(got[tag]) == [0, 1]
            for e, v in enumerate(values):
                assert got[tag][e] == np.float32(v), (tag, e)


def test_auto_resume_quarantines_a_tampered_newest_checkpoint(runs, folder,
                                                              tmp_path):
    out = tmp_path / "run"
    shutil.copytree(runs["stopped"], out)
    with open(out / "ckpt_e1.pt", "r+b") as f:
        f.seek(1000)
        b = f.read(1)
        f.seek(1000)
        f.write(bytes([b[0] ^ 0x01]))
    assert _rc(train_cli.main, _argv(folder, out, 2, "--auto_resume")) == 0
    assert (out / "ckpt_e1.pt.corrupt").exists()
    assert (out / "ckpt_e1.pt.corrupt.sha256").exists()
    # epoch 1 ran again from ckpt_e0: the straight run's state, bitwise
    _assert_same_state(checkpoint.restore(str(runs["straight"] / "ckpt_e1.pt")),
                       checkpoint.restore(str(out / "ckpt_e1.pt")))


def test_tampered_resume_exits_2_and_the_resumed_checkpoint_serves(
        runs, folder, tmp_path, capsys):
    bad = tmp_path / "ckpt_e0.pt"
    shutil.copy(runs["stopped"] / "ckpt_e0.pt", bad)
    shutil.copy(runs["stopped"] / "ckpt_e0.pt.sha256", str(bad) + ".sha256")
    with open(bad, "ab") as f:
        f.write(b"tamper")
    assert _rc(train_cli.main, _argv(folder, tmp_path / "r", 2, "--resume",
                                     str(bad))) == 2
    assert "sha256" in capsys.readouterr().err
    assert _rc(serve_cli.main, [
        "baseline", "--model", "tresnet_m", "--image_size", "64",
        "--num_classes", "2", "--dtype", "float32", "--device", "cpu",
        "--topk", "2", "--ckpt", str(runs["resumed"] / "ckpt_e1.pt"),
        "--selfcheck", "2"]) == 0
    assert "selfcheck ok: 2 requests" in capsys.readouterr().out


@pytest.mark.parametrize("best_only,keep", [(False, 0), (True, 0), (False, 2)])
def test_checkpoint_manager_writes_what_jax_writes(tmp_path, best_only, keep):
    """The same metric sequence through both managers: the same files
    (`.pt` for `.msgpack`) and the same meta."""
    model = torch.nn.Linear(3, 2)
    state = TrainState(model, schedule.build_optimizer(
        OptimConfig(lr=0.1), model.parameters()),
        schedule.build_schedule(OptimConfig(lr=0.1), 1))
    mine = checkpoint.CheckpointManager(str(tmp_path / "pt"), best_only=best_only,
                                        keep=keep)
    theirs = JaxManager(str(tmp_path / "msgpack"), best_only=best_only,
                        keep=keep, async_save=False)
    for epoch, metric in enumerate([0.2, 0.5, 0.4, None, 0.7, 0.6]):
        assert (mine.save(state, epoch, metric)
                == theirs.save({"w": jnp.zeros(3)}, epoch, metric))
    names = [sorted(n.replace(".msgpack", ".pt") for n in os.listdir(tmp_path / d))
             for d in ("pt", "msgpack")]
    assert names[0] == names[1] and "meta.json" in names[0]
    metas = [json.loads((tmp_path / d / "meta.json").read_text())
             for d in ("pt", "msgpack")]
    metas[1].pop("world_size")
    assert metas[0] == metas[1] == {"last_epoch": 5, "best_epoch": 4,
                                    "best_metric": 0.7}
