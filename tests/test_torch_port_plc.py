"""The port's PLC workload against the JAX package's, on the CPU.

(a) `PLCDataset` (annotations, the per-class subsample, items through the
    clothing1m transform, `update_corrupted_label`), `build_annotations`
    and `check_bad_images` (one corrupt file) against JAX on
    tests/data/torch_port_jpeg/: key lists, labels and bad files bitwise,
    items within tests/test_torch_port_data.py's PIXELS (the JAX side
    decodes with PIL).
(b) `make_predict_step` in eval mode and in `batch_stat_mode`, with
    both nets in f64 up to their f32 pool and fc (the reduced ResNet-50
    of tests/torch_port_heads.py, 32 px): the last block's f64 output
    within 1e-9 relative on the float32 wire, the logits within TOL on
    the float32 and uint8 wires; the running statistics untouched by
    `batch_stat_mode`.
(c) Two epochs of `PLCTrainer` (warmup 1, so one ordered pass and one
    LRT correction) on N = 100 synthetic images at batch 16 (100 is no
    multiple of 16: the pass wraps) with type-1 noise injected from a
    seeded η, against JAX's `PLCTrainer`, both nets in f64 as in (b): the
    injected count, the corrected labels, δ and the count of each epoch
    equal; the pass's logits and the losses within TOL. The test first
    asserts that no LRT ratio of the JAX pass lies within MARGIN of δ, so
    a rounding difference cannot move a label across the threshold. The
    lr is 3e-4: at the preset's 0.01 the two f64 runs (apart only in the
    f32 head's summation order) drift apart ~10× a step from the third
    step on (1e-7 → 1e-3 in five steps), at 3e-4 they stay within 2e-4.
(d) `cli/train.py plc --device cpu`: on synthetic data it prints the
    `[plc epoch 1] … corrected=… delta=…` record and writes
    `plc_labels.npy`; `--auto_resume` restores the labels and δ; the
    probabilistic correction under `--plc_max_flip_frac` caps the flips;
    on CIFAR pickles it trains too; `cli/serve.py plc --ckpt` serves the
    checkpoint. All rc 0.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.data import plc as jax_plc
from ddp_classification_pytorch_tpu.data import transforms as jax_tf
from ddp_classification_pytorch_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from ddp_classification_pytorch_tpu.parallel import mesh as meshlib
from ddp_classification_pytorch_tpu.train import loop as jax_loop
from ddp_classification_pytorch_tpu.train import plc_loop as jax_plc_loop
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu.train import steps as jax_steps
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.data import plc, transforms as tf
from ddp_classification_pytorch_tpu_torch.data.synthetic import SyntheticDataset
from ddp_classification_pytorch_tpu_torch.models import factory, resnet
from ddp_classification_pytorch_tpu_torch.train import loop, schedule, steps
from ddp_classification_pytorch_tpu_torch.train.plc_loop import PLCTrainer
from ddp_classification_pytorch_tpu_torch.train.state import TrainState

import torch_port_heads as H
from test_torch_port_data import _assert_pixels_close, _write_cifar
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_DIR = os.path.join(REPO, "tests", "data", "torch_port_jpeg")
CPU = torch.device("cpu")
MARGIN = 1e-3  # of δ, against the port's f32 rounding (~1e-5 relative)


# ------------------------------------------------------------------ data --

@pytest.fixture(scope="module")
def clothing(tmp_path_factory):
    """A Clothing1M-style root: the test JPEGs in 3 class dirs, one corrupt
    file among them, annotations from JAX's `build_annotations`."""
    root = tmp_path_factory.mktemp("c1m")
    names = sorted(os.listdir(JPEG_DIR))
    for i, name in enumerate(names):
        d = root / f"c{i % 3}"
        d.mkdir(exist_ok=True)
        shutil.copy(os.path.join(JPEG_DIR, name), d / name)
    (root / "c2" / "bad.jpg").write_bytes(b"\xff\xd8" + bytes(range(256)) * 4)
    jax_plc.build_annotations(str(root), str(root / "annotations"),
                              val_frac=0.25, test_frac=0.0)
    return root


def test_build_annotations_and_check_bad_images_match_jax(clothing, tmp_path):
    for builder, sub in ((plc, "port"), (jax_plc, "jax")):
        builder.build_annotations(str(clothing), str(tmp_path / sub),
                                  val_frac=0.25, test_frac=0.1, seed=3)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 5
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name
    bad = plc.check_bad_images(str(clothing), num_workers=3)
    assert bad == jax_plc.check_bad_images(str(clothing)) == ["c2/bad.jpg"]
    keys = ["c0/img0.jpg", "c2/bad.jpg", "missing.jpg"]
    assert (plc.check_bad_images(str(clothing), keys)
            == jax_plc.check_bad_images(str(clothing), keys)
            == keys[1:])


@pytest.mark.parametrize("cls_size", [0, 2])
def test_plc_dataset_matches_jax(clothing, cls_size):
    for split, train in (("train", True), ("val", False)):
        mine = plc.PLCDataset.from_annotations(
            str(clothing), split, tf.build_transform("clothing1m", train, 32,
                                                     40, "uint8"),
            cls_size=cls_size, num_classes=3)
        theirs = jax_plc.PLCDataset.from_annotations(
            str(clothing), split, jax_tf.build_transform(
                "clothing1m", train, 32, 40, "uint8"),
            cls_size=cls_size, num_classes=3)
        assert mine.keys == theirs.keys and len(mine) > 0
        assert np.array_equal(mine.labels, theirs.labels)
        assert np.array_equal(mine.clean_labels, theirs.clean_labels)
        for i in range(len(mine)):
            if mine.keys[i] == "c2/bad.jpg":
                continue
            a = mine.__getitem__(i, np.random.default_rng(i))
            b = theirs.__getitem__(i, np.random.default_rng(i))
            assert a[1:] == b[1:] == (int(mine.labels[i]), i)
            _assert_pixels_close(a[0], b[0], mine.keys[i])
    new = (mine.labels + 1) % 3
    mine.update_corrupted_label(new)
    assert np.array_equal(mine.labels, new)
    with pytest.raises(ValueError, match="label shape"):
        mine.update_corrupted_label(new[:-1])


def test_build_datasets_for_plc(clothing):
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
        ["plc", "--dataset", "plc", "--train_dir", str(clothing),
         "--imgs_per_class", "2", "--image_size", "32", "--crop_size", "40"]))
    train, val = loop.build_datasets(cfg)
    want = jax_plc.PLCDataset.from_annotations(
        str(clothing), "train", None, cls_size=2)
    assert train.keys == want.keys and loop.decodes_items(train)
    assert (train.transform.kind, train.transform.train, val.transform.train,
            train.transform.out_size) == ("clothing1m", True, False, 32)
    assert loop.make_native_batcher(train, cfg, True) is None


# --------------------------------------------------------- predict step --

IMAGE, BATCH = 32, 8


def _f64_model(params, stats):
    """The port's reduced net from JAX's weights in f64 but for the f32
    pool and fc, as the JAX net's dtype policy (`resnet.py:168-170`)."""
    model = factory.ClassifierModel(resnet.ResNet(
        block_cls=resnet.Bottleneck, dtype=torch.float64,
        num_classes=H.CLASSES, **H.STAGES))
    model.load_state_dict(H.FROM_JAX["fc"](params, stats))
    model.double().backbone.fc.float()
    return model.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("batch_stat_mode", [False, True],
                         ids=["running", "batch-stat"])
def test_predict_step_matches_jax_in_f64(batch_stat_mode):
    """Both nets in f64 up to their f32 pool and fc (the JAX net's dtype
    policy, `resnet.py:168-170` there). On the float32 wire (the same
    input on both sides) the last block's f64 output within 1e-9
    relative (captured on both sides) and the f32 logits of
    `make_predict_step` within TOL; on the uint8 wire the logits within
    TOL (XLA rewrites the epilogue's division: its f32 input is 1 ulp off
    torch's on 75% of the pixels)."""
    params, stats = H.variables("fc", IMAGE)
    rng = np.random.default_rng(4)
    wires = {"float32": rng.normal(size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
             "uint8": rng.integers(0, 256, (BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)}
    jcfg, cfg = H.cfgs("plc", IMAGE, BATCH)
    with jax.enable_x64(True):
        jmodel = H.jax_model("fc")
        tx = jax_schedule.build_optimizer(jcfg.optim, 1)
        jstate = H.jax_state(params, stats, tx)
        jstep = jax_steps.make_predict_step(jcfg, jmodel, batch_stat_mode)
        want = {k: np.asarray(jstep(jstate, jnp.asarray(x)))
                for k, x in wires.items()}
        v = {"params": jstate.params, "batch_stats": jstate.batch_stats}
        _, out = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=batch_stat_mode, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: m.name == "layer4_block0"))(
                v, jnp.asarray(wires["float32"]))
        want_feat = np.asarray(out["intermediates"]["backbone"][
            "layer4_block0"]["__call__"][0])
    model = _f64_model(params, stats)
    feats = []
    model.backbone.layer4.register_forward_hook(
        lambda m, i, o: feats.append(o.permute(0, 2, 3, 1).numpy()))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = type("S", (), {"model": model})()
    step = steps.make_predict_step(cfg, batch_stat_mode)
    got = {k: step(state, torch.from_numpy(x)).numpy() for k, x in wires.items()}
    assert feats[0].dtype == want_feat.dtype == np.float64
    np.testing.assert_allclose(feats[0], want_feat, rtol=1e-9,
                               atol=1e-9 * np.abs(want_feat).max())
    for k in wires:
        assert got[k].dtype == want[k].dtype == np.float32
        assert got[k].shape == (BATCH, 10)
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **H.TOL)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    if batch_stat_mode:  # the batch's statistics, not the running ones
        running = steps.make_predict_step(cfg)(
            state, torch.from_numpy(wires["uint8"])).numpy()
        assert not np.allclose(running, got["uint8"], rtol=1e-3)


# ---------------------------------------------------------------- trainer --

N, TRAIN_BATCH = 100, 16


def _trainer_cfgs(out):
    jcfg, cfg = H.cfgs("plc", IMAGE, TRAIN_BATCH, lr=3e-4)
    for c, sub in ((jcfg, "jax"), (cfg, "port")):
        c.data.synthetic_size, c.data.num_workers = N, 0
        c.run.epochs, c.plc.warmup_epochs = 2, 1
        c.plc.noise_type = 1
        c.run.log_every = 100
        c.run.out_dir = str(out / sub)
    return jcfg, cfg


def test_two_epoch_plc_trainer_matches_jax(tmp_path, monkeypatch):
    jcfg, cfg = _trainer_cfgs(tmp_path)
    params, stats = H.variables("fc", IMAGE)
    eta = np.random.default_rng(22).dirichlet(np.full(10, 0.3), N)
    spec = meshlib.MeshSpec(1, 1, 1)
    with jax.enable_x64(True):
        jmodel = H.jax_model("fc")
        tx = jax_schedule.build_optimizer(jcfg.optim, 1)
        monkeypatch.setattr(jax_loop, "create_train_state", lambda *a, **k: (
            jmodel, tx, H.jax_state(params, stats, tx)))
        jtrainer = jax_plc_loop.PLCTrainer(
            jcfg, JaxSynthetic(N, IMAGE, 10, seed=jcfg.run.seed,
                               out_dtype="float32"),
            JaxSynthetic(25, IMAGE, 10, seed=jcfg.run.seed, item_offset=N,
                         out_dtype="float32"),
            meshlib.make_mesh(spec, jax.devices()[:1]), eta=eta)
        injected = np.asarray(jtrainer.train_ds.labels).copy()
        seen = []
        real = jtrainer.predict_train_logits
        jtrainer.predict_train_logits = lambda: seen.append(real()) or seen[-1]
        jlast = jtrainer.run()
    def port_state(*args, **kw):
        model, o = _f64_model(params, stats), cfg.optim
        return TrainState(model, schedule.build_optimizer(
            o, schedule.param_groups(o, model, False)),
            schedule.build_schedule(o, 1))

    monkeypatch.setattr(loop, "create_train_state", port_state)
    trainer = PLCTrainer(cfg, CPU, eta=eta)
    assert np.array_equal(trainer.train_ds.labels, injected)
    assert trainer.injected == int((injected != SyntheticDataset(
        N, IMAGE, 10, seed=cfg.run.seed).labels).sum()) > 0
    # no LRT ratio of JAX's pass near δ: f32 rounding cannot flip a label
    f_x = seen[0]
    p = np.exp(f_x - f_x.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    ratio = p[np.arange(N), injected] / p.max(1)
    assert np.abs(ratio - jcfg.plc.current_delta).min() > MARGIN
    mine = []
    real_port = trainer.predict_train_logits
    trainer.predict_train_logits = lambda: mine.append(real_port()) or mine[-1]
    last = trainer.run()
    np.testing.assert_allclose(mine[0], seen[0], **H.TOL)
    assert np.array_equal(trainer.train_ds.labels, jtrainer.train_ds.labels)
    assert trainer.corrections_per_epoch == jtrainer.corrections_per_epoch
    assert trainer.corrections_per_epoch[0] > 0
    assert trainer.delta == jtrainer.delta
    for k in ("loss", "val_loss", "corrected", "delta"):
        np.testing.assert_allclose(last[k], jlast[k], err_msg=k, **H.TOL)
    for sub in ("jax", "port"):
        meta = json.loads((tmp_path / sub / "meta.json").read_text())
        assert meta["plc_delta"] == trainer.delta and meta["last_epoch"] == 1
        assert np.array_equal(np.load(tmp_path / sub / "plc_labels.npy"),
                              trainer.train_ds.labels)


# -------------------------------------------------------------------- CLI --

SYNTH = ["plc", "--dataset", "synthetic", "--synthetic_size", "24",
         "--model", "resnet18", "--image_size", "32", "--num_classes", "4",
         "--batchsize", "8", "--plc_warmup_epochs", "1", "--dtype", "float32",
         "--num_workers", "1", "--device", "cpu"]


def _main(argv):
    try:
        train_cli.main(argv)
    except SystemExit as e:
        raise AssertionError(f"rc {e.code}") from None


def test_cli_plc_trains_resumes_and_serves(tmp_path, capsys):
    out = str(tmp_path / "run")
    _main(SYNTH + ["--epochs", "2", "--out", out])
    log = capsys.readouterr().out
    assert "[plc epoch 1] " in log and " corrected=" in log and " delta=" in log
    labels = np.load(os.path.join(out, "plc_labels.npy"))
    delta = json.loads(open(os.path.join(out, "meta.json")).read())["plc_delta"]
    assert labels.shape == (24,)
    _main(SYNTH + ["--epochs", "3", "--out", out, "--auto_resume"])
    log = capsys.readouterr().out
    assert "auto-resumed" in log and "restored corrected labels" in log
    assert "[plc epoch 2] " in log and "[plc epoch 0] " not in log
    # the resumed run starts from the saved δ (it can only grow or stay)
    assert json.loads(open(os.path.join(out, "meta.json")).read())[
        "plc_delta"] >= delta
    try:
        serve_cli.main(["plc", "--model", "resnet18", "--image_size", "32",
                        "--num_classes", "4", "--dtype", "float32", "--device",
                        "cpu", "--topk", "2", "--ckpt",
                        os.path.join(out, "ckpt_e2.pt"),
                        "--selfcheck", "2"])
    except SystemExit as e:
        assert e.code in (0, None), f"rc {e.code}"


def test_resume_restores_labels_and_delta_without_reinjecting(tmp_path):
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
        SYNTH + ["--epochs", "1", "--out", str(tmp_path)]))
    cfg.plc.noise_type = 0
    eta = np.random.default_rng(1).dirichlet(np.ones(4), 24)
    first = PLCTrainer(cfg, CPU, eta=eta)
    assert first.injected > 0
    first.run()
    saved = np.load(tmp_path / "plc_labels.npy")
    assert np.array_equal(saved, first.train_ds.labels)
    meta = json.loads((tmp_path / "meta.json").read_text())
    meta["plc_delta"] = 0.55
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    cfg.run.resume, cfg.run.epochs = str(tmp_path / "ckpt_e0.pt"), 2
    again = PLCTrainer(cfg, CPU, eta=eta[::-1].copy())
    assert again.injected == 0 and again.delta == 0.55 and again.start_epoch == 1
    assert np.array_equal(again.train_ds.labels, saved)


def test_prob_correction_with_a_flip_cap_and_on_cifar(tmp_path, capsys):
    root = _write_cifar(tmp_path, "cifar10", np.random.default_rng(3))
    _main(["plc", "--dataset", "cifar10", "--train_dir", root, "--model",
           "resnet18", "--batchsize", "6", "--epochs", "2", "--lr", "0.5",
           "--plc_warmup_epochs", "0", "--correction", "prob",
           "--plc_max_flip_frac", "0.1", "--dtype", "float32",
           "--num_workers", "2", "--device", "cpu", "--out",
           str(tmp_path / "run")])
    hist = json.loads((tmp_path / "run" / "history.json").read_text())
    # 30 CIFAR pickles at most 3 flips a pass; the cap bit in the first
    assert len(hist["corrected"]) == 2 and max(hist["corrected"]) <= 3
    assert "[plc] capped correction: " in capsys.readouterr().out

