"""ViT training in the torch port against the JAX package, on the CPU: the
train and eval steps, the LR schedule, the loader's indices, the top-k
rule, the sentinel and the train CLI.

Train-step parity: the reduced ViT (depth 2, width 64, 2 heads, 64 px, 10
classes, f32, flash path with the kernels' plain versions on the port's
side and the Pallas kernels in interpret mode on the JAX side), the same
weights (`vit_from_jax`) and the same synthetic batch. SGD with momentum
and weight decay under a warmup + StepLR overlay; loss, grad norm and every
parameter after each step within atol 1e-5 / rtol 1e-4 (f32 sums taken in
another order). Schedule values and loader indices are exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.config import get_preset as jax_preset
from ddp_classification_pytorch_tpu.data import loader as jax_loader
from ddp_classification_pytorch_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from ddp_classification_pytorch_tpu.models.factory import ClassifierModel as JaxClassifier
from ddp_classification_pytorch_tpu.models.vit import ViT as JaxViT
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu.train import steps as jax_steps
from ddp_classification_pytorch_tpu.train.state import TrainState as JaxTrainState
from ddp_classification_pytorch_tpu.utils.metrics import topk_hits as jax_topk_hits
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.config import OptimConfig, get_preset
from ddp_classification_pytorch_tpu_torch.data import loader
from ddp_classification_pytorch_tpu_torch.data.synthetic import SyntheticDataset
from ddp_classification_pytorch_tpu_torch.models import vit
from ddp_classification_pytorch_tpu_torch.models.convert import vit_from_jax
from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel
from ddp_classification_pytorch_tpu_torch.train import checkpoint, schedule, steps
from ddp_classification_pytorch_tpu_torch.train.sentinel import (
    SentinelDiverged,
    StepSentinel,
)
from ddp_classification_pytorch_tpu_torch.train.state import TrainState
from ddp_classification_pytorch_tpu_torch.utils.metrics import topk_hits

from torch_port_helpers import OPTIM
from torch_port_threads import one_torch_thread  # noqa: F401

REDUCED = dict(patch=16, dim=64, depth=2, heads=2, num_classes=10)
IMAGE, BATCH = 64, 4


def _cfgs(input_dtype):
    """(JAX cfg, port cfg) of the same baseline recipe on synthetic data."""
    cfgs = (jax_preset("baseline"), get_preset("baseline"))
    for cfg in cfgs:
        cfg.data.dataset, cfg.data.input_dtype = "synthetic", input_dtype
        cfg.data.image_size, cfg.data.num_classes = IMAGE, 10
        cfg.data.batch_size = BATCH
        for k, v in OPTIM.items():
            setattr(cfg.optim, k, v)
    return cfgs


def _jax_model():
    return JaxClassifier(backbone=JaxViT(dtype=jnp.float32, use_flash=True,
                                         flash_min_tokens=0, **REDUCED))


@pytest.fixture(scope="module")
def params():
    """numpy: the JAX train step donates its state, so each test places its
    own copy."""
    x = jnp.zeros((1, IMAGE, IMAGE, 3))
    return jax.tree_util.tree_map(np.array, jax.jit(
        lambda k: _jax_model().init(k, x, train=False))(
        jax.random.PRNGKey(1))["params"])


def _states(params, input_dtype, steps_per_epoch=1):
    jcfg, cfg = _cfgs(input_dtype)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_schedule.build_optimizer(jcfg.optim, steps_per_epoch)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats={}, opt_state=tx.init(params))
    jstep = jax_steps.make_train_step(jcfg, _jax_model(), tx)
    model = ClassifierModel(vit.ViT(image_size=IMAGE, dtype=torch.float32,
                                    use_flash=True, flash_min_tokens=0,
                                    **REDUCED))
    model.load_state_dict({f"backbone.{k}": v
                           for k, v in vit_from_jax(params).items()})
    state = TrainState(model, schedule.build_optimizer(cfg.optim, model.parameters()),
                       schedule.build_schedule(cfg.optim, steps_per_epoch))
    return (jcfg, jstate, jstep), (cfg, state, steps.make_train_step(cfg))


def _batch(input_dtype, seed):
    ds = SyntheticDataset(BATCH, IMAGE, 10, seed=seed, out_dtype=input_dtype)
    items = [ds[i] for i in range(BATCH)]
    return (np.stack([im for im, _ in items]),
            np.asarray([lb for _, lb in items], np.int32))


def _assert_params_match(jparams, model):
    want = vit_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    got = model.backbone.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def _step_both(j, p, images, labels):
    jcfg, jstate, jstep = j
    _, state, step = p
    jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
    m = step(state, torch.from_numpy(images), torch.from_numpy(labels))
    for key in ("loss", "grad_norm", "top1", "top3", "step_ok"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), atol=1e-5,
                                   rtol=1e-4, err_msg=key)
    return (jcfg, jstate, jstep), m


def test_two_train_steps_match_jax(params):
    j, p = _states(params, "uint8")
    for seed in (10, 11):
        j, m = _step_both(j, p, *_batch("uint8", seed))
        assert float(m["step_ok"]) == 1.0
    _assert_params_match(j[1].params, p[1].model)
    assert p[1].step == int(j[1].step) == 2 and p[1].opt_count == 2


def test_skip_step_gate_on_a_nan_batch(params):
    """good, NaN, good: the NaN step leaves the parameters, the momentum
    and the schedule's count as they were and still advances the step
    counter, on both sides — the third step runs at the lr of the second
    update, not the third."""
    j, p = _states(params, "float32")
    images, labels = _batch("float32", 12)
    j, _ = _step_both(j, p, images, labels)
    before = {k: v.clone() for k, v in p[1].model.state_dict().items()}
    bad = images.copy()
    bad[1, 3, 5, 0] = np.nan
    j, m = _step_both(j, p, bad, labels)
    assert float(m["step_ok"]) == 0.0
    for k, v in p[1].model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert p[1].step == 2 and p[1].opt_count == 1
    j, m = _step_both(j, p, *_batch("float32", 13))
    assert float(m["step_ok"]) == 1.0 and p[1].opt_count == 2
    _assert_params_match(j[1].params, p[1].model)


def test_eval_counts_match_jax(params):
    jcfg, cfg = _cfgs("uint8")
    images, labels = _batch("uint8", 14)
    valid = np.array([1, 1, 1, 0], np.float32)
    want = jax_steps.make_eval_step(jcfg, _jax_model())(
        JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats={}, opt_state=()),
        jnp.asarray(images), jnp.asarray(labels), jnp.asarray(valid))
    (_, _, _), (_, state, _) = _states(params, "uint8")
    got = steps.make_eval_step(cfg)(state, torch.from_numpy(images),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(valid))
    for key in ("loss_sum", "top1", "top3", "n"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("optim", [
    dict(schedule="step", step_size=2, gamma=0.1),
    dict(schedule="multistep", milestones=(1, 3), gamma=0.5),
    dict(schedule="constant"),
    dict(schedule="multistep", milestones=(2, 5), warmup_iters=7,
         warmup_start_lr=1e-6),
], ids=["step", "multistep", "constant", "warmup-overlay"])
def test_schedule_matches_jax(optim):
    """Equal to optax's f32 schedule at every step of the first 8 epochs."""
    spe = 3
    want = jax_schedule.build_schedule(
        jax_preset("baseline").optim.__class__(lr=0.1, **optim), spe)
    got = schedule.build_schedule(OptimConfig(lr=0.1, **optim), spe)
    for s in range(0, 8 * spe):
        assert got(s) == float(want(jnp.asarray(s, jnp.int32))), s


@pytest.mark.parametrize("n,batch,shuffle", [(37, 8, True), (37, 8, False),
                                             (5, 16, False), (64, 32, True)])
def test_loader_indices_and_valid_mask_match_jax(n, batch, shuffle):
    for epoch in (0, 3):
        np.testing.assert_array_equal(
            loader.shard_indices_for_host(n, epoch, 999, batch, shuffle),
            jax_loader.shard_indices_for_host(n, epoch, 999, batch, shuffle,
                                              host_id=0, num_hosts=1))
    ds = SyntheticDataset(n, 8, 10, seed=5)
    mine = loader.Loader(ds, batch, shuffle=shuffle, seed=999)
    theirs = jax_loader.ShardedLoader(JaxSynthetic(n, 8, 10, seed=5), batch,
                                      shuffle=shuffle, seed=999, num_workers=1,
                                      host_id=0, num_hosts=1)
    assert len(mine) == len(theirs)
    batches = list(mine)
    for b, (images, labels) in enumerate(theirs):
        np.testing.assert_array_equal(batches[b][0], images)
        np.testing.assert_array_equal(batches[b][1], labels)
        if not shuffle:
            np.testing.assert_array_equal(mine.valid_mask(b), theirs.valid_mask(b))
    theirs.close()


def test_synthetic_uint8_pixels_match_jax():
    mine = SyntheticDataset(6, 16, 5, seed=3, item_offset=9, out_dtype="uint8")
    theirs = JaxSynthetic(6, 16, 5, seed=3, item_offset=9, out_dtype="uint8")
    for i in range(6):
        np.testing.assert_array_equal(mine[i][0], theirs[i][0])
        assert mine[i][1] == theirs[i][1]


def test_topk_hits_ties_and_nan_rows_match_jax():
    """Ties count against the sample; a non-finite row is a miss."""
    logits = np.array([[1.0, 1.0, 0.0, 2.0],   # label 0 tied with class 1
                       [0.5, 0.5, 0.5, 0.5],   # all tied
                       [np.nan, 3.0, 1.0, 0.0],  # NaN row
                       [0.0, 1.0, 2.0, 3.0]], np.float32)
    labels = np.array([0, 2, 1, 3], np.int32)
    for k in (1, 2, 3):
        want = np.asarray(jax_topk_hits(jnp.asarray(logits), jnp.asarray(labels), k))
        got = topk_hits(torch.from_numpy(logits), torch.from_numpy(labels), k)
        np.testing.assert_array_equal(got.numpy(), want)
    assert not topk_hits(torch.from_numpy(logits), torch.from_numpy(labels), 4)[2]


def test_sentinel_raises_rc8_after_consecutive_skips():
    lines = []
    s = StepSentinel(max_bad_steps=3, log=lines.append)
    for ok in (0.0, 1.0, 0.0, 0.0):
        s.observe(torch.tensor(ok))
    s.flush()  # streak 2: not yet
    assert s.streak == 2 and s.skipped_total == 3 and lines
    s.observe(0.0)
    with pytest.raises(SentinelDiverged) as e:
        s.flush()
    assert e.value.exit_code == 8


TINY = ["baseline", "--dataset", "synthetic", "--synthetic_size", "16",
        "--model", "vit_t16", "--image_size", "32", "--num_classes", "10",
        "--batchsize", "8", "--flash_attention", "--flash_min_tokens", "0",
        "--epochs", "1", "--dtype", "float32"]


def _rc(argv):
    try:
        train_cli.main(argv)
    except SystemExit as e:
        return e.code
    return 0


def test_cli_cpu_run_writes_records_and_a_verified_checkpoint(tmp_path):
    out = str(tmp_path / "run")
    assert _rc(TINY + ["--device", "cpu", "--out", out]) == 0
    for name in ("output.txt", "history.json", "meta.json", "ckpt_e0.pt",
                 "ckpt_e0.pt.sha256"):
        assert os.path.isfile(os.path.join(out, name)), name
    sd = checkpoint.restore(os.path.join(out, "ckpt_e0.pt"))
    assert sd["step"] == sd["opt_count"] == 2 and sd["optimizer"]["state"]
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(TINY))
    from ddp_classification_pytorch_tpu_torch.models.factory import build_model

    build_model(cfg.model, 10, 32).load_state_dict(  # strict
        checkpoint.model_state(sd))
    with open(os.path.join(out, "output.txt")) as f:
        assert f.read().startswith("epoch:0\tloss:")


def test_cli_without_a_card_exits_3(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _rc(TINY + ["--out", str(tmp_path / "r")]) == 3


@pytest.mark.parametrize("extra", [
    ["--model", "densenet121"],        # arch not ported
    ["--dataset", "imagefolder"],      # no --train_dir
    ["--resume", "x.pt"],              # no such checkpoint
    ["--optimizer", "lamb"],           # unknown optimizer
], ids=["arch", "dataset", "flag", "optimizer"])
def test_cli_unported_or_bad_config_exits_2(tmp_path, extra):
    assert _rc(TINY + ["--device", "cpu", "--out", str(tmp_path / "r")]
               + extra) == 2


def test_cli_unported_workload_exits_2(tmp_path, capsys):
    """ArcFace's partial-FC CE (`--sharded_ce`) without a model axis is
    rc 2 with JAX's `_require_sharded_ce_mesh` text (the dense arcface
    head trains on every arch, TINY's ViT too). PLC trains the ViT (its
    head is the plain fc): rc 0, with the correction record."""
    assert _rc(["arcface"] + TINY[1:] + ["--device", "cpu", "--out",
                                         str(tmp_path / "sce"),
                                         "--sharded_ce"]) == 2
    assert ("arcface_sharded_ce requires a mesh with a model axis > 1 "
            "(--mp N); got mesh {'data': 1, 'model': 1}"
            in capsys.readouterr().err)
    assert _rc(["plc"] + TINY[1:] + ["--device", "cpu", "--plc_warmup_epochs",
                                     "0", "--out", str(tmp_path / "plc")]) == 0
    assert (tmp_path / "plc" / "plc_labels.npy").exists()


def test_cli_exits_8_after_max_bad_steps_consecutive_skips(monkeypatch, tmp_path):
    """Every step non-finite: the sentinel raises at the first flush that
    sees 25 consecutive skips (the default max_bad_steps) and the CLI exits
    rc 8; no epoch after the divergence is checkpointed."""
    from ddp_classification_pytorch_tpu_torch.train import loop

    def nan_step(cfg, chaos=None, mesh=None):
        def step(state, images, labels):
            state.step += 1
            nan = torch.tensor(float("nan"))
            return {"loss": nan, "top1": torch.tensor(0.0),
                    "top3": torch.tensor(0.0), "step_ok": torch.tensor(0.0),
                    "grad_norm": nan}
        return step

    monkeypatch.setattr(loop, "make_train_step", nan_step)
    out = tmp_path / "r"
    argv = TINY[:TINY.index("--epochs")] + [
        "--epochs", "13", "--dtype", "float32", "--device", "cpu",
        "--out", str(out)]
    assert _rc(argv) == 8  # 2 steps per epoch: the 25th skip is in epoch 12
    assert not (out / "ckpt_e12.pt").exists()
