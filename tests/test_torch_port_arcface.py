"""The port's ArcFace workload against the JAX package's, on the CPU.

(a) The margin math on the same f32 numpy inputs: `margin_splice` and
    `arc_margin_logits` at both easy-margin settings, with cosines past
    the flip point (cos θ ≤ 0 and cos θ ≤ cos(π − m)), within 1e-6 — the
    splice at s = 30, the logits at s = 1: their cos θ is a dot product
    summed in another order than XLA's (an f32 ulp of cos θ, which s = 30
    would scale to 4e-6); `arcface_naive_log_logits` within rtol 1e-5.
(b) The reduced ResNet-50 (stages (1, 1, 1, 1), 8 filters: 256 features)
    → embedding → margin head from JAX weights (`arcface_from_jax`; the
    margin's (C, D) weight is not transposed): margin logits with labels
    and s·cosθ without, in eval and training mode, and the running
    statistics the training forward leaves.
(c) Two train steps against JAX `make_train_step` with SGD (momentum,
    weight decay, warmup: torch_port_helpers.OPTIM) and a head lr ≠ lr,
    so the two param groups' schedules differ: loss, grad norm, every
    parameter and running statistic. SGD, not Adam: Adam turns a gradient
    whose sign rounding decides into a full lr-sized step (ROADMAP.md §3).
(d) The eval step on s·cosθ: JAX's `loss_sum`, `top1`, `top3` and `n`.
(e) Two-group Adam: `build_optimizer` over `param_groups` against
    `optax.multi_transform` (JAX `build_optimizer`) for 3 steps on fixed,
    well-conditioned gradients; `--head_lr` on a model without a margin
    head is rc 2.
(f) `cli/train.py arcface --device cpu` at 32 px with `--head_lr`: a run
    stopped after epoch 0 resumes with both param groups' Adam state
    restored bitwise and trains on; `cli/serve.py arcface --ckpt` serves
    the checkpoint with the trainer's top-5.

The port runs in f32 against JAX in f64 (`jax.enable_x64`) at atol 1e-5 /
rtol 1e-4 in (b)-(d), as tests/test_torch_port_resnet.py does.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.config import OptimConfig as JaxOptimConfig
from ddp_classification_pytorch_tpu.ops import arcface as jax_arcface
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu.train import steps as jax_steps
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.config import OptimConfig
from ddp_classification_pytorch_tpu_torch.models.heads import ArcMarginHead
from ddp_classification_pytorch_tpu_torch.ops import arcface
from ddp_classification_pytorch_tpu_torch.train import checkpoint, schedule, steps
from ddp_classification_pytorch_tpu_torch.train.loop import Trainer

import torch_port_heads as H
from torch_port_helpers import OPTIM

# ------------------------------------------------------------------- ops --


def _cosines(rng, b, c):
    """(B, C) cosines over [−1, 1], with some past both flip points."""
    cos = rng.uniform(-1.0, 1.0, (b, c)).astype(np.float32)
    cos[0, :4] = [-0.99, -0.9, -0.5, 0.0]  # below cos(π − 0.5) ≈ −0.878, ≤ 0
    return cos


@pytest.mark.parametrize("easy", [True, False], ids=["easy", "hard"])
def test_margin_math_matches_jax(easy):
    rng = np.random.default_rng(1)
    b, c, d = 6, 9, 16
    cos = _cosines(rng, b, c)
    labels = rng.integers(0, c, b).astype(np.int32)
    labels[0] = 1
    one_hot = np.eye(c, dtype=np.float32)[labels]
    want = jax_arcface.margin_splice(jnp.asarray(cos), jnp.asarray(one_hot),
                                     30.0, 0.5, easy)
    got = arcface.margin_splice(torch.from_numpy(cos),
                                torch.from_numpy(one_hot), 30.0, 0.5, easy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    th = math.cos(math.pi - 0.5)
    assert (cos <= th).any() and (cos <= 0).any()
    f = rng.normal(size=(b, d)).astype(np.float32)
    w = rng.normal(size=(c, d)).astype(np.float32)
    want = jax_arcface.arc_margin_logits(jnp.asarray(f), jnp.asarray(w),
                                         jnp.asarray(labels), 1.0, 0.5, easy)
    got = arcface.arc_margin_logits(torch.from_numpy(f), torch.from_numpy(w),
                                    torch.from_numpy(labels), 1.0, 0.5, easy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_naive_log_logits_match_jax():
    rng = np.random.default_rng(2)
    f = rng.normal(size=(5, 12)).astype(np.float32)
    w = rng.normal(size=(12, 7)).astype(np.float32)
    want = jax_arcface.arcface_naive_log_logits(jnp.asarray(f), jnp.asarray(w))
    got = arcface.arcface_naive_log_logits(torch.from_numpy(f),
                                           torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


# ---------------------------------------------------------------- models --

def test_arcface_model_matches_jax():
    image = 32
    params, stats = H.variables("arcface", image)
    x = np.random.default_rng(3).normal(size=(4, image, image, 3)).astype(np.float32)
    labels = np.array([1, 7, 0, 7], np.int32)
    with jax.enable_x64(True):
        jm = H.jax_model("arcface")
        v = H.f64({"params": params, "batch_stats": stats})
        j_cos, j_eval, (j_train, mutated) = H.f32(jax.jit(lambda v, x, y: (
            jm.apply(v, x, None, train=False), jm.apply(v, x, y, train=False),
            jm.apply(v, x, y, train=True, mutable=["batch_stats"])))(
                v, jnp.asarray(x, jnp.float64), jnp.asarray(labels)))
    sd = H.FROM_JAX["arcface"](params, stats)
    assert torch.equal(sd["margin.weight"], torch.from_numpy(
        params["margin"]["weight"]))  # (C, D) as flax holds it
    pm = H.port_model("arcface")
    pm.load_state_dict(sd)
    pm.to(memory_format=torch.channels_last)
    t, y = torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(labels)

    def close(got, want, msg):
        np.testing.assert_allclose(got.numpy(), want, err_msg=msg, **H.TOL)

    with torch.no_grad():
        close(pm.eval()(t), j_cos, "s·cosθ")
        close(pm(t, y), j_eval, "eval-mode margin logits")
        close(pm.train()(t, y), j_train, "train-mode margin logits")
    want = H.FROM_JAX["arcface"](params, mutated["batch_stats"])
    got = pm.state_dict()
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            close(got[k], want[k].numpy(), k)


# ----------------------------------------------------------- train steps --

IMAGE, BATCH = 64, 4
HEAD = dict(OPTIM, head_lr=0.02, head_weight_decay=5e-4)


def test_two_arcface_steps_with_a_head_lr_match_jax():
    jcfg, cfg = H.cfgs("arcface", IMAGE, BATCH, **HEAD)
    assert cfg.optim.optimizer == "sgd" and cfg.model.arc_easy_margin
    params, stats = H.variables("arcface", IMAGE)
    tx = jax_schedule.build_optimizer(jcfg.optim, 1)
    jstep = jax_steps.make_train_step(jcfg, H.jax_model("arcface"), tx)
    state = H.port_state("arcface", cfg, params, stats)
    groups = state.optimizer.param_groups
    assert len(groups) == 2 and groups[1]["head"]
    assert [p.shape for p in groups[1]["params"]] == [(H.CLASSES, H.EMBED)]
    step = steps.make_train_step(cfg)
    with jax.enable_x64(True):
        jstate = H.jax_state(params, stats, tx)
    for s in range(2):
        images, labels = H.batch(IMAGE, BATCH, 40 + s)
        with jax.enable_x64(True):
            jstate, jm = jstep(jstate, jnp.asarray(images, jnp.float64),
                               jnp.asarray(labels))
        m = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        for key in ("loss", "grad_norm", "top1", "top3", "step_ok"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=key, **H.TOL)
        H.assert_state_matches("arcface", jstate, state.model)
        assert groups[0]["lr"] != groups[1]["lr"]
    assert state.step == state.opt_count == 2


def test_arcface_eval_scores_cosines_as_jax():
    jcfg, cfg = H.cfgs("arcface", IMAGE, BATCH)
    params, stats = H.variables("arcface", IMAGE)
    images, labels = H.batch(IMAGE, BATCH, 50)
    valid = np.array([1, 1, 1, 0], np.float32)
    with jax.enable_x64(True):
        jstate = H.jax_state(params, stats,
                             jax_schedule.build_optimizer(jcfg.optim, 1))
        want = jax_steps.make_eval_step(jcfg, H.jax_model("arcface"))(
            jstate, jnp.asarray(images, jnp.float64), jnp.asarray(labels),
            jnp.asarray(valid))
    got = steps.make_eval_step(cfg)(
        H.port_state("arcface", cfg, params, stats), torch.from_numpy(images),
        torch.from_numpy(labels), torch.from_numpy(valid))
    for key in ("loss_sum", "top1", "top3", "n"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   err_msg=key, **H.TOL)


def test_two_group_adam_matches_optax_multi_transform():
    """3 Adam steps over a backbone and a margin group with their own lr
    and weight decay under a warmup, on fixed gradients (f32 both sides)."""
    kw = dict(optimizer="adam", lr=1e-3, head_lr=5e-3, weight_decay=1e-4,
              head_weight_decay=0.0, schedule="step", step_size=1, gamma=0.5,
              warmup_iters=2, warmup_start_lr=1e-4)
    rng = np.random.default_rng(6)
    w0 = {"backbone": {"weight": rng.normal(size=(4, 3)).astype(np.float32),
                       "bias": rng.normal(size=(4,)).astype(np.float32)},
          "margin": {"weight": rng.normal(size=(5, 3)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) + 0.5, w0)
        for _ in range(3)]
    tx = jax_schedule.build_optimizer(JaxOptimConfig(**kw), 1)
    params = jax.tree_util.tree_map(jnp.asarray, w0)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

    cfg = OptimConfig(**kw)
    model = torch.nn.Module()
    model.backbone = torch.nn.Linear(3, 4)
    model.margin = ArcMarginHead(5, 3)
    with torch.no_grad():
        model.backbone.weight.copy_(torch.from_numpy(w0["backbone"]["weight"]))
        model.backbone.bias.copy_(torch.from_numpy(w0["backbone"]["bias"]))
        model.margin.weight.copy_(torch.from_numpy(w0["margin"]["weight"]))
    from ddp_classification_pytorch_tpu_torch.train.state import TrainState

    state = TrainState(model, schedule.build_optimizer(
        cfg, schedule.param_groups(cfg, model)),
        schedule.build_schedule(cfg, 1),
        head_schedule=schedule.build_schedule(schedule.head_config(cfg), 1))
    for g in grads:
        for name, p in model.named_parameters():
            mod, leaf = name.split(".")
            p.grad = torch.from_numpy(g[mod][leaf].copy())
        state.set_lrs()
        state.optimizer.step()
        state.opt_count += 1
    for name, p in model.named_parameters():
        mod, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[mod][leaf]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def _rc(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        return e.code
    return 0


ARGV = ["--dataset", "synthetic", "--synthetic_size", "16", "--model",
        "resnet18", "--image_size", "32", "--num_classes", "10",
        "--batchsize", "4", "--dtype", "float32", "--num_workers", "1",
        "--device", "cpu"]


def test_head_lr_without_a_margin_head_is_rc2(tmp_path):
    for extra in (["--head_lr", "0.1"], ["--head_weight_decay", "0.1"]):
        assert _rc(train_cli.main, ["baseline", *ARGV, "--epochs", "1",
                                    "--out", str(tmp_path / "r"), *extra]) == 2


# ------------------------------------------------------------------- CLI --

def test_cli_arcface_resumes_both_groups_and_serves(tmp_path):
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert _rc(train_cli.main, ["arcface", *ARGV, "--head_lr", "0.003",
                                "--epochs", "1", "--out", one]) == 0
    first = os.path.join(one, "ckpt_e0.pt")
    saved = checkpoint.restore(first)
    assert len(saved["optimizer"]["param_groups"]) == 2
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
        ["arcface", *ARGV, "--head_lr", "0.003", "--epochs", "2",
         "--out", two, "--resumePth", first]))
    trainer = Trainer(cfg, torch.device("cpu"))
    assert trainer.start_epoch == 1
    restored = trainer.state.state_dict()
    for k, v in saved["model"].items():
        assert torch.equal(restored["model"][k], v), k
    assert restored["optimizer"]["param_groups"] == saved["optimizer"]["param_groups"]
    for i, st in saved["optimizer"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(restored["optimizer"]["state"][i][key], st[key])
    assert (restored["step"], restored["opt_count"]) == (4, 4)
    last = trainer.run()
    assert last["step_ok"] == 1.0 and trainer.state.step == 8
    ckpt = os.path.join(two, "ckpt_e1.pt")
    serve = serve_cli.config_from_args(serve_cli.build_parser().parse_args([
        "arcface", "--model", "resnet18", "--image_size", "32",
        "--num_classes", "10", "--dtype", "float32", "--device", "cpu",
        "--ckpt", ckpt]))
    engine = serve_cli.build_engine(serve, torch.device("cpu"))
    preds = serve_cli.run_selfcheck(engine, serve, 4)
    imgs = np.random.default_rng(serve.run.seed).integers(
        0, 256, (4, 32, 32, 3)).astype(np.uint8)
    _, idx = steps.make_topk_predict_step(serve, 5)(
        trainer.state.model.eval(), torch.from_numpy(imgs))
    assert [p.indices.tolist() for p in preds] == idx.tolist()
