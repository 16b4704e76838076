"""Gradient accumulation in the torch port (`parallel.grad_accum` K,
`train/steps.py::_microbatches`) against the JAX package's
(`_scan_microbatches`, `_accum_grad_section`), on the CPU.

(a) A ViT (LayerNorm, no dropout) at K = 4 × 8 and K = 1 × 32 runs the
    same update: three steps' losses and whole state within JAX's own pin
    of the same claim, 2e-4 (JAX `tests/test_grad_accum.py:36-50`). The
    BN nets are a different program at K > 1 (each microbatch normalizes
    with its own statistics), so they are held against JAX's K-step:
(b) the reduced ResNet-50 (JAX in f64; two steps) and the reduced
    TResNet-M (JAX in f32, its Pallas ABN in interpret mode; the port's
    plain K1 versions; one step) at K = 4: metrics, every parameter and
    running statistic at atol 1e-5 / rtol 1e-4, as the plain steps are
    held (tests/torch_port_heads.py);
(c) the arcface and nested heads at K = 2 on the reduced ResNet-50, and
    VGG nested at K = 2, with JAX's per-microbatch k (and dropout masks)
    handed in (`k` a list, `Dropout.next_mask` a list), at the same
    tolerance;
(d) two gloo ranks at K = 2 (tests/torch_port_scale_worker.py, `accum`:
    microbatches 0..K-2 under DDP's `no_sync`, ZeRO-1 on) against JAX's
    `_accum_grad_section` on a `data` = 2 mesh (the reduced ResNet-50 in
    f64, its SyncBN over the axis), at that tolerance; the two ranks'
    replicas bitwise equal;
(e) a nan_loss window skips the whole accumulated step bitwise (weights,
    momentum, running statistics, the update count), and the sentinel
    observes once a step, not once a microbatch;
(f) K = 1 with every lever at its default is the plain step, bitwise,
    written out here call for call;
(g) `build_schedule(..., grad_accum)` against JAX's at every step, and
    the rc-2 rejections (`grad-accum-indivisible`, the bf16 wire under
    nested over ranks, choices outside the flags').
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.config import OptimConfig as JaxOptimConfig
from ddp_classification_pytorch_tpu.models.factory import ClassifierModel as JaxClassifier
from ddp_classification_pytorch_tpu.models.tresnet import TResNet as JaxTResNet
from ddp_classification_pytorch_tpu.ops import nested as jax_nested
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.config import OptimConfig, get_preset
from ddp_classification_pytorch_tpu_torch.data.synthetic import SyntheticDataset
from ddp_classification_pytorch_tpu_torch.models import tresnet, vgg
from ddp_classification_pytorch_tpu_torch.models.convert import tresnet_from_jax
from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel
from ddp_classification_pytorch_tpu_torch.train import schedule, steps
from ddp_classification_pytorch_tpu_torch.train.loop import Trainer
from ddp_classification_pytorch_tpu_torch.train.state import create_train_state

import torch_port_heads as H
from torch_port_scale import collect_scale_worker, jax_dp2_run, spawn_scale_worker
from torch_port_helpers import OPTIM, REDUCED, init_variables, randomize_bn
from torch_port_steps import SideBySide, batch, cfgs
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-4)
IMAGE = 64


def _jax_mb_rngs(jcfg, step, i):
    """(mask_rng, drop_rng) of microbatch `i` of JAX's accumulated step
    at `step` (`_build_step` folds the step in, `_scan_microbatches` the
    microbatch, `_dense_loss_fn` splits)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(jcfg.run.seed + 1), step)
    return jax.random.split(jax.random.fold_in(rng, i))


def _set_accum(k, *cfgs_):
    for c in cfgs_:
        c.parallel.grad_accum = k


# ------------------------------------------------------- (a) ViT, K=4 vs 1 --

def _vit_cfg(k):
    cfg = get_preset("baseline")
    cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
    cfg.data.image_size, cfg.data.num_classes = 32, 4
    cfg.data.batch_size = 32
    cfg.model.arch, cfg.model.dtype = "vit_t16", "float32"
    cfg.parallel.grad_accum = k
    return cfg


def test_vit_accum4_equals_one_batch_of_32():
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.normal(size=(32, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, 32).astype(np.int32))
    runs = []
    for k in (4, 1):
        cfg = _vit_cfg(k)
        state = create_train_state(cfg, torch.device("cpu"), 4)
        step = steps.make_train_step(cfg)
        losses = [float(step(state, images, labels)["loss"]) for _ in range(3)]
        runs.append((losses, state.state_dict()))
    (l4, s4), (l1, s1) = runs
    np.testing.assert_allclose(l4, l1, rtol=2e-4, atol=2e-4)
    for k, v in s1["model"].items():
        np.testing.assert_allclose(s4["model"][k].numpy(), v.numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    for i, v in s1["optimizer"]["state"].items():
        np.testing.assert_allclose(
            s4["optimizer"]["state"][i]["momentum_buffer"].numpy(),
            v["momentum_buffer"].numpy(), rtol=2e-4, atol=2e-4)
    assert s4["step"] == s4["opt_count"] == 3


# --------------------------------------------- (b) the K-step against JAX --

def test_resnet_accum4_steps_match_jax_scan():
    jcfg, cfg = H.cfgs("baseline", IMAGE, 16, **OPTIM)
    _set_accum(4, jcfg, cfg)
    params, stats = H.variables("fc", IMAGE)
    both = SideBySide(jcfg, cfg, H.jax_model("fc"), H.port_model("fc"),
                      H.FROM_JAX["fc"], params, stats)
    before = {k: v.clone() for k, v in both.state.model.state_dict().items()}
    for s in range(2):
        m = both.step(*H.batch(IMAGE, 16, 60 + s))
        assert float(m["step_ok"]) == 1.0
    moved = [k for k, v in both.state.model.state_dict().items()
             if k.endswith("running_mean") and not torch.equal(v, before[k])]
    assert len(moved) == 17  # every BN took its microbatches' statistics
    assert both.state.step == both.state.opt_count == 2


def _jax_tresnet():
    return JaxClassifier(backbone=JaxTResNet(dtype=jnp.float32, **REDUCED))


def _synthetic_batch(n, seed):
    """The float32 images of tests/test_torch_port_tresnet_train.py."""
    ds = SyntheticDataset(n, IMAGE, 10, seed=seed, out_dtype="float32")
    items = [ds[i] for i in range(n)]
    return (np.stack([im for im, _ in items]),
            np.asarray([lb for _, lb in items], np.int32))


def test_tresnet_accum4_step_matches_jax_scan():
    """One K = 4 step at batch 16 (microbatches of 4, the batch at which
    the plain TResNet steps are held for two steps): at batch 8-16 the
    plain K = 1 step's second step already leaves atol 1e-5 on these
    random weights, JAX f32 and f64 agreeing where the port does not
    (ROADMAP.md queue 3), so a second accumulated step would test that,
    not accumulation."""
    jcfg, cfg = cfgs("baseline", "tresnet_m", IMAGE, 16, 10, **OPTIM)
    _set_accum(4, jcfg, cfg)
    jmodel = _jax_tresnet()
    v = init_variables(jmodel, IMAGE)
    params, stats = randomize_bn(v["params"], v["batch_stats"],
                                 np.random.default_rng(0))

    def from_jax(p, s):
        return {f"backbone.{k}": t for k, t in tresnet_from_jax(p, s).items()}

    both = SideBySide(jcfg, cfg, jmodel, ClassifierModel(tresnet.TResNet(
        dtype=torch.float32, **REDUCED)), from_jax, params, stats, x64=False)
    before = {k: v.clone() for k, v in both.state.model.state_dict().items()}
    m = both.step(*_synthetic_batch(16, 10))
    assert float(m["step_ok"]) == 1.0
    moved = [k for k, v in both.state.model.state_dict().items()
             if k.endswith("running_mean") and not torch.equal(v, before[k])]
    assert len(moved) == 14  # 7 ABN + 7 BN, each over 4 microbatches
    assert both.state.step == both.state.opt_count == 1


# ------------------------------------------------- (c) the heads at K = 2 --

@pytest.mark.parametrize("workload", ["arcface", "nested"])
def test_head_accum2_steps_match_jax_scan(workload):
    optim = dict(OPTIM, head_lr=0.02) if workload == "arcface" else OPTIM
    jcfg, cfg = H.cfgs(workload, IMAGE, 8, **optim)
    _set_accum(2, jcfg, cfg)
    for c in (jcfg, cfg):
        c.model.nested_std = 40.0
    head = workload
    params, stats = H.variables(head, IMAGE)
    both = SideBySide(jcfg, cfg, H.jax_model(head, freeze_bn=(
        head == "nested")), H.port_model(head, freeze_bn=cfg.model.freeze_bn),
        H.FROM_JAX[head], params, stats)
    dist = jnp.asarray(jax_nested.gaussian_dist(0.0, 40.0, H.FEAT))
    for s in range(2):
        kw = {}
        if workload == "nested":
            kw["k"] = [int(jax_nested.sample_mask_dims(
                _jax_mb_rngs(jcfg, s, i)[0], dist)) for i in range(2)]
        m = both.step(*H.batch(IMAGE, 8, 80 + s), **kw)
        assert float(m["step_ok"]) == 1.0


def test_vgg_nested_accum2_with_jax_masks_matches_jax_scan():
    """VGG under nested at K = 2: each microbatch's k and dropout mask
    are JAX's (the masks captured as tests/test_torch_port_vgg.py does,
    on the microbatch's own dropout key), handed in as lists."""
    from test_torch_port_vgg import (CFG, _from_jax, _jax_dropout_masks,
                                     _jax_model, _port_model)

    jcfg, cfg = cfgs("nested", "vgg19_bn", 32, 8, 10, **OPTIM)
    _set_accum(2, jcfg, cfg)
    assert CFG == (8, "M", 16, "M")
    jmodel = _jax_model("nested")
    from torch_port_helpers import random_variables

    params, stats = random_variables(_jax_model("nested", jnp.float32), 32,
                                     np.random.default_rng(3))
    both = SideBySide(jcfg, cfg, jmodel, _port_model("nested"),
                      _from_jax("nested"), params, stats)
    drop = next(m for m in both.state.model.modules()
                if isinstance(m, vgg.Dropout))
    capture = _jax_dropout_masks(jmodel)
    dist = jnp.asarray(jax_nested.gaussian_dist(
        0.0, jcfg.model.nested_std, vgg.WIDTH))
    for s in range(2):
        images, labels = batch(32, 8, 10, 90 + s)
        ks, masks = [], []
        for i in range(2):
            mask_rng, drop_rng = _jax_mb_rngs(jcfg, s, i)
            ks.append(int(jax_nested.sample_mask_dims(mask_rng, dist)))
            extra = (jax_nested.prefix_mask(jnp.asarray(ks[-1]), vgg.WIDTH),)
            masks += capture(both.jstate, images[i * 4:(i + 1) * 4], extra,
                             drop_rng)
        drop.next_mask = masks
        m = both.step(images, labels, k=ks)
        assert float(m["step_ok"]) == 1.0 and drop.next_mask is None


# ------------------------------------------------- (d) two ranks at K = 2 --

def _accum_batches():
    return [H.batch(IMAGE, 8, 100 + s) for s in range(2)]


def test_two_ranks_accum2_match_jax_accum_grad_section(tmp_path):
    procs = spawn_scale_worker(tmp_path, ["accum"], [], _accum_batches())
    jcfg, _ = H.cfgs("baseline", IMAGE, 8, **OPTIM)
    jcfg.parallel.grad_accum = 2
    want = jax_dp2_run(jcfg, H.variables("fc", IMAGE), _accum_batches())
    r0, r1 = (r["accum"] for r in collect_scale_worker(procs, tmp_path))
    for i, (wm, wsd) in enumerate(want):
        assert r0["metrics"][i] == r1["metrics"][i]
        for key in ("loss", "grad_norm", "top1", "top3", "step_ok"):
            np.testing.assert_allclose(r0["metrics"][i][key], wm[key],
                                       err_msg=f"step {i} {key}", **TOL)
        for k, w in wsd.items():
            np.testing.assert_allclose(
                r0["states"][i]["model"][f"backbone.{k}"].numpy(), w.numpy(),
                err_msg=f"step {i} {k}", **TOL)
        for k, v in r0["states"][i]["model"].items():
            assert torch.equal(v, r1["states"][i]["model"][k]), k
    assert r0["states"][1]["step"] == r0["states"][1]["opt_count"] == 2


# ------------------------------------- (e) the skipped step, one sentinel --

def _tiny_trainer(tmp_path, *extra):
    argv = ["baseline", "--dataset", "synthetic", "--synthetic_size", "8",
            "--model", "resnet18", "--variant", "cifar", "--image_size", "16",
            "--num_classes", "4", "--batchsize", "4", "--epochs", "1",
            "--dtype", "float32", "--device", "cpu", "--num_workers", "1",
            "--out", str(tmp_path), *extra]
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(argv))
    return Trainer(cfg, torch.device("cpu"))


def _copies(state):
    sd = state.state_dict()
    return ({k: v.clone() for k, v in sd["model"].items()},
            {i: s["momentum_buffer"].clone()
             for i, s in sd["optimizer"]["state"].items()},
            state.step, state.opt_count)


def test_nan_window_skips_the_accumulated_step_with_one_observation(tmp_path):
    tr = _tiny_trainer(tmp_path, "--grad_accum", "2", "--fault_spec",
                       "nan_loss@step=1")
    assert tr.steps_per_epoch == 2
    seen, observed = [], []
    real_step, real_observe = tr.train_step, tr.sentinel.observe

    def step(state, *a, **kw):
        m = real_step(state, *a, **kw)
        seen.append(_copies(state))
        return m

    def observe(ok):
        observed.append(float(ok))
        real_observe(ok)

    tr.train_step, tr.sentinel.observe = step, observe
    tr.train_epoch(0)
    assert observed == [1.0, 0.0]  # one a step, not one a microbatch
    assert tr.sentinel.skipped_total == 1
    (m0, o0, s0, c0), (m1, o1, s1, c1) = seen
    assert (s0, c0, s1, c1) == (1, 1, 2, 1)
    for k, v in m0.items():  # weights and running statistics
        assert torch.equal(m1[k], v), k
    for i, v in o0.items():
        assert torch.equal(o1[i], v)


# ------------------------------------------ (f) K = 1 is the plain step --

def test_defaults_are_the_plain_step_bitwise():
    """Every lever at its default on one process: no ZeRO, the plain
    optimizer, and the step equal, bit for bit, to the plain sequence
    written out (epilogue, forward, CE, backward, lr, SGD)."""
    _, cfg = H.cfgs("baseline", IMAGE, 4, **OPTIM)
    assert (cfg.parallel.grad_accum, cfg.parallel.zero_opt,
            cfg.parallel.grad_reduce_dtype) == (1, "auto", "float32")
    params, stats = H.variables("fc", IMAGE)
    a, b = (H.port_state("fc", cfg, params, stats) for _ in range(2))
    assert type(a.optimizer) is torch.optim.SGD
    step = steps.make_train_step(cfg)
    for s in range(2):
        images, labels = (torch.from_numpy(t) for t in H.batch(IMAGE, 4, 110 + s))
        step(a, images, labels)
        b.model.train()
        b.model.zero_grad(set_to_none=True)
        logits = b.model(images.permute(0, 3, 1, 2))
        torch.nn.functional.cross_entropy(logits.float(),
                                          labels.long()).backward()
        b.set_lrs()
        b.optimizer.step()
        b.opt_count += 1
        b.step += 1
    for k, v in b.model.state_dict().items():
        assert torch.equal(a.model.state_dict()[k], v), k
    assert (a.step, a.opt_count) == (b.step, b.opt_count) == (2, 2)


# ------------------------------------------ (g) schedule and rejections --

@pytest.mark.parametrize("k", [1, 2, 4, 3])
@pytest.mark.parametrize("kind", ["step", "multistep"])
def test_schedule_with_grad_accum_matches_jax(kind, k):
    fields = dict(lr=0.1, schedule=kind, step_size=2, gamma=0.5,
                  milestones=(1, 3), warmup_iters=10, warmup_start_lr=1e-3)
    jax_sched = jax_schedule.build_schedule(JaxOptimConfig(**fields), 5,
                                            grad_accum=k)
    port = schedule.build_schedule(OptimConfig(**fields), 5, grad_accum=k)
    for step in range(30):
        assert port(step) == float(jax_sched(step)), step


def _rc(argv, capsys):
    with pytest.raises(SystemExit) as e:
        train_cli.main(argv)
    return e.value.code, capsys.readouterr().err


@pytest.mark.parametrize("extra,words", [
    (["-b", "6", "--grad_accum", "4"], ("grad-accum-indivisible",
                                        "equal microbatches")),
    (["--sharded_ce", "--grad_accum", "2"], ("grad-accum-indivisible",
                                             "arcface_sharded_ce")),
    (["--zero_opt", "yes"], ("invalid choice",)),
    (["--grad_reduce_dtype", "float16"], ("invalid choice",)),
])
def test_rejections_exit_2(tmp_path, capsys, extra, words):
    rc, err = _rc(["baseline", "--dataset", "synthetic", "--device", "cpu",
                   "--out", str(tmp_path), *extra], capsys)
    assert rc == 2, err[-500:]
    for w in words:
        assert w in err


def test_bf16_wire_under_nested_over_ranks_is_rejected():
    cfg = get_preset("nested")
    cfg.parallel.grad_reduce_dtype = "bfloat16"
    steps.check_scaling(cfg, 1)  # a world of one has no wire: JAX's too
    with pytest.raises(ValueError, match="nested"):
        steps.check_scaling(cfg, 2)
    cfg.parallel.grad_accum = 2  # JAX's check does not look at K
    with pytest.raises(ValueError, match="nested"):
        steps.check_scaling(cfg, 2)
    cfg.parallel.zero_opt = "yes"
    with pytest.raises(ValueError, match="zero_opt"):
        steps.check_scaling(cfg, 1)
