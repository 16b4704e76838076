"""`--remat`, `--dropout` and `--ln_bf16` in the torch port
(models/remat.py, models/dropout.py, the ViT's and the ResNets' use of
them) against the JAX package's, on the CPU.

(a) ViT remat (`checkpoint_dots`): a step of the reduced ViT (vit_t16 cut
    to dim 64, depth 2, 1 head of 64, 32 px, f32) is bitwise the port's
    plain step, and JAX's remat step at atol 1e-5 / rtol 1e-4 (metrics
    and every parameter); on the flash path the backward recomputes K2,
    so its wrapper runs twice a block a step (K3 and K4 once), and the
    gradients are bitwise the plain ones.
(b) ViT dropout: with JAX's masks handed in (captured on the step's own
    dropout key, as tests/test_torch_port_vgg.py captures VGG's), a step
    is JAX's (JAX in f64) at that tolerance; with the port's own masks
    (one generator seeded from the run seed and the step) a remat step is
    bitwise the plain step: the recompute reused the forward's masks.
(c) `ln_bf16` is bitwise the f32-LayerNorm path, on the JAX side (flax
    promotes the LayerNorm's math to f32 and casts only its output) and
    on the port's.
(d) ResNet remat (whole blocks) on the reduced ResNet-50 (stages
    (1, 1, 1, 1), 8 filters, 64 px): the gradients and running statistics
    of a training forward/backward within 1e-5 of JAX's remat ones (JAX in
    f64; tests/test_remat.py's contract), the gradients and running
    statistics bitwise the port's plain ones, and two train steps bitwise
    the plain steps; over two gloo ranks (tests/torch_port_scale_worker.py,
    BN statistics all-reduced again in the recompute) bitwise the plain
    two-rank run.
(e) `remat` reaches the ResNets and the ViTs; VGG19-BN and TResNet-M
    ignore it, as JAX's factory does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ddp_classification_pytorch_tpu.config import ModelConfig as JaxModelConfig
from ddp_classification_pytorch_tpu.models import factory as jax_factory
from ddp_classification_pytorch_tpu.models import resnet as jax_resnet
from ddp_classification_pytorch_tpu.models.factory import ClassifierModel as JaxClassifier
from ddp_classification_pytorch_tpu.models.vit import ViT as JaxViT
from ddp_classification_pytorch_tpu_torch.config import ModelConfig
from ddp_classification_pytorch_tpu_torch.models import factory, resnet, vit
from ddp_classification_pytorch_tpu_torch.models.convert import vit_from_jax
from ddp_classification_pytorch_tpu_torch.models.dropout import Dropout
from ddp_classification_pytorch_tpu_torch.ops import flash_attention as port_fa
from ddp_classification_pytorch_tpu_torch.train import schedule, steps
from ddp_classification_pytorch_tpu_torch.train.state import TrainState

import torch_port_heads as H
from test_torch_port_vgg import _jax_dropout_masks
from torch_port_helpers import OPTIM, random_vit_params
from torch_port_scale import collect_scale_worker, spawn_scale_worker
from torch_port_steps import SideBySide, batch, cfgs, jax_step_rngs
from torch_port_threads import one_torch_thread  # noqa: F401

REDUCED = dict(patch=16, dim=64, depth=2, heads=1, num_classes=10)
IMAGE, BATCH, CLASSES = 32, 4, 10
R50_IMAGE = 64
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)


def _port_vit(dtype=torch.float32, **kw):
    return factory.ClassifierModel(vit.ViT(image_size=IMAGE, dtype=dtype,
                                           **REDUCED, **kw))


def _from_jax(params, stats=None):
    return {f"backbone.{k}": v for k, v in vit_from_jax(params).items()}


def _port_state(cfg, model):
    o = cfg.optim
    return TrainState(model, schedule.build_optimizer(
        o, schedule.param_groups(o, model, False)), schedule.build_schedule(o, 1))


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.fixture(scope="module")
def vit_params():
    """numpy params of the reduced ViT (`random_vit_params`)."""
    return random_vit_params(JaxClassifier(backbone=JaxViT(**REDUCED)), IMAGE,
                             np.random.default_rng(9))


def _vit_cfgs(dropout=0.0, remat=False):
    jcfg, cfg = cfgs("baseline", "vit_t16", IMAGE, BATCH, CLASSES, **OPTIM)
    for c in (jcfg, cfg):
        c.model.dtype, c.model.dropout, c.model.remat = "float32", dropout, remat
    return jcfg, cfg


# ---------------------------------------------------------- (a) ViT remat --

def test_vit_remat_step_is_the_plain_step_and_jaxs(vit_params):
    jcfg, cfg = _vit_cfgs(remat=True)
    both = SideBySide(jcfg, cfg, JaxClassifier(backbone=JaxViT(
        remat=True, dtype=jnp.float32, **REDUCED)), _port_vit(remat=True),
        _from_jax, vit_params, {}, x64=False)
    plain = _port_vit()
    plain.load_state_dict(_from_jax(vit_params))
    plain.to(memory_format=torch.channels_last)  # as SideBySide's model
    plain_state, plain_step = _port_state(cfg, plain), steps.make_train_step(cfg)
    for s in range(2):
        images, labels = batch(IMAGE, BATCH, CLASSES, 20 + s)
        m = both.step(images, labels)
        pm = plain_step(plain_state, torch.from_numpy(images),
                        torch.from_numpy(labels))
        assert float(m["step_ok"]) == 1.0
        assert [k for k in m if not torch.equal(m[k], pm[k])] == [], (m, pm)
        _assert_same_state(both.state.model, plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_flash_remat_recomputes_k2_and_keeps_the_gradients(
        monkeypatch, vit_params, dtype):
    calls = {"fwd": 0, "dq": 0, "dkv": 0}

    def counted(kind, ref):
        def wrapper(*a):
            calls[kind] += 1
            return ref(*a)
        return wrapper

    monkeypatch.setattr(port_fa, "flash_forward",
                        counted("fwd", port_fa.flash_forward_ref))
    monkeypatch.setattr(port_fa, "flash_dq", counted("dq", port_fa.flash_dq_ref))
    monkeypatch.setattr(port_fa, "flash_dkv",
                        counted("dkv", port_fa.flash_dkv_ref))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(BATCH, 3, IMAGE, IMAGE)).astype(np.float32))
    grads, counts = {}, {}
    for remat in (False, True):
        model = _port_vit(getattr(torch, dtype), remat=remat, use_flash=True,
                          flash_min_tokens=0)
        model.load_state_dict(_from_jax(vit_params))
        for k in calls:
            calls[k] = 0
        model.train()(x).float().square().sum().backward()
        counts[remat] = dict(calls)
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    depth = REDUCED["depth"]
    assert counts[False] == {"fwd": depth, "dq": depth, "dkv": depth}
    assert counts[True] == {"fwd": 2 * depth, "dq": depth, "dkv": depth}
    for n, g in grads[False].items():
        assert torch.equal(g, grads[True][n]), n


# -------------------------------------------------------- (b) ViT dropout --

def test_vit_dropout_step_with_jax_masks_matches_jax(vit_params):
    jcfg, cfg = _vit_cfgs(dropout=0.1)
    jmodel = JaxClassifier(backbone=JaxViT(dropout=0.1, dtype=jnp.float64,
                                           **REDUCED))
    both = SideBySide(jcfg, cfg, jmodel, _port_vit(dropout=0.1), _from_jax,
                      vit_params, {})
    drops = [b.drop for b in both.state.model.backbone.blocks]
    images, labels = batch(IMAGE, BATCH, CLASSES, 30)
    masks = _jax_dropout_masks(jmodel)(both.jstate, images, (),
                                       jax_step_rngs(jcfg, 0)[1])
    assert len(masks) == len(drops) == REDUCED["depth"]
    assert all(0.8 < float(m.float().mean()) < 0.97 for m in masks)
    for d, m in zip(drops, masks):
        d.next_mask = m
    m = both.step(images, labels)
    assert float(m["step_ok"]) == 1.0
    assert all(d.next_mask is None for d in drops)


def test_vit_dropout_remat_step_is_the_plain_step(vit_params):
    """Two steps from one seed, the masks the port's own (the step's
    generator): remat and plain bitwise; a third model without dropout
    differs, so the masks did apply."""
    states = {}
    for name, dropout, remat in (("plain", 0.1, False), ("remat", 0.1, True),
                                 ("none", 0.0, False)):
        _, cfg = _vit_cfgs(dropout=dropout, remat=remat)
        model = _port_vit(dropout=dropout, remat=remat)
        model.load_state_dict(_from_jax(vit_params))
        state, step = _port_state(cfg, model), steps.make_train_step(cfg)
        for s in range(2):
            images, labels = batch(IMAGE, BATCH, CLASSES, 40 + s)
            step(state, torch.from_numpy(images), torch.from_numpy(labels))
        states[name] = model
    _assert_same_state(states["plain"], states["remat"])
    w = "backbone.blocks.1.mlp_out.weight"
    assert not torch.equal(states["plain"].state_dict()[w],
                           states["none"].state_dict()[w])
    gen = states["remat"].backbone.blocks[0].drop.generator
    assert gen is states["remat"].backbone.blocks[1].drop.generator
    assert steps.dropout_seed(0, 1) != steps.dropout_seed(0, 2)


# ------------------------------------------------------------ (c) ln_bf16 --

def test_ln_bf16_is_bitwise_f32_layernorm_in_jax(vit_params):
    """The flax finding the port rests on: LayerNorm(dtype=bf16) is the f32
    LayerNorm followed by the cast, for logits and every gradient."""
    x = jnp.asarray(np.random.default_rng(4).normal(
        size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32))
    out = {}
    for ln_bf16 in (False, True):
        model = JaxClassifier(backbone=JaxViT(dtype=jnp.bfloat16,
                                              ln_bf16=ln_bf16, **REDUCED))

        def loss(p):
            logits = model.apply({"params": p}, x, train=False)
            return jnp.sum(logits.astype(jnp.float32) ** 2), logits

        out[ln_bf16] = jax.jit(jax.grad(loss, has_aux=True))(vit_params)
    (g0, l0), (g1, l1) = out[False], out[True]
    np.testing.assert_array_equal(np.asarray(l0), np.asarray(l1))
    for a, b in zip(jax.tree_util.tree_leaves(g0), jax.tree_util.tree_leaves(g1)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ln_bf16_is_bitwise_f32_layernorm_in_the_port(vit_params):
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(BATCH, 3, IMAGE, IMAGE)).astype(np.float32))
    out = {}
    for ln_bf16 in (False, True):
        model = _port_vit(torch.bfloat16, ln_bf16=ln_bf16)
        model.load_state_dict(_from_jax(vit_params))
        logits = model.train()(x)
        logits.float().square().sum().backward()
        out[ln_bf16] = (logits, [p.grad for p in model.parameters()])
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1], out[True][1]))


# ------------------------------------------------------- (d) ResNet remat --

def _r50_port(remat):
    model = factory.ClassifierModel(resnet.ResNet(
        block_cls=resnet.Bottleneck, dtype=torch.float32, remat=remat,
        num_classes=H.CLASSES, **H.STAGES))
    model.load_state_dict(H.FROM_JAX["fc"](*H.variables("fc", R50_IMAGE)))
    return model.to(memory_format=torch.channels_last)


def test_resnet_remat_gradients_and_stats_match_jax_and_plain():
    params, stats = H.variables("fc", R50_IMAGE)
    images, labels = H.batch(R50_IMAGE, 8, 70)
    jmodel = JaxClassifier(backbone=jax_resnet.ResNet(
        block_cls=jax_resnet.Bottleneck, dtype=jnp.float64, remat=True,
        num_classes=H.CLASSES, **H.STAGES))

    def loss(p, s, x, y):
        logits, new = jmodel.apply({"params": p, "batch_stats": s}, x,
                                   train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return ce, new["batch_stats"]

    with jax.enable_x64(True):
        (_, jstats), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            H.f64(params), H.f64(stats), jnp.asarray(images, jnp.float64),
            jnp.asarray(labels))
        want = H.FROM_JAX["fc"](H.f32(jgrads), H.f32(jstats))
    got = {}
    for remat in (False, True):
        model = _r50_port(remat).train()
        x = torch.from_numpy(images).permute(0, 3, 1, 2)
        F.cross_entropy(model(x), torch.from_numpy(labels).long()).backward()
        got[remat] = {n: p.grad for n, p in model.named_parameters()} | {
            n: b for n, b in model.named_buffers()}
    for name, w in want.items():
        np.testing.assert_allclose(got[True][name].numpy(), w.numpy(),
                                   err_msg=name, **GRAD_TOL)
        assert torch.equal(got[True][name], got[False][name]), name


def test_resnet_remat_steps_are_the_plain_steps():
    states = {}
    for remat in (False, True):
        _, cfg = H.cfgs("baseline", R50_IMAGE, 8, **OPTIM)
        cfg.model.remat = remat
        model = _r50_port(remat)
        state, step = _port_state(cfg, model), steps.make_train_step(cfg)
        for s in range(2):
            m = step(state, *map(torch.from_numpy, H.batch(R50_IMAGE, 8, 80 + s)))
            assert float(m["step_ok"]) == 1.0
        states[remat] = model
    _assert_same_state(states[False], states[True])


def test_resnet_remat_over_two_gloo_ranks_is_the_plain_run(tmp_path):
    batches = [H.batch(R50_IMAGE, 8, 90 + s) for s in range(2)]
    ranks = collect_scale_worker(
        spawn_scale_worker(tmp_path, ["plain", "remat"], batches, []),
        tmp_path)
    for r in ranks:
        assert r["remat"]["metrics"] == r["plain"]["metrics"]
        for a, b in zip(r["plain"]["states"], r["remat"]["states"]):
            for k, v in a["model"].items():
                assert torch.equal(v, b["model"][k]), k
    for a, b in zip(ranks[0]["remat"]["states"], ranks[1]["remat"]["states"]):
        for k, v in a["model"].items():
            assert torch.equal(v, b["model"][k]), k


# -------------------------------------------------- (e) who takes remat --

@pytest.mark.parametrize("arch,takes", [("resnet50", True), ("vit_b16", True),
                                        ("vgg19_bn", False),
                                        ("tresnet_m", False)])
def test_remat_reaches_the_archs_jax_gives_it(arch, takes):
    with torch.device("meta"):
        backbone = factory.build_backbone(ModelConfig(arch=arch, remat=True),
                                          10, 224)
    assert getattr(backbone, "remat", False) is takes
    jax_backbone = jax_factory.build_backbone(
        JaxModelConfig(arch=arch, remat=True), 10)
    assert getattr(jax_backbone, "remat", False) is takes


def test_remat_resnet_eval_and_no_grad_take_the_plain_forward():
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 3, R50_IMAGE, R50_IMAGE)).astype(np.float32))
    plain, remat = _r50_port(False), _r50_port(True)
    with torch.no_grad():
        assert torch.equal(plain.eval()(x), remat.eval()(x))
        assert torch.equal(plain.train()(x), remat.train()(x))
    _assert_same_state(plain, remat)
    assert isinstance(vit.ViT(**REDUCED, image_size=IMAGE, dropout=0.1
                              ).blocks[0].drop, Dropout)
