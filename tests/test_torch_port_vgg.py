"""VGG19-BN in the torch port against the JAX package's, on the CPU, and
the freeze-BN sets of the archs this slice puts under the heads.

(a) The eval forward of a narrow VGG (cfg (8, "M", 16, "M"), 10 classes)
    from the same weights (`vgg_from_jax`): at 28 px, where the features
    end on the classifier's 7×7 grid, and at 32 px, where both sides
    mean-pool and tile (JAX `vgg.py:56-58`).
(b) Two train steps of that VGG under the baseline recipe (fc3, two
    dropouts) and under nested (the 4096-d feature, one dropout, JAX's k,
    freeze-BN's filter over both BNs), each step given the dropout masks
    JAX's step drew (captured by intercepting flax's `Dropout` on the
    step's own dropout key): metrics, parameters and running statistics.
(c) The frozen sets at full width against JAX's matcher on
    `jax.eval_shape`'s param paths, nested head: TResNet-M 48 of 253
    tensors, VGG19-BN 32 of 69, ViT-B/16 0; `flax_path` names every port
    parameter's JAX path; `feat_dim_for` is JAX's.

The port runs in f32 against JAX in f64 at atol 1e-5 / rtol 1e-4 (the
JAX classifier casts to f32, as the port's).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.config import ModelConfig as JaxModelConfig
from ddp_classification_pytorch_tpu.models import factory as jax_factory
from ddp_classification_pytorch_tpu.models import heads as jax_heads
from ddp_classification_pytorch_tpu.models import vgg as jax_vgg
from ddp_classification_pytorch_tpu.ops import nested as jax_nested
from ddp_classification_pytorch_tpu.train.schedule import _is_bn_param
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.models import factory, heads, vgg
from ddp_classification_pytorch_tpu_torch.models.convert import (
    flax_path,
    nested_from_jax,
    vgg_from_jax,
)
from ddp_classification_pytorch_tpu_torch.train.schedule import frozen_bn_names

from torch_port_heads import TOL, f64
from torch_port_helpers import OPTIM, random_variables
from torch_port_steps import SideBySide, batch, cfgs, jax_step_rngs
from torch_port_threads import one_torch_thread  # noqa: F401

CFG, CLASSES, BATCH = (8, "M", 16, "M"), 10, 4


def _jax_vgg(num_classes, dtype=jnp.float64):
    return jax_vgg.VGG(cfg=CFG, num_classes=num_classes, dtype=dtype)


def _jax_model(head, dtype=jnp.float64):
    if head == "fc":
        return jax_factory.ClassifierModel(backbone=_jax_vgg(CLASSES, dtype))
    return jax_factory.NestedModel(backbone=_jax_vgg(0, dtype),
                                   classifier=jax_heads.NetClassifier(CLASSES))


def _port_model(head):
    if head == "fc":
        return factory.ClassifierModel(vgg.VGG(CFG, CLASSES, torch.float32))
    return factory.NestedModel(vgg.VGG(CFG, 0, torch.float32),
                               heads.NetClassifier(vgg.WIDTH, CLASSES))


def _from_jax(head):
    if head == "fc":
        return lambda p, s: {f"backbone.{k}": v for k, v in
                             vgg_from_jax(p, s, CFG).items()}
    return lambda p, s: nested_from_jax(p, s, CFG)


@pytest.fixture(scope="module")
def variables():
    """numpy (params, batch_stats) of each head's model, made once: kernels
    N(0, 2/fan_in), every BN and bias randomized."""
    return {head: random_variables(_jax_model(head, jnp.float32), 32,
                                   np.random.default_rng(3))
            for head in ("fc", "nested")}


@pytest.mark.parametrize("image", [28, 32], ids=["grid7", "pooled"])
def test_vgg_eval_forward_matches_jax(variables, image):
    params, stats = variables["fc"]
    x = np.random.default_rng(image).normal(size=(2, image, image, 3))
    with jax.enable_x64(True):
        want = jax.jit(lambda v, x: _jax_model("fc").apply(v, x, train=False))(
            {"params": f64(params), "batch_stats": f64(stats)},
            jnp.asarray(x))
    model = _port_model("fc")
    model.load_state_dict(_from_jax("fc")(params, stats))
    model.eval().to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = model(torch.from_numpy(x.astype(np.float32)).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_dropout_masks(jmodel):
    """`(jstate, images, extra, drop_rng) -> [keep mask]` of each flax
    Dropout in the step's forward: the same call on the step's dropout
    key with each Dropout fed ones (jitted: traced once a model)."""
    def capture(variables, images, extra, drop_rng):
        masks = []

        def feed_ones(next_fun, args, kwargs, context):
            if (isinstance(context.module, fnn.Dropout)
                    and context.method_name == "__call__"):
                out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
                masks.append(out > 0)
                return out
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(feed_ones):
            jmodel.apply(variables, images, *extra, train=True,
                         mutable=["batch_stats"], rngs={"dropout": drop_rng})
        return masks

    jitted = jax.jit(capture)

    def masks(jstate, images, extra, drop_rng):
        with jax.enable_x64(True):
            out = jitted({"params": jstate.params,
                          "batch_stats": jstate.batch_stats},
                         jnp.asarray(images), extra, drop_rng)
        return [torch.from_numpy(np.asarray(m)) for m in out]

    return masks


@pytest.mark.parametrize("workload", ["baseline", "nested"])
def test_two_vgg_steps_with_jax_dropout_masks_match_jax(variables, workload):
    head = "fc" if workload == "baseline" else "nested"
    jcfg, cfg = cfgs(workload, "vgg19_bn", 32, BATCH, CLASSES, **OPTIM)
    params, stats = variables[head]
    jmodel = _jax_model(head)
    both = SideBySide(jcfg, cfg, jmodel, _port_model(head), _from_jax(head),
                      params, stats)
    drops = [m for m in both.state.model.modules()
             if isinstance(m, vgg.Dropout)]
    assert len(drops) == (2 if head == "fc" else 1)
    assert cfg.model.freeze_bn == (head == "nested")
    capture = _jax_dropout_masks(jmodel)
    for s in range(2):
        images, labels = batch(32, BATCH, CLASSES, 30 + s)
        mask_rng, drop_rng = jax_step_rngs(jcfg, s)
        kw, extra = {}, ()
        if head == "nested":
            dist = jnp.asarray(jax_nested.gaussian_dist(
                0.0, jcfg.model.nested_std, vgg.WIDTH))
            kw["k"] = int(jax_nested.sample_mask_dims(mask_rng, dist))
            extra = (jax_nested.prefix_mask(jnp.asarray(kw["k"]), vgg.WIDTH),)
        masks = capture(both.jstate, images, extra, drop_rng)
        assert len(masks) == len(drops)
        assert all(0.3 < float(m.float().mean()) < 0.7 for m in masks)
        for d, m in zip(drops, masks):
            d.next_mask = m
        m = both.step(images, labels, **kw)
        assert float(m["step_ok"]) == 1.0
        assert all(d.next_mask is None for d in drops)


def _nested_jax(arch):
    cfg = JaxModelConfig(arch=arch, head="nested", dtype="float32")
    return jax_factory.build_model(cfg, 2173)


@pytest.mark.parametrize("arch,frozen,total", [
    ("tresnet_m", 48, 253), ("vgg19_bn", 32, 69), ("vit_b16", 0, 150)])
def test_frozen_sets_are_the_jax_matchers(arch, frozen, total):
    image = 224
    shapes = jax.eval_shape(lambda: _nested_jax(arch).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, image, image, 3)), train=False))["params"]
    paths = {"/".join(str(getattr(k, "key", k)) for k in path): _is_bn_param(
        path, leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    cfg = get_preset("nested")
    cfg.model.arch = arch
    with torch.device("meta"):
        model = factory.build_model(cfg.model, 2173, image)
    names = [n for n, _ in model.named_parameters()]
    assert {flax_path(n) for n in names} == set(paths)
    assert len(names) == len(paths) == total
    got = frozen_bn_names(model)
    assert len(got) == frozen
    assert {flax_path(n) for n in got} == {p for p, bn in paths.items() if bn}


def test_feat_dim_for_is_jaxs():
    for arch in factory.PORTED_ARCHS:
        assert factory.feat_dim_for(arch) == jax_factory.feat_dim_for(
            JaxModelConfig(arch=arch)), arch
