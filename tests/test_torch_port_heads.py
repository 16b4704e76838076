"""The arcface and nested heads on TResNet-M and on the ViT in the torch
port against the JAX package's, on the CPU.

Two train steps of each head over each backbone from the same weights
and batches: the reduced TResNet-M (stages (1, 1, 1, 1), width 0.5, so
1024 features; its ABNs through the port's K1 family's plain versions
and the JAX Pallas kernel in interpret mode) and a 2-block ViT (dim 64,
2 heads, 32 px). ArcFace with a head lr (two param groups), nested with
JAX's k and freeze-BN (TResNet-M: its identity BNs' γ/β frozen, the
ABNs' batch statistics still moving, as JAX's). Metrics, every parameter
and running statistic after each step, at atol 1e-5 / rtol 1e-4: the
ViT's JAX side in f64; TResNet-M's in f32, as
tests/test_torch_port_tresnet_train.py holds it (JAX's Pallas ABN runs
in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.models import factory as jax_factory
from ddp_classification_pytorch_tpu.models import heads as jax_heads
from ddp_classification_pytorch_tpu.models.tresnet import TResNet as JaxTResNet
from ddp_classification_pytorch_tpu.models.vit import ViT as JaxViT
from ddp_classification_pytorch_tpu.ops import nested as jax_nested
from ddp_classification_pytorch_tpu_torch.models import factory, heads, tresnet, vit
from ddp_classification_pytorch_tpu_torch.models.convert import (
    arcface_from_jax,
    nested_from_jax,
)
from ddp_classification_pytorch_tpu_torch.train.schedule import frozen_bn_names

from torch_port_helpers import OPTIM, random_variables
from torch_port_steps import SideBySide, batch, cfgs, jax_step_rngs
from torch_port_threads import one_torch_thread  # noqa: F401

CLASSES, EMBED, BATCH = 10, 64, 4
TRES = dict(stages=(1, 1, 1, 1), width=0.5)
VIT = dict(patch=16, dim=64, depth=2, heads=2)
ARCHS = {"tresnet_m": (1024, 64, False), "vit_b16": (64, 32, True)}


def _jax_backbone(arch, dtype):
    if arch == "tresnet_m":
        return JaxTResNet(num_classes=0, dtype=dtype, **TRES)
    return JaxViT(num_classes=0, dtype=dtype, **VIT)


def _port_backbone(arch, image):
    if arch == "tresnet_m":
        return tresnet.TResNet(num_classes=0, dtype=torch.float32, **TRES)
    return vit.ViT(image_size=image, dtype=torch.float32, **VIT)


def _models(head, arch, dtype):
    feat = ARCHS[arch][0]
    if head == "arcface":
        j = jax_factory.ArcFaceModel(
            backbone=_jax_backbone(arch, dtype),
            embedding=jax_heads.ArcEmbedding(dims=(512, EMBED)),
            margin=jax_heads.ArcMarginHead(CLASSES, EMBED, 30.0, 0.5, True))
        p = factory.ArcFaceModel(
            _port_backbone(arch, ARCHS[arch][1]),
            heads.ArcEmbedding(feat, (512, EMBED)),
            heads.ArcMarginHead(CLASSES, EMBED, 30.0, 0.5, True))
        return j, p, arcface_from_jax
    j = jax_factory.NestedModel(backbone=_jax_backbone(arch, dtype),
                                classifier=jax_heads.NetClassifier(CLASSES))
    p = factory.NestedModel(_port_backbone(arch, ARCHS[arch][1]),
                            heads.NetClassifier(feat, CLASSES))
    return j, p, nested_from_jax


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("workload", ["arcface", "nested"])
def test_two_head_steps_match_jax(workload, arch):
    feat, image, x64 = ARCHS[arch]
    optim = dict(OPTIM, head_lr=0.02) if workload == "arcface" else OPTIM
    jcfg, cfg = cfgs(workload, arch, image, BATCH, CLASSES, **optim)
    for c in (jcfg, cfg):
        c.model.arc_embed_dim = EMBED
        c.model.nested_std = 40.0
    jcfg.model.feat_dim = feat  # the JAX config sizes the nested mask
    jmodel, pmodel, from_jax = _models(workload, arch, jnp.float32)
    params, stats = random_variables(jmodel, image, np.random.default_rng(5))
    if workload == "arcface":
        params["margin"]["weight"] = np.random.default_rng(6).normal(
            size=(CLASSES, EMBED)).astype(np.float32)
    if x64:
        jmodel = _models(workload, arch, jnp.float64)[0]
    both = SideBySide(jcfg, cfg, jmodel, pmodel, from_jax, params, stats,
                      x64=x64)
    model = both.state.model
    groups = both.state.optimizer.param_groups
    frozen = frozen_bn_names(model) if cfg.model.freeze_bn else []
    if workload == "arcface":
        assert len(groups) == 2 and groups[1]["head"] and not frozen
    else:  # freeze-BN: TResNet-M's 7 identity BNs (bn2/bn3/bn_down)
        assert cfg.model.freeze_bn
        assert len(frozen) == (14 if arch == "tresnet_m" else 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for s in range(2):
        images, labels = batch(image, BATCH, CLASSES, 40 + s)
        kw = {}
        if workload == "nested":
            dist = jnp.asarray(jax_nested.gaussian_dist(
                0.0, jcfg.model.nested_std, feat))
            kw["k"] = int(jax_nested.sample_mask_dims(
                jax_step_rngs(jcfg, s)[0], dist))
        m = both.step(images, labels, **kw)
        assert float(m["step_ok"]) == 1.0
    after = model.state_dict()
    for k in frozen:
        assert torch.equal(after[k], before[k]), k
    stats_moved = [k for k in after if k.endswith("running_mean")
                   and not torch.equal(after[k], before[k])]
    assert len(stats_moved) == (14 if arch == "tresnet_m" else 0)
