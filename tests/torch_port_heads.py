"""Shared pieces of the parity tests of the port's ArcFace, CDR and Nested
workloads (tests/test_torch_port_{arcface,cdr,nested,ddp}.py): the reduced
ResNet-50 of tests/test_torch_port_resnet.py (stages (1, 1, 1, 1), 8
filters, so 256 features) under each head on both sides, their configs,
and the JAX variables every test starts from (weight seed 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddp_classification_pytorch_tpu.config import get_preset as jax_preset
from ddp_classification_pytorch_tpu.models import factory as jax_factory
from ddp_classification_pytorch_tpu.models import heads as jax_heads
from ddp_classification_pytorch_tpu.models import resnet as jax_resnet
from ddp_classification_pytorch_tpu.train.state import TrainState as JaxTrainState
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.models import factory, heads, resnet
from ddp_classification_pytorch_tpu_torch.models.convert import (
    arcface_from_jax,
    nested_from_jax,
    resnet_from_jax,
)
from ddp_classification_pytorch_tpu_torch.train import schedule
from ddp_classification_pytorch_tpu_torch.train.state import TrainState

from torch_port_helpers import random_variables

STAGES = dict(stage_sizes=(1, 1, 1, 1), num_filters=8)
FEAT, CLASSES, EMBED = 256, 10, 256
TOL = dict(atol=1e-5, rtol=1e-4)


def f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def jax_model(head, dtype=jnp.float64, freeze_bn=False, s=30.0, m=0.5,
              easy_margin=True):
    """The reduced flax model under `head` (fc, arcface, nested)."""
    backbone = jax_resnet.ResNet(
        block_cls=jax_resnet.Bottleneck, dtype=dtype, freeze_bn=freeze_bn,
        num_classes=CLASSES if head == "fc" else 0, **STAGES)
    if head == "fc":
        return jax_factory.ClassifierModel(backbone=backbone)
    if head == "arcface":
        return jax_factory.ArcFaceModel(
            backbone=backbone,
            embedding=jax_heads.ArcEmbedding(dims=(512, EMBED)),
            margin=jax_heads.ArcMarginHead(CLASSES, EMBED, s, m, easy_margin))
    return jax_factory.NestedModel(backbone=backbone,
                                   classifier=jax_heads.NetClassifier(CLASSES))


def port_model(head, freeze_bn=False, s=30.0, m=0.5, easy_margin=True,
               group=None):
    """The port's counterpart of `jax_model`, in f32."""
    backbone = resnet.ResNet(
        block_cls=resnet.Bottleneck, dtype=torch.float32, freeze_bn=freeze_bn,
        num_classes=CLASSES if head == "fc" else 0, group=group, **STAGES)
    if head == "fc":
        return factory.ClassifierModel(backbone)
    if head == "arcface":
        return factory.ArcFaceModel(
            backbone, heads.ArcEmbedding(FEAT, (512, EMBED)),
            heads.ArcMarginHead(CLASSES, EMBED, s, m, easy_margin))
    return factory.NestedModel(backbone, heads.NetClassifier(FEAT, CLASSES))


FROM_JAX = {"fc": lambda p, s: {f"backbone.{k}": v for k, v in
                                resnet_from_jax(p, s).items()},
            "arcface": arcface_from_jax, "nested": nested_from_jax}


def variables(head, image, seed=0):
    """numpy (params, batch_stats) of the reduced model: kernels N(0,
    2/fan_in), BN randomized (torch_port_helpers.random_variables), and
    the margin head's weight, which that leaves 0, N(0, 1)."""
    params, stats = random_variables(jax_model(head, jnp.float32), image,
                                     np.random.default_rng(seed))
    if head == "arcface":
        params["margin"]["weight"] = np.random.default_rng(seed + 100).normal(
            size=(CLASSES, EMBED)).astype(np.float32)
    return params, stats


def cfgs(workload, image, batch, **optim):
    """(JAX cfg, port cfg): the workload's preset on synthetic data and the
    float32 wire, at the reduced model's sizes, with `optim` overrides."""
    out = (jax_preset(workload), get_preset(workload))
    for cfg in out:
        cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
        cfg.data.image_size, cfg.data.num_classes = image, CLASSES
        cfg.data.batch_size = batch
        cfg.model.arc_embed_dim = EMBED
        for k, v in optim.items():
            setattr(cfg.optim, k, v)
    out[0].model.feat_dim = FEAT  # the JAX config sizes the nested mask
    return out


def jax_state(params, stats, tx):
    """A JAX train state in f64 (call under `jax.enable_x64`)."""
    params, stats = f64(params), f64(stats)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=stats, opt_state=tx.init(params))


def port_state(head, cfg, params, stats, group=None):
    """The port's train state from the same weights, channels_last."""
    model = port_model(head, cfg.model.freeze_bn, cfg.model.arc_s,
                       cfg.model.arc_m, cfg.model.arc_easy_margin, group)
    model.load_state_dict(FROM_JAX[head](params, stats))
    model.to(memory_format=torch.channels_last)
    o = cfg.optim
    return TrainState(
        model, schedule.build_optimizer(
            o, schedule.param_groups(o, model, cfg.model.freeze_bn)),
        schedule.build_schedule(o, 1),
        head_schedule=(schedule.build_schedule(schedule.head_config(o), 1)
                       if schedule.two_groups(o) else None))


def batch(image, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, image, image, 3)).astype(np.float32),
            rng.integers(0, CLASSES, n).astype(np.int32))


def assert_state_matches(head, jstate, model, skip=()):
    """Every parameter and running statistic of the port's model within TOL
    of the JAX state's (names in `skip` left out)."""
    want = FROM_JAX[head](f32(jstate.params), f32(jstate.batch_stats))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k not in skip:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k,
                                       **TOL)
