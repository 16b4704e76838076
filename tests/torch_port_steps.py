"""Shared pieces of the parity tests of VGG19-BN and of the heads on
TResNet-M and the ViT (tests/test_torch_port_{vgg,heads}.py): a JAX
train step and the port's from the same weights, stepped side by side
on the same batches, their metrics and their whole states compared."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddp_classification_pytorch_tpu.config import get_preset as jax_preset
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu.train import steps as jax_steps
from ddp_classification_pytorch_tpu.train.state import TrainState as JaxTrainState
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.train import schedule, steps
from ddp_classification_pytorch_tpu_torch.train.state import TrainState

from torch_port_heads import TOL, f32

METRICS = ("loss", "grad_norm", "top1", "top3", "step_ok")


def cfgs(workload, arch, image, batch, classes, **optim):
    """(JAX cfg, port cfg): `workload`'s preset for `arch` on synthetic
    data and the float32 wire, with `optim` overrides."""
    out = (jax_preset(workload), get_preset(workload))
    for cfg in out:
        cfg.model.arch = arch
        cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
        cfg.data.image_size, cfg.data.num_classes = image, classes
        cfg.data.batch_size = batch
        for k, v in optim.items():
            setattr(cfg.optim, k, v)
    return out


class SideBySide:
    """A JAX train state and the port's from the same numpy `params` /
    `stats`; `step` advances both on one batch and compares every metric
    and every parameter and running statistic (through `from_jax`) at TOL.
    `x64` runs the JAX side in f64 (its model built in f64)."""

    def __init__(self, jcfg, cfg, jmodel, pmodel, from_jax, params, stats,
                 x64=True):
        self.from_jax, self.x64 = from_jax, x64
        freeze = jcfg.model.freeze_bn
        tx = jax_schedule.build_optimizer(jcfg.optim, 1, freeze_bn=freeze)
        self.jstep = jax_steps.make_train_step(jcfg, jmodel, tx)
        with jax.enable_x64(x64):
            cast = (lambda a: jnp.asarray(a, jnp.float64)) if x64 else jnp.asarray
            p = jax.tree_util.tree_map(cast, params)
            s = jax.tree_util.tree_map(cast, stats)
            self.jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                                        params=p, batch_stats=s,
                                        opt_state=tx.init(p))
        pmodel.load_state_dict(from_jax(params, stats))
        pmodel.to(memory_format=torch.channels_last)
        o = cfg.optim
        self.state = TrainState(
            pmodel, schedule.build_optimizer(
                o, schedule.param_groups(o, pmodel, cfg.model.freeze_bn)),
            schedule.build_schedule(o, 1),
            head_schedule=(schedule.build_schedule(schedule.head_config(o), 1)
                           if schedule.two_groups(o) else None))
        self.pstep = steps.make_train_step(cfg)

    def step(self, images, labels, **kw):
        with jax.enable_x64(self.x64):
            dt = jnp.float64 if self.x64 else jnp.float32
            self.jstate, jm = self.jstep(self.jstate, jnp.asarray(images, dt),
                                         jnp.asarray(labels))
        m = self.pstep(self.state, torch.from_numpy(images),
                       torch.from_numpy(labels), **kw)
        for key in METRICS:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=key, **TOL)
        want = self.from_jax(f32(self.jstate.params),
                             f32(self.jstate.batch_stats))
        got = self.state.model.state_dict()
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k,
                                       **TOL)
        return m


def jax_step_rngs(jcfg, step):
    """(mask_rng, drop_rng) of JAX's train step at `step`
    (`_build_step` folds the step in, `_dense_loss_fn` splits)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(jcfg.run.seed + 1), step)
    return jax.random.split(rng)


def batch(image, n, classes, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, image, image, 3)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))
