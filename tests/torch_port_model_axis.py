"""Shared pieces of the model axis's tests (tests/test_torch_port_ring.py,
tests/test_torch_port_model_axis.py): the inputs of every case, starting
tests/torch_port_model_axis_worker.py once on four gloo ranks and reading
back what they wrote, and the JAX references on the 8-device CPU mesh of
tests/conftest.py."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddp_classification_pytorch_tpu.models import factory as jax_factory
from ddp_classification_pytorch_tpu.models import vit as jax_vit
from ddp_classification_pytorch_tpu.parallel import mesh as meshlib
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu.train import steps as jax_steps
from ddp_classification_pytorch_tpu.train.state import TrainState as JaxTrainState
from ddp_classification_pytorch_tpu_torch.models.convert import vit_from_jax

import torch_port_heads as H
from torch_port_helpers import OPTIM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_model_axis_worker.py")
WORLD = 4
TIMEOUT_S = 240
IMAGE, CLASSES, BATCH = 64, 10, 4
REDUCED_VIT = (16, 64, 2, 2)  # patch, width, depth, heads
# (name, data, model) of the worker's meshes
MESHES = {"m22": (2, 2), "m14": (1, 4), "m12": (1, 2)}
RING_SHAPE = (2, 32, 2, 16)  # B, T, H, D
EP = dict(b=2, t=6, c=16, e=4, h=8)
CE = dict(b=8, d=16, c=12)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_mesh(name):
    dp, mp = MESHES[name]
    return meshlib.make_mesh(meshlib.MeshSpec(dp, mp),
                             devices=jax.devices()[:dp * mp])


def ring_inputs():
    rng = np.random.default_rng(11)
    return [rng.normal(size=RING_SHAPE).astype(np.float32) for _ in range(4)]


def ep_inputs():
    rng = np.random.default_rng(12)
    b, t, c, e, h = (EP[k] for k in ("b", "t", "c", "e", "h"))
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    logits = rng.normal(size=(b, t, e)).astype(np.float32)
    top = np.argsort(-logits, axis=-1)[..., :2]
    gates = np.zeros_like(logits)
    vals = np.take_along_axis(logits, top, -1)
    vals = np.exp(vals - vals.max(-1, keepdims=True))
    np.put_along_axis(gates, top, vals / vals.sum(-1, keepdims=True), -1)
    banks = [rng.normal(size=s).astype(np.float32) * 0.3
             for s in ((e, c, h), (e, h), (e, h, c), (e, c))]
    gout = rng.normal(size=(b, t, c)).astype(np.float32)
    return x, gates, banks, gout


def ce_inputs():
    rng = np.random.default_rng(13)
    b, d, c = CE["b"], CE["d"], CE["c"]
    feats = rng.normal(size=(b, d)).astype(np.float32)
    weight = rng.normal(size=(c, d)).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    valid = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32)
    return feats, weight, labels, valid


def batches(seed):
    return [H.batch(IMAGE, BATCH, seed + s) for s in range(2)]


class patched_vit:
    """JAX's `vit_t16` at the reduced size while the block runs."""

    def __enter__(self):
        self.kept = jax_vit.VIT_CONFIGS["vit_t16"]
        jax_vit.VIT_CONFIGS["vit_t16"] = REDUCED_VIT

    def __exit__(self, *exc):
        jax_vit.VIT_CONFIGS["vit_t16"] = self.kept


def vit_cfg(moe=False):
    """The JAX baseline config of the reduced ViT (MoE: 4 experts, top-2,
    penalty weight 0.01) on synthetic data and the float32 wire."""
    from ddp_classification_pytorch_tpu.config import get_preset as jax_preset

    cfg = jax_preset("baseline")
    cfg.model.arch, cfg.model.dtype = "vit_t16", "float64"
    cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
    cfg.data.image_size, cfg.data.num_classes = IMAGE, CLASSES
    cfg.data.batch_size = BATCH
    for k, v in OPTIM.items():
        setattr(cfg.optim, k, v)
    if moe:
        cfg.model.moe_experts, cfg.model.moe_top_k = 4, 2
        cfg.model.moe_aux_weight = 0.01
    return cfg


def vit_params(moe=False):
    """numpy params of the reduced ViT (JAX init, seed 0 or 1), every
    bias and LayerNorm affine randomized."""
    cfg = vit_cfg(moe)
    cfg.model.dtype = "float32"
    with patched_vit():
        model = jax_factory.build_model(cfg.model, CLASSES)
        x = jnp.zeros((1, IMAGE, IMAGE, 3))
        p = jax.jit(lambda k: model.init(k, x, train=False))(
            jax.random.PRNGKey(int(moe)))["params"]
    rng = np.random.default_rng(20 + int(moe))

    def leaf(path, v):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, p)


def vit_port(params):
    return {f"backbone.{k}": v for k, v in vit_from_jax(params).items()}


def spawn(tmp, cases):
    """Start the worker on four gloo ranks with `cases` ("ring" or
    "model") and every case's inputs."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    data = {"image": IMAGE, "classes": CLASSES, "optim": dict(OPTIM),
            "cases": cases, "ring": [t(a) for a in ring_inputs()]}
    if cases == "model":
        x, gates, banks, gout = ep_inputs()
        ap, ast = H.variables("arcface", IMAGE)
        data.update(
            ep=(t(x), t(gates), [t(b) for b in banks], t(gout)),
            ce=tuple(t(a) for a in ce_inputs()),
            vit=vit_port(vit_params()), moe=vit_port(vit_params(True)),
            arcface=H.FROM_JAX["arcface"](ap, ast),
            batches=[(t(i), t(lb)) for i, lb in batches(300)],
            arcface_batches=[(t(i), t(lb)) for i, lb in batches(400)])
    inp = str(tmp / "in.pt")
    torch.save(data, inp)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(WORLD),
               OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in (os.environ.get("PYTHONPATH"),) if p])
    return [subprocess.Popen(
        [sys.executable, WORKER, inp, str(tmp)], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


def collect(procs, tmp):
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(logs)
    return [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def ranks(tmp_path_factory, cases):
    """The four ranks' results of `cases`, with the directory the worker
    wrote into (its checkpoint)."""
    tmp = tmp_path_factory.mktemp(cases)
    return collect(spawn(tmp, cases), tmp), tmp


def jax_steps_run(jcfg, jmodel, mesh, params, stats, batch_list):
    """JAX's train step on `mesh` in f64 (the model built on the mesh):
    metrics and params after each step."""
    tx = jax_schedule.build_optimizer(jcfg.optim, 1)
    jstep = jax_steps.make_train_step(jcfg, jmodel, tx, mesh=mesh)
    out = []
    with jax.enable_x64(True), mesh:
        p, s = H.f64(params), H.f64(stats)
        state = jax.device_put(
            JaxTrainState(step=jnp.zeros((), jnp.int32), params=p,
                          batch_stats=s, opt_state=tx.init(p)),
            meshlib.replicated(mesh))
        for images, labels in batch_list:
            b = [jax.device_put(a, meshlib.batch_sharding(mesh))
                 for a in (images.astype(np.float64), labels)]
            state, m = jstep(state, *b)
            out.append(({k: float(v) for k, v in m.items()},
                        H.f32(state.params), H.f32(state.batch_stats)))
    return out
