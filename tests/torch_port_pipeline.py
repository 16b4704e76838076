"""Shared pieces of the GPipe tests (tests/test_torch_port_pipeline.py,
tests/test_torch_port_three_axis.py): the toy block and the reduced
pipelined ViT on both sides, the inputs of every case, starting
tests/torch_port_pipeline_worker.py once on four gloo ranks and reading
back what they wrote, and the JAX references on the 8-device CPU mesh of
tests/conftest.py."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddp_classification_pytorch_tpu.config import get_preset as jax_preset
from ddp_classification_pytorch_tpu.models import factory as jax_factory
from ddp_classification_pytorch_tpu.models import vit as jax_vit
from ddp_classification_pytorch_tpu.parallel import mesh as meshlib
from ddp_classification_pytorch_tpu_torch.models.convert import (
    gpipe_arcface_from_jax,
    gpipe_vit_from_jax,
)

import torch_port_model_axis as MA
from torch_port_helpers import OPTIM

REPO = MA.REPO
WORKER = os.path.join(REPO, "tests", "torch_port_pipeline_worker.py")
WORLD = 4
TIMEOUT_S = 300
IMAGE, CLASSES, BATCH = 32, 8, 8   # 4 tokens; the arcface cases' batch
PIPE_VIT = (16, 64, 4, 2)  # patch, width, depth, heads: 2 blocks a stage
TOY = dict(depth=8, ch=16, b=8, t=4)
# (S, M) of the executor's cases and the port's mesh (data, model, pipe)
EXEC = {(2, 2): (2, 1, 2), (4, 4): (1, 1, 4)}
MICRO = 2


def toy_params(seed=0):
    """JAX's toy stack (tests/test_pipeline.py): w (L, C, C), b (L, C)."""
    rng = np.random.default_rng(seed)
    d, c = TOY["depth"], TOY["ch"]
    return (rng.normal(scale=0.3, size=(d, c, c)).astype(np.float32),
            rng.normal(scale=0.1, size=(d, c)).astype(np.float32))


def toy_x(b=TOY["b"], seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, TOY["t"], TOY["ch"])).astype(np.float32)


def jax_toy(stages, micro, x=None):
    """JAX's `gpipe` of the toy stack on a (8/S, S) mesh: the output and
    the gradients of mean(out²) w.r.t. x, w and b."""
    jpipe = __import__("ddp_classification_pytorch_tpu.ops.pipeline",
                       fromlist=["gpipe"])
    w, b = toy_params()
    x = toy_x() if x is None else x
    mesh = meshlib.make_mesh(meshlib.MeshSpec(8 // stages, stages))

    def block(p, h):
        return jax.nn.gelu(h @ p["w"] + p["b"])

    def f(x, p):
        return jpipe.gpipe(block, p, x, mesh=mesh,
                           axis_name=meshlib.MODEL_AXIS, microbatches=micro)

    def loss(x, p):
        return (f(x, p) ** 2).mean()

    p = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    out = jax.jit(f)(jnp.asarray(x), p)
    gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), p)
    return [np.asarray(a) for a in (out, gx, gp["w"], gp["b"])]


class patched_vit:
    """JAX's `vit_t16` at PIPE_VIT while the block runs."""

    def __enter__(self):
        self.kept = jax_vit.VIT_CONFIGS["vit_t16"]
        jax_vit.VIT_CONFIGS["vit_t16"] = PIPE_VIT

    def __exit__(self, *exc):
        jax_vit.VIT_CONFIGS["vit_t16"] = self.kept


def jax_cfg(workload="baseline", mp=1, pp=0, sharded_ce=False,
            image=MA.IMAGE, classes=MA.CLASSES, batch=MA.BATCH):
    """The JAX config of the reduced pipelined ViT (f64 compute, the
    step parity recipe), `pipeline_microbatches` MICRO."""
    cfg = jax_preset(workload)
    cfg.model.arch, cfg.model.dtype = "vit_t16", "float64"
    cfg.model.dropout = 0.0
    cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
    cfg.data.image_size, cfg.data.num_classes = image, classes
    cfg.data.batch_size = batch
    cfg.model.arc_embed_dim = 64
    for k, v in OPTIM.items():
        setattr(cfg.optim, k, v)
    cfg.parallel.model_axis = mp
    cfg.parallel.pipeline_stages = pp
    cfg.parallel.pipeline_microbatches = MICRO
    cfg.parallel.arcface_sharded_ce = sharded_ce
    return cfg


def jax_model(cfg, mesh):
    with patched_vit():
        return jax_factory.build_model(
            cfg.model, cfg.data.num_classes, mesh=mesh,
            pipeline_microbatches=cfg.parallel.pipeline_microbatches)


def jax_params(head="fc", image=MA.IMAGE, classes=MA.CLASSES, seed=0):
    """numpy params of the reduced pipelined ViT (JAX init), every bias
    and LayerNorm affine randomized, the margin N(0, 1)."""
    cfg = jax_cfg("arcface" if head == "arcface" else "baseline",
                  image=image, classes=classes)
    cfg.model.dtype = "float32"
    mesh = meshlib.make_mesh(meshlib.MeshSpec(8, 1))
    model = jax_model(cfg, mesh)
    with patched_vit():
        p = model.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, image, image, 3)))["params"]
    rng = np.random.default_rng(40 + seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        if name == "weight":  # the margin
            return rng.normal(size=v.shape).astype(np.float32)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, p)


def port_sd(params, head="fc"):
    return (gpipe_arcface_from_jax(params) if head == "arcface"
            else gpipe_vit_from_jax(params))


def arc_batches(seed, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
             rng.integers(0, CLASSES, BATCH).astype(np.int32))
            for _ in range(n)]


def spawn(tmp, cases):
    """Start the worker on four gloo ranks with `cases` ("pipe" or
    "three") and every case's inputs."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    w, b = toy_params()
    data = {"cases": cases, "optim": dict(OPTIM), "micro": MICRO,
            "ports": [MA._free_port() for _ in range(3)]}
    if cases == "pipe":
        data.update(
            toy=(t(w), t(b), t(toy_x()), t(toy_x(b=6))),
            image=MA.IMAGE, classes=MA.CLASSES,
            vit=port_sd(jax_params()),
            batches=[(t(i), t(lb)) for i, lb in MA.batches(300)])
    else:
        data.update(
            image=IMAGE, classes=CLASSES,
            arcface=port_sd(jax_params("arcface", IMAGE, CLASSES),
                            "arcface"),
            batches=[(t(i), t(lb)) for i, lb in arc_batches(500)])
    inp = str(tmp / "in.pt")
    torch.save(data, inp)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(data["ports"][0]), WORLD_SIZE=str(WORLD),
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
            for r in range(WORLD)], logs


def ranks(tmp_path_factory, cases):
    """The four ranks' results of `cases`, their logs and the directory
    the worker wrote into."""
    tmp = tmp_path_factory.mktemp(cases)
    res, logs = collect(spawn(tmp, cases), tmp)
    return res, logs, tmp


def jax_mesh(dp, mp, pp=1):
    return meshlib.make_mesh(meshlib.MeshSpec(dp, mp, pp),
                             devices=jax.devices()[:dp * mp * pp])
