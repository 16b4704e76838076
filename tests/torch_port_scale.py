"""Shared pieces of the scaling levers' two-rank tests
(tests/test_torch_port_zero.py, tests/test_torch_port_grad_accum.py):
starting tests/torch_port_scale_worker.py on two gloo ranks, reading
back what they wrote, and the JAX reference on a `data` = 2 mesh."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddp_classification_pytorch_tpu.models import resnet as jax_resnet
from ddp_classification_pytorch_tpu.models.factory import ClassifierModel as JaxClassifier
from ddp_classification_pytorch_tpu.parallel import collectives
from ddp_classification_pytorch_tpu.parallel import mesh as meshlib
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu.train import steps as jax_steps
from ddp_classification_pytorch_tpu.train.state import TrainState as JaxTrainState
from ddp_classification_pytorch_tpu_torch.models.convert import resnet_from_jax

import torch_port_heads as H
from torch_port_helpers import OPTIM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_scale_worker.py")
IMAGE = 64
TIMEOUT_S = 180
WORLD = 2
REDUCED_R50 = dict(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_scale_worker(tmp, cases, batches, accum_batches, extra=None):
    """Start tests/torch_port_scale_worker.py on two gloo ranks over the
    reduced ResNet-50's weight seed 0 (fc and arcface) with `cases`;
    returns the processes (`collect_scale_worker` reads their results)."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    data = {"fc_state_dict": H.FROM_JAX["fc"](*H.variables("fc", IMAGE)),
            "arcface_state_dict": H.FROM_JAX["arcface"](
                *H.variables("arcface", IMAGE)),
            "optim": dict(OPTIM), "head_lr": 0.02, "cases": list(cases),
            "batches": [(t(i), t(lb)) for i, lb in batches],
            "accum_batches": [(t(i), t(lb)) for i, lb in accum_batches],
            **(extra or {})}
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


def collect_scale_worker(procs, tmp):
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(logs)
    return [torch.load(str(tmp / f"rank{r}.pt"), weights_only=True)
            for r in range(WORLD)]


def jax_dp2_run(jcfg, variables, batches):
    """JAX's train step on a `data` = 2 mesh with `mesh=` (so its explicit
    grad sections, `_accum_grad_section` / `_reduced_grad_section`, run
    over the reduced ResNet-50 in f64 with its SyncBN on the axis; ZeRO-1
    on, JAX's `auto`): metrics and the port-named state after each
    step."""
    def model(axis=None):
        return JaxClassifier(backbone=jax_resnet.ResNet(
            block_cls=jax_resnet.Bottleneck, dtype=jnp.float64,
            axis_name=axis, **REDUCED_R50))

    # the schedule counts updates: JAX's create_train_state passes K
    tx = jax_schedule.build_optimizer(jcfg.optim, 1,
                                      grad_accum=jcfg.parallel.grad_accum)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(data_parallel=WORLD),
                             devices=jax.devices()[:WORLD])
    real = collectives.build_ddp_model
    collectives.build_ddp_model = lambda cfg: model("data")
    try:
        jstep = jax_steps.make_train_step(jcfg, model(), tx, mesh=mesh)
        out = []
        with jax.enable_x64(True), mesh:
            params, stats = (H.f64(t) for t in variables)
            state = jax.device_put(
                JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=stats, opt_state=tx.init(params)),
                meshlib.replicated(mesh))
            for images, labels in batches:
                b = [jax.device_put(a, meshlib.batch_sharding(mesh))
                     for a in (images.astype(np.float64), labels)]
                state, m = jstep(state, *b)
                out.append(({k: float(v) for k, v in m.items()},
                            resnet_from_jax(H.f32(state.params),
                                            H.f32(state.batch_stats))))
    finally:
        collectives.build_ddp_model = real
    return out
