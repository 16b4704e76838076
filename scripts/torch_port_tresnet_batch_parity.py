#!/usr/bin/env python3
"""Why the TResNet train-step parity tests hold the port for two steps at
batch 4 only, and an accumulated step for one (tests/test_torch_port_
tresnet_train.py, tests/test_torch_port_grad_accum.py): the measurements
behind that choice.

    JAX_PLATFORMS=cpu python scripts/torch_port_tresnet_batch_parity.py

Prints one JSON object:

- `abn_backward`: the training ABN (`batch_norm_leaky_relu` forward and
  its vjp) at several (N, C, H, W), the JAX package's (its Pallas kernel
  in interpret mode) and the port's (`ops/fused_abn.py`'s plain
  versions, f32), each against the same math in f64 (torch autograd):
  the largest |dx|, |dscale| and |dbias| error of each side, beside the
  largest |dbias|;
- `tresnet_gradient`: one plain SGD step (lr 1, no momentum, no decay)
  of the reduced TResNet (stages (1,1,1,1), width 0.5, 10 classes, 64 px,
  the float32 wire, synthetic images from seed 10) at batch 4 and 16,
  the port in f32 against the JAX model in f64 (its Pallas ABN in
  interpret mode): per batch, the three parameters whose update differs
  most, relative to the largest update of that parameter.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from ddp_classification_pytorch_tpu.models.factory import ClassifierModel as JaxClassifier  # noqa: E402
from ddp_classification_pytorch_tpu.models.tresnet import TResNet as JaxTResNet  # noqa: E402
from ddp_classification_pytorch_tpu.ops import pallas_kernels  # noqa: E402
from ddp_classification_pytorch_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from ddp_classification_pytorch_tpu_torch.models import tresnet  # noqa: E402
from ddp_classification_pytorch_tpu_torch.models.convert import tresnet_from_jax  # noqa: E402
from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel  # noqa: E402
from ddp_classification_pytorch_tpu_torch.ops import fused_abn  # noqa: E402

import torch_port_steps  # noqa: E402
from torch_port_helpers import REDUCED, init_variables, randomize_bn  # noqa: E402

EPS, SLOPE = 1e-5, tresnet.SLOPE
ABN_SHAPES = [(4, 32, 16, 16), (16, 32, 16, 16), (8, 32, 32, 32),
              (16, 32, 32, 32)]


def abn_backward(shape):
    n, c, h, w = shape
    rng = np.random.default_rng(1)
    x = rng.normal(0.3, 1.5, (n, h, w, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0.0, 0.5, c).astype(np.float32)
    g = rng.normal(0.0, 1.0, (n, h, w, c)).astype(np.float32)
    # f64 reference: the same math through torch autograd
    xd, sd, bd = (torch.from_numpy(a).double().requires_grad_()
                  for a in (x, scale, bias))
    mean = xd.mean((0, 1, 2))
    var = ((xd - mean) ** 2).mean((0, 1, 2))
    z = (xd - mean) / torch.sqrt(var + EPS) * sd + bd
    ref = torch.autograd.grad(torch.where(z >= 0, z, z * SLOPE), (xd, sd, bd),
                              torch.from_numpy(g).double())
    ref = [r.numpy() for r in ref]
    (yj, mj, vj), vjp = jax.vjp(
        lambda a, s, b: pallas_kernels.batch_norm_leaky_relu(a, s, b, EPS,
                                                             SLOPE),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    jgrads = [np.asarray(t) for t in vjp((jnp.asarray(g), jnp.zeros_like(mj),
                                          jnp.zeros_like(vj)))]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
    yt, _, _ = fused_abn.batch_norm_leaky_relu(xt, st, bt, EPS, SLOPE)
    pgrads = torch.autograd.grad(yt, (xt, st, bt), torch.from_numpy(g).permute(
        0, 3, 1, 2))
    pgrads = [pgrads[0].permute(0, 2, 3, 1).numpy(), pgrads[1].numpy(),
              pgrads[2].numpy()]
    names = ("dx", "dscale", "dbias")
    return {"shape": list(shape), "rows": n * h * w,
            "jax_err": {k: float(np.abs(a - r).max())
                        for k, a, r in zip(names, jgrads, ref)},
            "port_err": {k: float(np.abs(a - r).max())
                         for k, a, r in zip(names, pgrads, ref)},
            "max_dbias": float(np.abs(ref[2]).max())}


def tresnet_gradient(batch):
    optim = dict(optimizer="sgd", lr=1.0, momentum=0.0, weight_decay=0.0,
                 schedule="constant", warmup_iters=0)
    jcfg, cfg = torch_port_steps.cfgs("baseline", "tresnet_m", 64, batch, 10,
                                      **optim)
    v = init_variables(JaxClassifier(backbone=JaxTResNet(
        dtype=jnp.float32, **REDUCED)), 64)
    params, stats = randomize_bn(v["params"], v["batch_stats"],
                                 np.random.default_rng(0))

    def from_jax(p, s):
        return {f"backbone.{k}": t for k, t in tresnet_from_jax(p, s).items()}

    both = torch_port_steps.SideBySide(
        jcfg, cfg, JaxClassifier(backbone=JaxTResNet(dtype=jnp.float64,
                                                     **REDUCED)),
        ClassifierModel(tresnet.TResNet(dtype=torch.float32, **REDUCED)),
        from_jax, params, stats, x64=True)
    torch_port_steps.TOL = dict(atol=np.inf, rtol=np.inf)  # measured below
    before = {k: t.clone() for k, t in both.state.model.state_dict().items()}
    ds = SyntheticDataset(batch, 64, 10, seed=10, out_dtype="float32")
    items = [ds[i] for i in range(batch)]
    both.step(np.stack([im for im, _ in items]),
              np.asarray([lb for _, lb in items], np.int32))
    want = from_jax(torch_port_steps.f32(both.jstate.params),
                    torch_port_steps.f32(both.jstate.batch_stats))
    rows = []
    for k, t in both.state.model.state_dict().items():
        if "running" in k or "num_batches" in k:
            continue
        port = (before[k] - t).double()
        ref = (before[k] - want[k]).double()
        top = ref.abs().max().item()
        rows.append({"param": k, "rel_err": (port - ref).abs().max().item()
                     / max(top, 1e-30), "max_update": top})
    rows.sort(key=lambda r: -r["rel_err"])
    return {"batch": batch, "worst": rows[:3]}


def main() -> None:
    torch.set_num_threads(1)
    print(json.dumps({
        "abn_backward": [abn_backward(s) for s in ABN_SHAPES],
        "tresnet_gradient": [tresnet_gradient(b) for b in (4, 16)]},
        indent=1))


if __name__ == "__main__":
    main()
