#!/usr/bin/env python3
"""How far f32 can hold ResNet parity on the CPU: the measurements behind
the design of tests/test_torch_port_resnet.py and tests/test_torch_port_ddp.py
(the JAX side run in f64; the full depth checked block by block in
training mode).

    JAX_PLATFORMS=cpu python scripts/torch_port_resnet_conditioning.py

Prints one JSON object:

- `grads`: for five weight seeds of the reduced ResNet-50 (Bottleneck,
  stages (1,1,1,1), 8 filters, 10 classes; weights as
  `torch_port_helpers.random_variables` draws them), one training-mode
  batch of 8 N(0, 1) images at 64 px: the largest |gradient − the JAX
  model's f64 gradient| over all parameters, for the JAX model in f32 and
  for the port in f32, beside the largest f64 gradient;
- `full_depth_train_logits`: ResNet-50 at full depth, batch 2, in
  training mode: the port's f32 logits against the JAX model's f64 ones,
  as a multiple of the tests' tolerance (atol 1e-5 + rtol 1e-4 · |ref|),
  at 32, 64 and 224 px.
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
import optax  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from ddp_classification_pytorch_tpu.models import resnet as jax_resnet  # noqa: E402
from ddp_classification_pytorch_tpu_torch.models import resnet  # noqa: E402
from ddp_classification_pytorch_tpu_torch.models.convert import resnet_from_jax  # noqa: E402
from torch_port_helpers import random_variables  # noqa: E402

REDUCED = dict(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _images(n, px, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, px, px, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _jax_grads(dtype, params, stats, x, y):
    model = jax_resnet.ResNet(block_cls=jax_resnet.Bottleneck, dtype=dtype,
                              **REDUCED)

    def loss(p):
        logits, _ = model.apply({"params": p, "batch_stats": stats}, x,
                                train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    g = jax.jit(jax.grad(loss))(params)
    return resnet_from_jax(*(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), t) for t in (g, stats)))


def grads() -> list:
    rows = []
    shape_model = jax_resnet.ResNet(block_cls=jax_resnet.Bottleneck,
                                    dtype=jnp.float32, **REDUCED)
    x, y = _images(8, 64, 10)
    for seed in range(5):
        params, stats = random_variables(shape_model, 64,
                                         np.random.default_rng(seed))
        g32 = _jax_grads(jnp.float32, params, stats, x, y)
        with jax.enable_x64(True):
            g64 = _jax_grads(jnp.float64, _f64(params), _f64(stats),
                             jnp.asarray(x, jnp.float64), y)
        port = resnet.ResNet(block_cls=resnet.Bottleneck, dtype=torch.float32,
                             **REDUCED)
        port.load_state_dict(resnet_from_jax(params, stats))
        port.to(memory_format=torch.channels_last).train()
        F.cross_entropy(port(torch.from_numpy(x).permute(0, 3, 1, 2)),
                        torch.from_numpy(y).long()).backward()
        pg = {k: p.grad.double() for k, p in port.named_parameters()}
        rows.append({
            "seed": seed,
            "jax_f32_vs_f64": max((g32[k] - g64[k]).abs().max().item()
                                  for k in pg),
            "port_f32_vs_jax_f64": max((pg[k] - g64[k]).abs().max().item()
                                       for k in pg),
            "largest_f64_gradient": max(g64[k].abs().max().item() for k in pg)})
    return rows


def full_depth() -> dict:
    out = {}
    for px in (32, 64, 224):
        params, stats = random_variables(jax_resnet.resnet50(num_classes=10),
                                         px, np.random.default_rng(0))
        x, _ = _images(2, px, 1)
        with jax.enable_x64(True):
            jmodel = jax_resnet.resnet50(num_classes=10, dtype=jnp.float64)
            want, _ = jax.jit(lambda v, x: jmodel.apply(
                v, x, train=True, mutable=["batch_stats"]))(
                _f64({"params": params, "batch_stats": stats}),
                jnp.asarray(x, jnp.float64))
            want = np.asarray(want)
        port = resnet.build_resnet("resnet50", 10, dtype=torch.float32)
        port.load_state_dict(resnet_from_jax(params, stats))
        port.to(memory_format=torch.channels_last).train()
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).double().numpy()
        out[f"{px}px"] = float((np.abs(got - want)
                                / (1e-5 + 1e-4 * np.abs(want))).max())
    return out


if __name__ == "__main__":
    print(json.dumps({"grads": grads(),
                      "full_depth_train_logits": full_depth()}))
