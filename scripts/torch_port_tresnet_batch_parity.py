#!/usr/bin/env python3
"""Why the TResNet train-step parity tests hold the port for two steps at
batch 4 only, and an accumulated step for one (tests/test_torch_port_
tresnet_train.py, tests/test_torch_port_grad_accum.py): the measurements
behind that choice. At batch 16 the port's f32 forward puts two
pre-activations of layer4.0's conv2 ABN, within f32 rounding of zero
(f64 outputs −1e-9 and −3e-9), on the other side of the LeakyReLU's gate
from JAX's f64 one; their gradients then differ by (1 − slope)·g, which
the backward spreads through the ABN's batch statistics. JAX's f32
forward happens to round them the f64 way. Neither side computes a
wrong value.

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
  most, relative to the largest update of that parameter;
- `module_bisect`: the same step's forward and backward module by module,
  at batch 4 and 16: the JAX f64 model's and the JAX f32 model's against
  the port's f32 one, each site's error relative to the f64 value's
  largest magnitude — the output of the stem and of every block
  (`stem`, `stage{i}_block0`, captured by intercepting the flax modules;
  forward hooks on the port's), the loss's gradient with respect to each
  of those outputs (JAX: a zero added to each output, differentiated;
  the port: `retain_grad`), and, inside each block, every parameter's
  gradient (SE, convs, ABNs, the identity BN). Each site is fed by its
  own side, so an error that appears at one site and not at the one
  before it arises there; the f32 JAX column tells an f32 effect from a
  fault of either side;
- `gate_flips`: at the ABN the bisect points to (layer4.0's conv2 ABN,
  JAX `stage4_block0/abn2`), the elements whose LeakyReLU gate (the sign
  of the output) differs from JAX's f64 forward, for the port's f32 and
  JAX's f32 forwards, with the f64 and f32 outputs there.
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


SITES = ("stem_abn", "stage1_block0", "stage2_block0", "stage3_block0",
         "stage4_block0")
PORT_SITES = ("body.conv1", "body.layer1.0", "body.layer2.0",
              "body.layer3.0", "body.layer4.0")


def _jax_sites(jmodel, variables, images, labels):
    """(loss, {site: output}, {site: dloss/doutput}, param grads) of the
    JAX model's training forward, a zero added to each site's output."""
    import flax.linen as fnn
    import optax

    def loss(params, deltas):
        outs = {}

        def add(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            name = context.module.name
            if context.method_name == "__call__" and name in deltas:
                out = out + deltas[name]
                outs[name] = out
            return out

        with fnn.intercept_methods(add):
            logits, _ = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                images, train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.result_type(float)), labels).mean()
        return ce, outs

    shapes = {}

    def probe(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and context.module.name in SITES:
            shapes[context.module.name] = out
        return out

    with fnn.intercept_methods(probe):
        jax.eval_shape(lambda: jmodel.apply(
            {"params": variables["params"],
             "batch_stats": variables["batch_stats"]}, images, train=True,
            mutable=["batch_stats"]))
    deltas = {k: jnp.zeros(v.shape, v.dtype) for k, v in shapes.items()}
    (value, outs), (pgrads, dgrads) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"], deltas)
    return value, outs, dgrads, pgrads


def module_bisect(batch):
    v = init_variables(JaxClassifier(backbone=JaxTResNet(
        dtype=jnp.float32, **REDUCED)), 64)
    params, stats = randomize_bn(v["params"], v["batch_stats"],
                                 np.random.default_rng(0))
    ds = SyntheticDataset(batch, 64, 10, seed=10, out_dtype="float32")
    items = [ds[i] for i in range(batch)]
    images = np.stack([im for im, _ in items])
    labels = np.asarray([lb for _, lb in items], np.int32)
    sides = {}
    for name, dt in (("jax_f64", jnp.float64), ("jax_f32", jnp.float32)):
        with jax.enable_x64(dt == jnp.float64):
            cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
                lambda a: jnp.asarray(a, dt), t)
            jmodel = JaxClassifier(backbone=JaxTResNet(dtype=dt, **REDUCED))
            value, outs, dgrads, pgrads = _jax_sites(
                jmodel, {"params": cast(params), "batch_stats": cast(stats)},
                jnp.asarray(images, dt), jnp.asarray(labels))
            fwd = {k: np.asarray(o, np.float64) for k, o in outs.items()}
            bwd = {k: np.asarray(g, np.float64) for k, g in dgrads.items()}
            pg = {k: t.double().numpy() for k, t in tresnet_from_jax(
                jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       pgrads), stats).items()}
            sides[name] = (float(value), fwd, bwd, pg)
    model = ClassifierModel(tresnet.TResNet(dtype=torch.float32, **REDUCED))
    model.load_state_dict({f"backbone.{k}": t for k, t in
                           tresnet_from_jax(params, stats).items()})
    model.train()
    outs = {}

    def hook(site):
        def keep(mod, args, out):
            out.retain_grad()
            outs[site] = out
        return keep

    mods = dict(model.backbone.named_modules())
    for site, pname in zip(SITES, PORT_SITES):
        mods[pname].register_forward_hook(hook(site))
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    loss = torch.nn.functional.cross_entropy(model(x), torch.from_numpy(
        labels).long())
    loss.backward()
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).double().numpy()  # noqa: E731
    port = (loss.item(), {k: nhwc(o) for k, o in outs.items()},
            {k: nhwc(o.grad) for k, o in outs.items()},
            {k.removeprefix("backbone."): p.grad.double().numpy()
             for k, p in model.named_parameters()})

    def rel(a, ref):
        return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300))

    ref = sides["jax_f64"]
    out = {"batch": batch, "loss": {"jax_f64": ref[0],
                                    "jax_f32": sides["jax_f32"][0],
                                    "port_f32": port[0]}}
    for label, side in (("jax_f32", sides["jax_f32"]), ("port_f32", port)):
        out[label] = {
            "forward": {k: rel(side[1][k], ref[1][k]) for k in SITES},
            "d_output": {k: rel(side[2][k], ref[2][k]) for k in SITES},
            "param_grads": {k: rel(side[3][k], ref[3][k])
                            for k in sorted(ref[3], key=lambda n: (
                                n.split(".")[:3], n))
                            if k in side[3] and "running" not in k}}
    return out


def gate_flips(batch):
    import flax.linen as fnn

    v = init_variables(JaxClassifier(backbone=JaxTResNet(
        dtype=jnp.float32, **REDUCED)), 64)
    params, stats = randomize_bn(v["params"], v["batch_stats"],
                                 np.random.default_rng(0))
    ds = SyntheticDataset(batch, 64, 10, seed=10, out_dtype="float32")
    images = np.stack([ds[i][0] for i in range(batch)])
    ys = {}
    for name, dt in (("jax_f64", jnp.float64), ("jax_f32", jnp.float32)):
        def grab(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if (context.method_name == "__call__"
                    and context.module.name == "abn2"
                    and context.module.parent.name == "stage4_block0"):
                ys[name] = np.asarray(out, np.float64)
            return out

        with jax.enable_x64(dt == jnp.float64), fnn.intercept_methods(grab):
            cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
                lambda a: jnp.asarray(a, dt), t)
            JaxClassifier(backbone=JaxTResNet(dtype=dt, **REDUCED)).apply(
                {"params": cast(params), "batch_stats": cast(stats)},
                jnp.asarray(images, dt), train=True, mutable=["batch_stats"])
    model = ClassifierModel(tresnet.TResNet(dtype=torch.float32, **REDUCED))
    model.load_state_dict({f"backbone.{k}": t for k, t in
                           tresnet_from_jax(params, stats).items()})
    dict(model.backbone.named_modules())[
        "body.layer4.0.conv2.0.1"].register_forward_hook(
        lambda m, a, o: ys.update(port_f32=o.detach().permute(
            0, 2, 3, 1).double().numpy()))
    with torch.no_grad():
        model.train()(torch.from_numpy(images).permute(0, 3, 1, 2))
    ref = ys["jax_f64"]
    out = {"batch": batch, "rows": int(np.prod(ref.shape[:3]))}
    for name in ("jax_f32", "port_f32"):
        flips = np.argwhere(np.sign(ys[name]) != np.sign(ref))
        out[name] = [{"nhwc": [int(i) for i in f],
                      "f64_output": float(ref[tuple(f)]),
                      "f32_output": float(ys[name][tuple(f)])}
                     for f in flips]
    return out


def main() -> None:
    torch.set_num_threads(1)
    print(json.dumps({
        "abn_backward": [abn_backward(s) for s in ABN_SHAPES],
        "tresnet_gradient": [tresnet_gradient(b) for b in (4, 16)],
        "module_bisect": [module_bisect(b) for b in (4, 16)],
        "gate_flips": [gate_flips(b) for b in (4, 16)]},
        indent=1))


if __name__ == "__main__":
    main()
