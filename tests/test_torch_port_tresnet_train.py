"""TResNet training in the torch port against the JAX package, on the CPU,
where the port's ABN wrappers take their plain versions and the JAX side
runs its Pallas kernel in interpret mode (as tests/test_pallas_kernels.py
runs it).

(a) Training-mode ABN: `batch_norm_leaky_relu` forward and `jax.vjp`
    against the port's autograd Function `FusedBNLeakyReLU`, and the plain
    versions of K1s/K1r/K1d and `fused_bn_leaky_relu_backward_ref` against
    the JAX `_bwd` on the same residuals. Tolerances are
    test_pallas_kernels.py's: forward and statistics 1e-5, gradients 2e-4,
    bf16 0.05 (both sides round to bf16; a value can sit on a rounding
    boundary).
    The identity BN against flax's `nn.BatchNorm` in training mode:
    output, input/scale/bias gradients and the running update at 1e-5.
(b) Two train steps of the reduced TResNet (stages (1,1,1,1), width 0.5,
    10 classes, 64 px, f32, batch 4) from the same weights and batch, with
    SGD momentum and weight decay under a warmup (torch_port_helpers.OPTIM):
    loss, grad norm, every parameter and every running mean and variance
    after each step, atol 1e-5 / rtol 1e-4 (f32 sums in another order, as
    tests/test_torch_port_train.py holds the ViT).
(c) A step with a NaN pixel on the float32 wire is skipped on both sides:
    parameters, momentum, the update count and the running statistics stay.
(d) `cli/train.py --model tresnet_m` on the CPU writes a checkpoint that
    `cli/serve.py --ckpt` serves (2 train steps and 1 eval batch of the
    full TResNet-M at 64 px, then 2 served requests: about 2 s in the
    suite, 12 s as two fresh processes).
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.config import get_preset as jax_preset
from ddp_classification_pytorch_tpu.models.factory import ClassifierModel as JaxClassifier
from ddp_classification_pytorch_tpu.models.tresnet import TResNet as JaxTResNet
from ddp_classification_pytorch_tpu.ops import pallas_kernels
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu.train import steps as jax_steps
from ddp_classification_pytorch_tpu.train.state import TrainState as JaxTrainState
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.data.synthetic import SyntheticDataset
from ddp_classification_pytorch_tpu_torch.models import tresnet
from ddp_classification_pytorch_tpu_torch.models.convert import tresnet_from_jax
from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel
from ddp_classification_pytorch_tpu_torch.ops import fused_abn
from ddp_classification_pytorch_tpu_torch.train import schedule, steps
from ddp_classification_pytorch_tpu_torch.train.state import TrainState

from torch_port_helpers import OPTIM, REDUCED, init_variables, randomize_bn

EPS, SLOPE = 1e-5, tresnet.SLOPE
_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 2e-4),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05, 0.05)}
IMAGE, BATCH = 64, 4


def _abn_inputs(shape, seed):
    """x as NHWC numpy (N, H, W, C) from an (N, C, H, W) shape, scale,
    bias and a cotangent for y."""
    n, c, h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.5, (n, h, w, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0.0, 0.5, c).astype(np.float32)
    g = rng.normal(0.0, 1.0, (n, h, w, c)).astype(np.float32)
    return x, scale, bias, g


def _nchw(a, dtype):
    """NHWC numpy → the port's NCHW view, channels_last in memory."""
    return torch.from_numpy(np.array(a, order="C")).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _close(got, want, tol, msg):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("shape", [(4, 32, 8, 8), (6, 36, 5, 7)],
                         ids=["4x32x8x8", "6x36x5x7"])
def test_abn_training_forward_and_vjp_match_jax(shape, dtype):
    jdt, tdt, fwd_tol, grad_tol = _DTYPES[dtype]
    x, scale, bias, g = _abn_inputs(shape, seed=shape[1])
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    (yj, mj, vj), vjp = jax.vjp(
        lambda a, s, b: pallas_kernels.batch_norm_leaky_relu(a, s, b, EPS, SLOPE),
        xj, jnp.asarray(scale), jnp.asarray(bias))
    dxj, dsj, dbj = vjp((gj, jnp.zeros_like(mj), jnp.zeros_like(vj)))

    xt = _nchw(x, tdt).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    yt, mt, vt = fused_abn.batch_norm_leaky_relu(xt, st, bt, EPS, SLOPE)
    assert yt.dtype == tdt and yt.is_contiguous(memory_format=torch.channels_last)
    assert not (mt.requires_grad or vt.requires_grad)
    dxt, dst, dbt = torch.autograd.grad(yt, (xt, st, bt), _nchw(g, tdt))
    assert dxt.dtype == tdt

    _close(_nhwc(yt), yj, fwd_tol, "y")
    _close(mt.numpy(), mj, 1e-5, "mean")
    _close(vt.numpy(), vj, 1e-5, "var")
    _close(_nhwc(dxt), dxj, grad_tol, "dx")
    _close(dst.numpy(), dsj, grad_tol, "dscale")
    _close(dbt.numpy(), dbj, grad_tol, "dbias")


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("shape", [(4, 32, 8, 8), (6, 36, 5, 7)],
                         ids=["4x32x8x8", "6x36x5x7"])
def test_plain_versions_match_jax_bwd(shape, dtype):
    """On the JAX forward's own residuals: K1s's plain version against its
    statistics and inv_std, and `fused_bn_leaky_relu_backward_ref` and
    the K1r + K1d plain pair against `_bwd`."""
    jdt, tdt, _, grad_tol = _DTYPES[dtype]
    x, scale, bias, g = _abn_inputs(shape, seed=shape[1] + 1)
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    yj, mj, vj = pallas_kernels.batch_norm_leaky_relu(
        xj, jnp.asarray(scale), jnp.asarray(bias), EPS, SLOPE)
    invj = jax.lax.rsqrt(vj + EPS)
    want = pallas_kernels._bwd(EPS, SLOPE, (xj, jnp.asarray(scale),
                                            jnp.asarray(bias), mj, invj, yj), gj)

    xt, gt, yt = (_nchw(np.asarray(a, np.float32), tdt) for a in (xj, gj, yj))
    mean, var, inv = fused_abn.bn_stats_ref(xt, EPS)
    _close(mean.numpy(), mj, 1e-5, "mean")
    _close(var.numpy(), vj, 1e-5, "var")
    _close(inv.numpy(), invj, 1e-5, "inv_std")

    st, mt, it = (torch.from_numpy(np.array(a)) for a in (scale, mj, invj))
    line = fused_abn.fused_bn_leaky_relu_backward_ref(gt, xt, yt, st, mt, it, SLOPE)
    ds, db = fused_abn.abn_grad_sums_ref(gt, yt, xt, mt, it, SLOPE)
    dx = fused_abn.abn_grad_input_ref(gt, yt, xt, st, mt, it, ds, db, SLOPE)
    for name, a, b, w in (("dx", line[0], dx, want[0]),
                          ("dscale", line[1], ds, want[1]),
                          ("dbias", line[2], db, want[2])):
        if a.dim() == 4:
            assert a.dtype == b.dtype == tdt
            a, b = _nhwc(a), _nhwc(b)
        _close(a, w, grad_tol, f"{name} (line for line)")
        _close(b, w, grad_tol, f"{name} (K1r + K1d)")


def test_gradient_in_another_layout_is_copied_and_counted():
    """A g that does not share y's layout (here NCHW, from a loss whose
    weight is NCHW) is copied into it, counted, and gives the gradients a
    channels_last g gives."""
    x, scale, bias, g = _abn_inputs((2, 8, 3, 5), seed=3)
    grads = []
    for relayout in (False, True):
        xt = _nchw(x, torch.float32).requires_grad_()
        y, _, _ = fused_abn.batch_norm_leaky_relu(
            xt, torch.from_numpy(scale), torch.from_numpy(bias), EPS, SLOPE)
        weight = _nchw(g, torch.float32)  # channels_last, as y
        if relayout:
            weight = weight.contiguous()
        before = fused_abn.FusedBNLeakyReLU.layout_copies
        (y * weight).sum().backward()
        assert fused_abn.FusedBNLeakyReLU.layout_copies == before + relayout
        grads.append(xt.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_identity_bn_training_matches_flax_batchnorm():
    """`BatchNorm` in training mode against flax 0.12.3's `nn.BatchNorm`
    (momentum 0.9): output, the gradients of x, γ and β, and the running
    update (biased variance, clamped at 0)."""
    x, scale, bias, g = _abn_inputs((4, 16, 6, 6), seed=5)
    rng = np.random.default_rng(6)
    ra_mean = rng.normal(0, 0.2, 16).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=EPS,
                       dtype=jnp.float32)

    def apply(xa, s, b):
        return bn.apply({"params": {"scale": s, "bias": b},
                         "batch_stats": {"mean": jnp.asarray(ra_mean),
                                         "var": jnp.asarray(ra_var)}},
                        xa, mutable=["batch_stats"])

    inputs = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    yj, mutated = apply(*inputs)
    _, vjp = jax.vjp(lambda *a: apply(*a)[0], *inputs)
    dxj, dsj, dbj = vjp(jnp.asarray(g))

    port = tresnet.BatchNorm(16).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(ra_mean))
        port.running_var.copy_(torch.from_numpy(ra_var))
    xt = _nchw(x, torch.float32).requires_grad_()
    y = port(xt)
    dxt, dst, dbt = torch.autograd.grad(y, (xt, port.weight, port.bias),
                                        _nchw(g, torch.float32))
    _close(_nhwc(y), yj, 1e-5, "y")
    _close(_nhwc(dxt), dxj, 1e-5, "dx")
    _close(dst.numpy(), dsj, 1e-5, "dscale")
    _close(dbt.numpy(), dbj, 1e-5, "dbias")
    _close(port.running_mean.numpy(), mutated["batch_stats"]["mean"], 1e-5,
           "running_mean")
    _close(port.running_var.numpy(), mutated["batch_stats"]["var"], 1e-5,
           "running_var")


def test_f32_master_weights_run_in_the_compute_dtype():
    """A bf16 TResNet with f32 weights (a trainer's) gives the bits of the
    same model after `cast_to_compute_dtype` (the server's): the convs and
    the blur cast their weights per call."""
    model = tresnet.TResNet(dtype=torch.bfloat16, **REDUCED)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    served = tresnet.TResNet(dtype=torch.bfloat16, **REDUCED)
    served.load_state_dict(model.state_dict())
    served.cast_to_compute_dtype()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.randn((2, 3, 32, 32), generator=gen)
    with torch.inference_mode():
        torch.testing.assert_close(model.eval()(x), served.eval()(x), rtol=0,
                                   atol=0)


# ------------------------------------------------------------ train steps --

def _jax_model():
    return JaxClassifier(backbone=JaxTResNet(dtype=jnp.float32, **REDUCED))


def _cfgs():
    """(JAX cfg, port cfg): the baseline recipe on the float32 wire."""
    cfgs = (jax_preset("baseline"), get_preset("baseline"))
    for cfg in cfgs:
        cfg.model.arch = "tresnet_m"
        cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
        cfg.data.image_size, cfg.data.num_classes = IMAGE, 10
        cfg.data.batch_size = BATCH
        for k, v in OPTIM.items():
            setattr(cfg.optim, k, v)
    return cfgs


@pytest.fixture(scope="module")
def variables():
    """numpy params and batch statistics with every BN γ, β and running
    statistic randomized (the JAX step donates its state, so each test
    places its own copy)."""
    v = init_variables(_jax_model(), IMAGE)
    return randomize_bn(v["params"], v["batch_stats"],
                        np.random.default_rng(0))


@pytest.fixture(scope="module")
def jax_step():
    """One jitted JAX train step (and its optimizer) for every test here:
    they share the float32 wire, so it compiles once."""
    jcfg, _ = _cfgs()
    tx = jax_schedule.build_optimizer(jcfg.optim, 1)
    return tx, jax_steps.make_train_step(jcfg, _jax_model(), tx)


def _states(variables, jax_step):
    params, stats = (jax.tree_util.tree_map(jnp.asarray, t) for t in variables)
    tx, jstep = jax_step
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=tx.init(params))
    _, cfg = _cfgs()
    model = ClassifierModel(tresnet.TResNet(dtype=torch.float32, **REDUCED))
    model.load_state_dict({f"backbone.{k}": v for k, v in
                           tresnet_from_jax(*variables).items()})
    model.to(memory_format=torch.channels_last)  # as create_train_state
    state = TrainState(model, schedule.build_optimizer(cfg.optim,
                                                       model.parameters()),
                       schedule.build_schedule(cfg.optim, 1))
    return [jstate, jstep], (state, steps.make_train_step(cfg))


def _batch(seed):
    ds = SyntheticDataset(BATCH, IMAGE, 10, seed=seed, out_dtype="float32")
    items = [ds[i] for i in range(BATCH)]
    return (np.stack([im for im, _ in items]),
            np.asarray([lb for _, lb in items], np.int32))


def _step_both(j, p, images, labels):
    j[0], jm = j[1](j[0], jnp.asarray(images), jnp.asarray(labels))
    state, step = p
    m = step(state, torch.from_numpy(images), torch.from_numpy(labels))
    for key in ("loss", "grad_norm", "top1", "top3", "step_ok"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), atol=1e-5,
                                   rtol=1e-4, err_msg=key)
    return m


def _assert_state_matches(jstate, model):
    """Every parameter and every running mean and variance."""
    want = tresnet_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                            jax.tree_util.tree_map(np.asarray,
                                                   jstate.batch_stats))
    got = model.backbone.state_dict()
    assert sorted(got) == sorted(want)
    assert sum(k.endswith("running_var") for k in want) == 14  # 7 ABN + 7 BN
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_two_train_steps_match_jax(variables, jax_step):
    j, p = _states(variables, jax_step)
    before = {k: v.clone() for k, v in p[0].model.state_dict().items()}
    for seed in (10, 11):
        m = _step_both(j, p, *_batch(seed))
        assert float(m["step_ok"]) == 1.0
        _assert_state_matches(j[0], p[0].model)
    moved = [k for k, v in p[0].model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))
             and not torch.equal(v, before[k])]
    assert len(moved) == 28  # every running statistic took the batch's
    assert p[0].step == int(j[0].step) == 2 and p[0].opt_count == 2


def test_skipped_step_keeps_running_statistics(variables, jax_step):
    """good, then a NaN pixel: the NaN step is skipped on both sides and
    leaves the parameters, the momentum, the update count and every
    running statistic as they were (the JAX step's `keep`)."""
    j, p = _states(variables, jax_step)
    images, labels = _batch(12)
    _step_both(j, p, images, labels)
    state = p[0]
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    momentum = [state.optimizer.state[q]["momentum_buffer"].clone()
                for q in state.params]
    bad = images.copy()
    bad[1, 3, 5, 0] = np.nan
    m = _step_both(j, p, bad, labels)
    assert float(m["step_ok"]) == 0.0
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    for q, mom in zip(state.params, momentum):
        torch.testing.assert_close(state.optimizer.state[q]["momentum_buffer"],
                                   mom, rtol=0, atol=0)
    assert state.step == 2 and state.opt_count == 1
    _assert_state_matches(j[0], state.model)


def _rc(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        return e.code
    return 0


def test_cli_trains_tresnet_m_and_serves_its_checkpoint(tmp_path):
    out = str(tmp_path / "run")
    argv = ["baseline", "--dataset", "synthetic", "--model", "tresnet_m",
            "--image_size", "64", "--num_classes", "10", "--batchsize", "4",
            "--synthetic_size", "8", "--epochs", "1", "--dtype", "float32",
            "--device", "cpu", "--out", out]
    assert _rc(train_cli.main, argv) == 0
    ckpt = os.path.join(out, "ckpt_e0.pt")
    for name in ("output.txt", "history.json", "meta.json", "ckpt_e0.pt",
                 "ckpt_e0.pt.sha256"):
        assert os.path.isfile(os.path.join(out, name)), name
    assert _rc(serve_cli.main, [
        "baseline", "--model", "tresnet_m", "--image_size", "64",
        "--num_classes", "10", "--dtype", "float32", "--device", "cpu",
        "--ckpt", ckpt, "--selfcheck", "2"]) == 0
