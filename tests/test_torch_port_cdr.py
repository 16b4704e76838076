"""The port's CDR workload against the JAX package's, on the CPU.

(a) `cdr_mask_` against `cdr_gradient_transform` on the same f32 tree (a
    4-D kernel, channels_last on the port's side, a 2-D one and a bias
    vector, which passes untouched): the threshold and the masked
    gradients bitwise, with the dead schedule (clip 1 − noise_rate) and
    the live one at two epochs (the clip indexed by the update count);
    `cdr_clip_schedule` bitwise.
(b) Two train steps of the cdr preset (SGD with momentum, weight decay,
    warmup: torch_port_helpers.OPTIM) of the reduced ResNet-50 against JAX
    `make_train_step`: loss, grad norm, every parameter and running
    statistic. The port's f32 gradients differ from JAX's f64 ones in the
    last bits, so an element whose |g·v| lies within rounding of the
    threshold may fall on the other side: the JAX mask (from JAX's f64
    gradients) and the port's are compared, and every element where they
    differ must lie in the band |g·v − thresh| ≤ BAND·thresh of JAX's
    threshold; such an element is left out of the parameter comparison
    (its update is the masked-out gradient) and counted.
(c) `cli/train.py cdr --device cpu` at 32 px trains with the transform on
    (rc 0).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.ops import cdr as jax_cdr
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu.train import steps as jax_steps
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.ops import cdr
from ddp_classification_pytorch_tpu_torch.train import checkpoint, steps

import torch_port_heads as H
from torch_port_helpers import OPTIM

# elements whose JAX |g·v| lies within BAND·thresh of JAX's threshold may
# be masked differently (f32 gradients against f64 ones, 1e-4 relative)
BAND = 1e-4


@pytest.mark.parametrize("args", [(0.2, 10, 5, True), (0.2, 4, 6, False),
                                  (0.35, 3, 2, False)])
def test_clip_schedule_is_bitwise_jax(args):
    got, want = cdr.cdr_clip_schedule(*args), jax_cdr.cdr_clip_schedule(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _tree(rng):
    return {"conv": rng.normal(size=(3, 3, 4, 6)).astype(np.float32),
            "dense": rng.normal(size=(6, 5)).astype(np.float32),
            "bias": rng.normal(size=(5,)).astype(np.float32)}


def _pairs(params, grads):
    """The port's (v, g) pairs: the conv as an OIHW channels_last tensor
    (`reshape(-1)` copies it, `view(-1)` would fail), the rest as they are."""
    def t(name, a):
        a = torch.from_numpy(a.copy())
        if name == "conv":
            a = a.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        return a
    return [(t(k, params[k]), t(k, grads[k])) for k in ("conv", "dense", "bias")]


def _back(name, a):
    return a.permute(2, 3, 1, 0).numpy() if name == "conv" else a.numpy()


@pytest.mark.parametrize("live", [False, True], ids=["dead", "live"])
def test_mask_and_threshold_are_bitwise_jax(live):
    rng = np.random.default_rng(11)
    noise, gradual, spe = 0.2, 4, 2
    nz = 1.0 - noise
    params = _tree(rng)
    tx = (jax_cdr.cdr_gradient_transform(
        nz, clip_schedule=jax_cdr.cdr_clip_schedule(noise, gradual, gradual,
                                                    dead_schedule=False),
        steps_per_epoch=spe) if live else jax_cdr.cdr_gradient_transform(nz, nz))
    state = tx.init(params)
    clips = set()
    for count in range(2 * spe):  # two epochs of updates
        grads = _tree(rng)
        updates, state = tx.update(grads, state, params)
        flat = np.concatenate([np.abs(grads[k] * params[k]).ravel()
                               for k in ("conv", "dense")])
        jthresh = np.asarray(jnp.sort(jnp.asarray(flat))[
            flat.size - max(int(nz * flat.size), 1)])
        pairs = _pairs(params, grads)
        clip = cdr.cdr_clip(noise, gradual, not live, count, spe)
        clips.add(clip)
        thresh = cdr.cdr_mask_(pairs, nz, clip)
        assert thresh.numpy().tobytes() == jthresh.tobytes()
        for name, (_, g) in zip(("conv", "dense", "bias"), pairs):
            want = np.asarray(updates[name])
            assert np.array_equal(_back(name, g), want), name
        assert np.array_equal(pairs[2][1].numpy(), grads["bias"])
        kept = sum(int((np.asarray(updates[k]) != 0).sum())
                   for k in ("conv", "dense"))
        assert kept == max(int(nz * flat.size), 1)
    assert len(clips) == (2 if live else 1)


# ------------------------------------------------------------ train steps --

IMAGE, BATCH = 64, 4


def test_two_cdr_steps_match_jax_outside_the_threshold_band(monkeypatch):
    jcfg, cfg = H.cfgs("cdr", IMAGE, BATCH, **OPTIM)
    assert cfg.optim.grad_transform == jcfg.optim.grad_transform == "cdr"
    params, stats = H.variables("fc", IMAGE)
    tx = jax_schedule.build_optimizer(jcfg.optim, 1)
    jmodel = H.jax_model("fc")
    jstep = jax_steps.make_train_step(jcfg, jmodel, tx)
    loss_fn = jax_steps._dense_loss_fn(jcfg, jmodel)
    grad_fn = jax.jit(jax.grad(lambda p, s, x, y, r: loss_fn(p, s, x, y, r)[0]))
    state = H.port_state("fc", cfg, params, stats)
    names = [n for n, _ in state.model.named_parameters()]
    seen = []

    def spy(pairs, ratio, clip):
        before = [g.clone() for _, g in pairs]
        thresh = cdr.cdr_mask_(pairs, ratio, clip)
        seen.append((before, thresh, ratio, clip))
        return thresh

    monkeypatch.setattr(steps, "cdr_mask_", spy)
    step = steps.make_train_step(cfg)
    with jax.enable_x64(True):
        jstate = H.jax_state(params, stats, tx)
    flipped = 0
    for s in range(2):
        images, labels = H.batch(IMAGE, BATCH, 60 + s)
        values = {k: v.detach().clone() for k, v in state.model.named_parameters()}
        with jax.enable_x64(True):
            x = jnp.asarray(images, jnp.float64)
            rng = jax.random.fold_in(jax.random.PRNGKey(jcfg.run.seed + 1), s)
            jgrads = H.FROM_JAX["fc"](
                jax.tree_util.tree_map(np.asarray, grad_fn(
                    jstate.params, jstate.batch_stats, x, jnp.asarray(labels),
                    rng)), jax.tree_util.tree_map(np.asarray,
                                                  jstate.batch_stats))
            jv = H.FROM_JAX["fc"](
                jax.tree_util.tree_map(np.asarray, jstate.params),
                jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
            jstate, jm = jstep(jstate, x, jnp.asarray(labels))
        m = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        for key in ("loss", "grad_norm", "top1", "top3", "step_ok"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=key, **H.TOL)
        before, thresh, ratio, clip = seen[-1]
        assert (ratio, clip) == (0.8, 0.8)
        sel = [n for n in names if values[n].dim() in (2, 4)]
        metric = {n: np.abs(jgrads[n].numpy() * jv[n].numpy())
                  for n in sel}
        flat = np.sort(np.concatenate([a.ravel() for a in metric.values()]))
        jthresh = flat[flat.size - max(int(0.8 * flat.size), 1)]
        np.testing.assert_allclose(float(thresh), jthresh, rtol=BAND)
        skip = {}
        for n, g in zip(names, before):
            if n not in metric:
                continue
            port_keep = (values[n] * g).abs() >= thresh
            jax_keep = torch.from_numpy(metric[n] >= jthresh)
            off = port_keep != jax_keep
            if off.any():
                band = np.abs(metric[n] - jthresh) <= BAND * jthresh
                assert band[off.numpy()].all(), (
                    f"step {s}: {n} masked differently outside the band")
                skip[n] = off
                flipped += int(off.sum())
        want = H.FROM_JAX["fc"](H.f32(jstate.params), H.f32(jstate.batch_stats))
        got = state.model.state_dict()
        for k, w in want.items():
            g, w = got[k].numpy(), w.numpy()
            if k in skip:
                keep = ~skip[k].numpy()
                g, w = g[keep], w[keep]
            np.testing.assert_allclose(g, w, err_msg=f"step {s} {k}", **H.TOL)
    assert flipped <= 2, flipped
    assert state.step == state.opt_count == 2


# -------------------------------------------------------------------- CLI --

def test_cli_trains_cdr(tmp_path):
    out = str(tmp_path / "run")
    try:
        train_cli.main([
            "cdr", "--dataset", "synthetic", "--synthetic_size", "16",
            "--model", "resnet18", "--image_size", "32", "--num_classes", "10",
            "--batchsize", "4", "--epochs", "1", "--dtype", "float32",
            "--num_workers", "1", "--device", "cpu", "--out", out])
    except SystemExit as e:
        raise AssertionError(f"rc {e.code}") from None
    sd = checkpoint.restore(os.path.join(out, "ckpt_e0.pt"))
    assert sd["step"] == sd["opt_count"] == 4
    assert "backbone.fc.weight" in sd["model"]  # a plain fc model
