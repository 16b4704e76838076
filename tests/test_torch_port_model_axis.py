"""The model axis in the torch port — expert parallelism, the partial-FC
ArcFace CE, the train steps at `--mp 2` and checkpoints across topologies
— against the JAX package on its 8-device CPU mesh, over four gloo ranks
(tests/torch_port_model_axis_worker.py, started once for the module).

Tolerances: the ops in f32 within 1e-5 (EP and the partial-FC CE, their
values and gradients); the train steps at the port's step parity
tolerance (atol 1e-5 / rtol 1e-4, JAX in f64, as
tests/torch_port_steps.py holds the one-rank steps), every metric and
every parameter after each of two steps:

- `vit`: the reduced ViT (depth 2, width 64, 2 heads, 64 px: 16 tokens)
  at data 1 × model 2, its tokens over the ring (the einsum body);
- `vit22`: the same at data 2 × model 2 (DDP and ZeRO-1 over the data
  group, its fc class-sharded);
- `moe`: the reduced MoE ViT (4 experts, top-2) at data 1 × model 2, its
  experts over the pair;
- `arcface`: tests/torch_port_heads.py's reduced ResNet-50 under
  `arcface --sharded_ce` at data 2 × model 2 (the partial-FC CE, its
  margin weight class-sharded, the BN statistics over the data group).

CDR's mask over the `vit` pair (its fc class-sharded) is bitwise the
mask over the whole tensors. The checkpoint the `vit` pair wrote (async,
after the gather) holds the one-rank format: it equals the pair's
gathered state, loads into a one-process state (what `cli/serve.py`
reads) and, read at data 2 × model 1 and at data 2 × model 2, gives
every rank the same tensors (its shards the slices of the whole).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.models import factory as jax_factory
from ddp_classification_pytorch_tpu.parallel import mesh as meshlib
from ddp_classification_pytorch_tpu_torch.models import factory, vit
from ddp_classification_pytorch_tpu_torch.ops.moe import moe_mlp_shards
from ddp_classification_pytorch_tpu_torch.ops.sharded_head import (
    arc_margin_ce_shards,
)
from ddp_classification_pytorch_tpu_torch.train import checkpoint, schedule
from ddp_classification_pytorch_tpu_torch.train.state import TrainState

import torch_port_heads as H
import torch_port_model_axis as MA
from torch_port_helpers import OPTIM
from torch_port_threads import one_torch_thread  # noqa: F401

jax_moe = importlib.import_module("ddp_classification_pytorch_tpu.ops.moe")
jax_sh = importlib.import_module(
    "ddp_classification_pytorch_tpu.ops.sharded_head")

ATOL = 1e-5
METRICS = ("loss", "grad_norm", "top1", "top3", "step_ok")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return MA.ranks(tmp_path_factory, "model")


# ------------------------------------------------------------------ EP --

def _jax_ep(name):
    x, gates, banks, gout = (jnp.asarray(a) if not isinstance(a, list)
                             else [jnp.asarray(b) for b in a]
                             for a in MA.ep_inputs())
    mesh = MA.jax_mesh(name)
    dp = MA.MESHES[name][0]

    def f(x, gates, *banks):
        return jax_moe.moe_mlp(x, gates, *banks, dtype=jnp.float32,
                               mesh=mesh, axis=meshlib.MODEL_AXIS,
                               batch_axis=meshlib.DATA_AXIS if dp > 1
                               else None)

    def out_and_grads(x, gates, banks, gout):
        out, vjp = jax.vjp(f, x, gates, *banks)
        return (out, *vjp(gout))

    with mesh:
        return [np.asarray(a) for a in
                jax.jit(out_and_grads)(x, gates, banks, gout)]


@pytest.mark.parametrize("name", ["m22", "m14"])
def test_expert_parallel_moe_matches_jax(run, name):
    """Each rank's output and x / gates gradients are JAX's whole ones;
    its bank gradients are its expert slice of JAX's."""
    ranks, _ = run
    want = _jax_ep(name)
    n = MA.MESHES[name][1]
    for r in range(4):
        out, gx, gg, gbanks = ranks[r]["ep"][name]
        for label, got, w in (("out", out, want[0]), ("dx", gx, want[1]),
                              ("dgates", gg, want[2])):
            np.testing.assert_allclose(got.numpy(), w, atol=ATOL,
                                       err_msg=f"{label} rank {r}")
        for j, g in enumerate(gbanks):
            w = np.split(want[3 + j], n)[r % n]
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL,
                                       err_msg=f"bank {j} rank {r}")


def test_expert_shards_in_one_process_match_jax():
    """`moe_mlp_shards` (the seam `chip_smoke.py` drives) over 2 and 4
    shards equals JAX's sharded moe_mlp."""
    x, gates, banks, _ = MA.ep_inputs()
    for name in ("m22", "m14"):
        n = MA.MESHES[name][1]
        got = moe_mlp_shards(
            torch.from_numpy(x), torch.from_numpy(gates),
            [tuple(torch.from_numpy(b).chunk(n)[i] for b in banks)
             for i in range(n)], dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), _jax_ep(name)[0], atol=ATOL)


# --------------------------------------------------------- partial-FC CE --

def _jax_ce(name, mode):
    feats, weight, labels, valid = MA.ce_inputs()
    mesh = MA.jax_mesh(name)
    dp = MA.MESHES[name][0]
    m = 0.5 if mode == "train" else 0.0
    v = None if mode == "train" else jnp.asarray(valid)

    def f(feats, weight):
        loss, t1, t3 = jax_sh.arc_margin_ce_sharded(
            feats, weight, jnp.asarray(labels), mesh, meshlib.MODEL_AXIS,
            batch_axis=meshlib.DATA_AXIS if dp > 1 else None, s=30.0, m=m,
            easy_margin=False, valid=v)
        return loss, (t1, t3)

    with mesh:
        (loss, (t1, t3)), (gf, gw) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(jnp.asarray(feats),
                                              jnp.asarray(weight))
    return [np.asarray(a) for a in (loss, t1, t3, gf, gw)]


@pytest.mark.parametrize("name", ["m22", "m14"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_partial_fc_ce_matches_jax(run, name, mode):
    """Loss and counts on every rank; the features' gradient of each data
    shard's rows (÷ dp: the batch axis's sum carries DDP's mean) and the
    weight's, averaged over the data group (DDP), slice by slice."""
    ranks, _ = run
    loss, t1, t3, gf, gw = _jax_ce(name, mode)
    dp, mp = MA.MESHES[name]
    b = gf.shape[0] // dp
    for r in range(4):
        got = ranks[r]["ce"][(name, mode)]
        np.testing.assert_allclose(float(got[0]), loss, atol=ATOL)
        assert (float(got[1]), float(got[2])) == (float(t1), float(t3))
        d, m = divmod(r, mp)
        np.testing.assert_allclose(got[3].numpy() / dp,
                                   gf[d * b:(d + 1) * b], atol=ATOL)
        shard = sum(ranks[q]["ce"][(name, mode)][4] for q in range(4)
                    if q % mp == m) / dp
        np.testing.assert_allclose(shard.numpy(), np.split(gw, mp)[m],
                                   atol=ATOL)


def test_partial_fc_ce_shards_in_one_process_match_jax():
    """`arc_margin_ce_shards` (the seam `chip_smoke.py` drives) over 4
    shards: JAX's values and gradients."""
    feats, weight, labels, _ = MA.ce_inputs()
    loss, t1, t3, gf, gw = _jax_ce("m14", "train")
    f = torch.from_numpy(feats).requires_grad_()
    w = torch.from_numpy(weight).requires_grad_()
    got = arc_margin_ce_shards(f, list(w.chunk(4)), torch.from_numpy(labels),
                               s=30.0, m=0.5, easy_margin=False)
    got[0].backward()
    np.testing.assert_allclose(got[0].item(), loss, atol=ATOL)
    assert (float(got[1]), float(got[2])) == (float(t1), float(t3))
    np.testing.assert_allclose(f.grad.numpy(), gf, atol=ATOL)
    np.testing.assert_allclose(w.grad.numpy(), gw, atol=ATOL)


# ---------------------------------------------------------- train steps --

def _assert_steps(got, want, convert):
    for (gm, gstate), (wm, wparams, wstats) in zip(got, want):
        for key in METRICS:
            np.testing.assert_allclose(gm[key], wm[key], err_msg=key,
                                       **H.TOL)
        expect = convert(wparams, wstats)
        assert sorted(gstate) == sorted(expect)
        for k, w in expect.items():
            np.testing.assert_allclose(gstate[k].numpy(), np.asarray(w),
                                       err_msg=k, **H.TOL)


def _vit_cfg(name, moe=False):
    cfg = MA.vit_cfg(moe)
    cfg.parallel.model_axis = MA.MESHES[name][1]
    return cfg


def _jax_vit_run(name, moe=False):
    cfg = _vit_cfg(name, moe)
    mesh = MA.jax_mesh(name)
    with MA.patched_vit(), jax.enable_x64(True):
        jmodel = jax_factory.build_model(cfg.model, MA.CLASSES, mesh=mesh)
    return MA.jax_steps_run(cfg, jmodel, mesh, MA.vit_params(moe), {},
                            MA.batches(300))


@pytest.mark.parametrize("case,name,moe", [
    ("vit", "m12", False), ("vit22", "m22", False), ("moe", "m12", True)])
def test_vit_steps_on_the_model_axis_match_jax(run, case, name, moe):
    ranks, _ = run
    got = ranks[0 if case != "moe" else 2][case]
    _assert_steps(got, _jax_vit_run(name, moe),
                  lambda p, s: MA.vit_port(p))


def test_arcface_sharded_ce_steps_match_jax(run):
    ranks, _ = run
    jcfg, _ = H.cfgs("arcface", MA.IMAGE, MA.BATCH, **OPTIM)
    jcfg.model.arc_easy_margin = True
    jcfg.parallel.model_axis, jcfg.parallel.arcface_sharded_ce = 2, True
    params, stats = H.variables("arcface", MA.IMAGE)
    want = MA.jax_steps_run(jcfg, H.jax_model("arcface"), MA.jax_mesh("m22"),
                            params, stats, MA.batches(400))
    _assert_steps(ranks[0]["arcface"], want, H.FROM_JAX["arcface"])


def test_cdr_mask_covers_the_whole_class_sharded_gradient(run):
    """CDR's threshold is a rank statistic over every gradient entry (JAX
    takes it on global arrays): over the `vit` pair, its fc class-sharded,
    the masked gradients are bitwise `cdr_mask_` on the whole tensors."""
    from ddp_classification_pytorch_tpu_torch.ops.cdr import cdr_mask_

    ranks, _ = run
    params = ranks[0]["vit"][-1][1]
    gen = torch.Generator().manual_seed(77)
    pairs = [(params[n], torch.randn(params[n].shape, generator=gen))
             for n in ranks[0]["cdr"]]
    cdr_mask_(pairs, 0.8, 0.8)
    for r in (0, 1):
        for (name, got), (_, want) in zip(ranks[r]["cdr"].items(), pairs):
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)
    assert sum(int((g != 0).sum()) for _, g in pairs if g.dim() in (2, 4)) > 0


# ---------------------------------------------------------- checkpoints --

def test_checkpoint_crosses_topologies(run):
    """The dp 1 × mp 2 file: the pair's gathered state, in the one-rank
    format (a one-process state loads it), and at dp 2 × mp 1 / dp 2 ×
    mp 2 every rank holds its whole tensors / the slices of them."""
    ranks, tmp = run
    path = str(tmp / "ckpt" / "ckpt_e0.pt")
    assert checkpoint.verify(path) is None
    whole = torch.load(path, weights_only=True)
    gathered = ranks[0]["vit"][-1][1]
    assert sorted(whole["model"]) == sorted(gathered)
    for k, v in gathered.items():
        torch.testing.assert_close(whole["model"][k], v, rtol=0, atol=0)
    assert whole["model"]["backbone.fc.weight"].shape == (MA.CLASSES, 64)

    # one process, no mesh: the file loads as it is (cli/serve.py's view)
    kept = vit.VIT_CONFIGS["vit_t16"]
    vit.VIT_CONFIGS["vit_t16"] = MA.REDUCED_VIT
    try:
        cfg = _port_vit_cfg()
        model = factory.build_model(cfg.model, MA.CLASSES, MA.IMAGE)
    finally:
        vit.VIT_CONFIGS["vit_t16"] = kept
    o = cfg.optim
    state = TrainState(model, schedule.build_optimizer(
        o, schedule.param_groups(o, model, False)),
        schedule.build_schedule(o, 1))
    state.load_state_dict(whole)
    assert state.step == 2 and state.opt_count == 2
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, whole["model"][k], rtol=0, atol=0)

    for r in range(4):
        sd, osd = ranks[r]["resume_dp2"]
        for k, v in sd.items():
            torch.testing.assert_close(v, whole["model"][k], rtol=0, atol=0)
        if osd is not None:  # ZeRO-1 consolidated on the data group's 0
            for i, st in osd["state"].items():
                for key, t in st.items():
                    torch.testing.assert_close(
                        t, whole["optimizer"]["state"][i][key], rtol=0,
                        atol=0)
        sd, _ = ranks[r]["resume_dp2mp2"]
        m = r % 2
        for k, v in sd.items():
            w = whole["model"][k]
            if k == "backbone.fc.weight":
                w = w.chunk(2)[m]
            torch.testing.assert_close(v, w, rtol=0, atol=0)


def _port_vit_cfg():
    from ddp_classification_pytorch_tpu_torch.config import get_preset

    cfg = get_preset("baseline")
    cfg.model.arch, cfg.model.dtype = "vit_t16", "float32"
    for k, v in OPTIM.items():
        setattr(cfg.optim, k, v)
    return cfg
