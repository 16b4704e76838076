"""The port's Nested-Dropout workload against the JAX package's, on the CPU.

(a) Ops on the same numpy inputs: `gaussian_dist` and `prefix_mask`
    bitwise; `nested_all_k_counts` (the blocked sweep) against JAX's on
    random features, on features whose first dims are dead (every logit
    ties at small K: the ties count against the sample), and with `valid`
    padding; its logits against the `nested_all_k_logits` oracle; `best_k`'s
    1e-5·K tie-break. The sweep sums in another order than XLA's cumsum,
    so the counts are exact except at a K where the JAX true logit's
    margin to a competitor is within the logits' tolerance: such K are
    named in the assertion, and none occurs in these inputs.
(b) The reduced ResNet-50 (stages (1, 1, 1, 1), 8 filters: 256 features)
    under the nested head, from JAX weights (`nested_from_jax`): masked and
    unmasked logits in eval and training mode, and the running statistics a
    training forward leaves (live BN) or keeps (freeze-BN).
(c) Freeze-BN's set: on the full ResNet-50's flax tree, the JAX matcher
    `_is_bn_param` picks 98 of 106 BN tensors (it misses the four
    downsample BNs), and the port's `frozen_bn_names`, through
    `flax_path`, names the same 98.
(d) Two train steps of the nested preset (freeze-BN, SGD with momentum,
    weight decay, warmup: torch_port_helpers.OPTIM) against JAX
    `make_train_step` with JAX's k passed in: loss, grad norm (the frozen
    params' gradients included), every parameter and running statistic;
    the running statistics and the 26 frozen tensors bitwise unchanged, the
    8 downsample γ/β moved as JAX's; the step without a k draws
    `nested_k`'s. Then three steps with a NaN pixel in the second batch:
    that step alone is skipped, and every step's grad norm is JAX's.
(e) The all-K eval over 7 samples at batch 4 (the wrap padding masked):
    JAX's `best_k`, `val_top1` and `val_top3`.
(f) `cli/train.py nested --device cpu` at 32 px, then `cli/serve.py
    nested --ckpt` with the trainer's top-5.

The port runs in f32 against JAX in f64 (`jax.enable_x64`) at atol 1e-5 /
rtol 1e-4, as tests/test_torch_port_resnet.py does.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddp_classification_pytorch_tpu.data.loader import ShardedLoader
from ddp_classification_pytorch_tpu.models import resnet as jax_resnet
from ddp_classification_pytorch_tpu.models.factory import NestedModel as JaxNested
from ddp_classification_pytorch_tpu.models.heads import NetClassifier as JaxNetClassifier
from ddp_classification_pytorch_tpu.ops import nested as jax_nested
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu.train import steps as jax_steps
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.data.loader import Loader
from ddp_classification_pytorch_tpu_torch.models import resnet
from ddp_classification_pytorch_tpu_torch.models.convert import flax_path
from ddp_classification_pytorch_tpu_torch.models.factory import NestedModel
from ddp_classification_pytorch_tpu_torch.models.heads import NetClassifier
from ddp_classification_pytorch_tpu_torch.ops import nested
from ddp_classification_pytorch_tpu_torch.train import checkpoint, steps
from ddp_classification_pytorch_tpu_torch.train.loop import nested_eval
from ddp_classification_pytorch_tpu_torch.train.schedule import frozen_bn_names

import torch_port_heads as H
from torch_port_ddp_worker import ArrayDataset
from torch_port_helpers import OPTIM
from torch_port_threads import one_torch_thread  # noqa: F401

IMAGE, BATCH = 32, 4


# -------------------------------------------------------------------- ops --

@pytest.mark.parametrize("std,n", [(100.0, 2048), (10.0, 64), (3.0, 256)])
def test_gaussian_dist_and_prefix_mask_are_bitwise_jax(std, n):
    got = nested.gaussian_dist(0.0, std, n)
    want = jax_nested.gaussian_dist(0.0, std, n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    ks = np.array([0, 5, n - 1], np.int32)
    np.testing.assert_array_equal(
        nested.prefix_mask(torch.from_numpy(ks), n).numpy(),
        np.asarray(jax_nested.prefix_mask(jnp.asarray(ks), n)))
    assert torch.equal(nested.prefix_mask(3, n), torch.from_numpy(
        np.array(jax_nested.prefix_mask(jnp.asarray(3), n))))


def _margin_ks(f, w, labels, valid, tol=1e-5):
    """The K at which some valid row's true logit lies within `tol` of a
    competitor's in the oracle's logits (where summation order may flip
    a count). Logits that are exactly 0 (all their terms so far 0: dead
    dims) tie exactly in any order and do not count."""
    logits = np.asarray(jax_nested.nested_all_k_logits(f, w))  # (D, B, C)
    true = np.take_along_axis(logits, labels[None, :, None], 2)
    near = ((np.abs(logits - true) <= tol * np.maximum(1, np.abs(true)))
            & ((logits != 0) | (true != 0)))
    near[:, np.arange(len(labels)), labels] = False
    return sorted(set(np.nonzero(near.any(2)[:, valid > 0])[0].tolist()))


@pytest.mark.parametrize("case", ["random", "dead_prefix", "padded"])
def test_all_k_counts_match_jax(case):
    rng = np.random.default_rng({"random": 5, "dead_prefix": 6, "padded": 7}[case])
    b, d, c, block = 12, 256, 7, 128
    f = rng.normal(size=(b, d)).astype(np.float32)
    if case == "dead_prefix":
        f[:, :136] = 0.0  # dead ReLU units: every logit ties up to K = 135
    w = rng.normal(size=(c, d)).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    valid = np.ones(b, np.float32)
    if case == "padded":
        valid[-5:] = 0.0
    jt1, jt3 = (np.asarray(t) for t in jax_nested.nested_all_k_counts(
        jnp.asarray(f), jnp.asarray(w), jnp.asarray(labels), block=block,
        mask=jnp.asarray(valid)))
    t1, t3 = nested.nested_all_k_counts(
        torch.from_numpy(f), torch.from_numpy(w), torch.from_numpy(labels),
        block=block, mask=torch.from_numpy(valid))
    assert t1.shape == t3.shape == (d,)
    near = _margin_ks(f, w, labels, valid)
    off = sorted(set(np.nonzero(t1.numpy() != jt1)[0].tolist())
                 | set(np.nonzero(t3.numpy() != jt3)[0].tolist()))
    assert set(off) <= set(near), (off, near)
    assert not near, f"K within the tolerance of a tie: {near}"
    if case == "dead_prefix":
        assert t1[:136].sum() == 0 and t3[:136].sum() == 0
        assert t3[136:].sum() > 0
    if case == "padded":
        assert t3.max() <= valid.sum()
    np.testing.assert_allclose(
        nested.nested_all_k_logits(torch.from_numpy(f), torch.from_numpy(w)),
        np.asarray(jax_nested.nested_all_k_logits(f, w)), **H.TOL)


def test_best_k_prefers_the_smallest_k_among_ties():
    for counts, n in (([5.0, 5.0, 5.0, 4.0], 10.0), ([1.0, 3.0, 2.0, 3.0], 7.0),
                      ([0.0, 0.0, 0.0], 1.0)):
        jacc, jk = jax_nested.best_k(jnp.asarray(counts, jnp.float32),
                                     np.float32(n))
        acc, k = nested.best_k(torch.tensor(counts), n)
        assert k == int(jk) and acc == float(jacc)


def test_nested_k_follows_the_gaussian_and_the_key():
    ks = [nested.nested_k(999, s, 2048, 100.0) for s in range(400)]
    assert ks == [nested.nested_k(999, s, 2048, 100.0) for s in range(400)]
    assert 0 <= min(ks) and max(ks) < 400 and len(set(ks)) > 100
    assert ks != [nested.nested_k(1, s, 2048, 100.0) for s in range(400)]


# ----------------------------------------------------------------- models --

@pytest.mark.parametrize("freeze", [False, True], ids=["live_bn", "freeze_bn"])
def test_nested_model_matches_jax(freeze):
    params, stats = H.variables("nested", IMAGE)
    x = np.random.default_rng(3).normal(size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    mask = np.array(jax_nested.prefix_mask(jnp.asarray(40), H.FEAT), np.float32)
    with jax.enable_x64(True):
        jm = H.jax_model("nested", freeze_bn=freeze)
        v = H.f64({"params": params, "batch_stats": stats})
        xs = jnp.asarray(x, jnp.float64)
        out = H.f32(jax.jit(lambda v, x, m: (
            jm.apply(v, x, None, train=False), jm.apply(v, x, m, train=False),
            jm.apply(v, x, m, train=True, mutable=["batch_stats"])))(
                v, xs, jnp.asarray(mask, jnp.float64)))
    j_eval, j_masked, (j_train, mutated) = out
    pm = H.port_model("nested", freeze_bn=freeze)
    pm.load_state_dict(H.FROM_JAX["nested"](params, stats))
    pm.to(memory_format=torch.channels_last)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)

    def close(got, want, msg):
        np.testing.assert_allclose(got.numpy(), want, err_msg=msg, **H.TOL)

    with torch.no_grad():
        close(pm.eval()(t), j_eval, "unmasked eval logits")
        close(pm(t, torch.from_numpy(mask)), j_masked, "masked eval logits")
        close(pm.train()(t, torch.from_numpy(mask)), j_train,
              "masked train logits")
    want = H.FROM_JAX["nested"](params, mutated["batch_stats"])
    loaded = H.FROM_JAX["nested"](params, stats)
    got = pm.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 34
    for k in keys:
        close(got[k], want[k].numpy(), k)
    # freeze-BN keeps every statistic bitwise; live BN moves every one
    assert sum(torch.equal(got[k], loaded[k]) for k in keys) == (
        len(keys) if freeze else 0)


def test_freeze_bn_set_is_the_jax_matchers_98_of_106():
    jm = JaxNested(backbone=jax_resnet.resnet50(num_classes=0, freeze_bn=True),
                   classifier=JaxNetClassifier(2173))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), None, train=False))
    paths = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(
                 shapes["params"])[0]}
    frozen_jax = {p for p in paths if jax_schedule._is_bn_param(
        tuple(p.split("/")), None)}
    bn_tensors = {p for p in paths if p.endswith(("/scale", "/bias"))
                  and ("BatchNorm" in p or "bn" in p)}
    assert len(bn_tensors) == 106 and len(frozen_jax) == 98
    assert bn_tensors - frozen_jax == {
        f"backbone/layer{i}_block0/downsample_bn/{leaf}"
        for i in range(1, 5) for leaf in ("scale", "bias")}
    pm = NestedModel(resnet.build_resnet("resnet50", 0, freeze_bn=True),
                     NetClassifier(2048, 2173))
    assert {flax_path(n) for n, _ in pm.named_parameters()} == set(paths)
    frozen = frozen_bn_names(pm)
    assert len(frozen) == 98 and {flax_path(n) for n in frozen} == frozen_jax


# ------------------------------------------------------------ train steps --

def _jax_k(jcfg, step):
    """The k JAX's nested step draws at `step` (`_dense_loss_fn`)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(jcfg.run.seed + 1), step)
    mask_rng, _ = jax.random.split(rng)
    dist = jnp.asarray(jax_nested.gaussian_dist(0.0, jcfg.model.nested_std, H.FEAT))
    return int(jax_nested.sample_mask_dims(mask_rng, dist))


def test_two_nested_freeze_bn_steps_match_jax():
    jcfg, cfg = H.cfgs("nested", IMAGE, BATCH, **OPTIM)
    jcfg.model.nested_std = cfg.model.nested_std = 40.0  # k spread over 256
    assert cfg.model.freeze_bn and jcfg.model.freeze_bn
    params, stats = H.variables("nested", IMAGE)
    tx = jax_schedule.build_optimizer(jcfg.optim, 1, freeze_bn=True)
    jstep = jax_steps.make_train_step(jcfg, H.jax_model("nested", freeze_bn=True), tx)
    state = H.port_state("nested", cfg, params, stats)
    step = steps.make_train_step(cfg)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    frozen = frozen_bn_names(state.model)
    down = [n for n, _ in state.model.named_parameters() if "downsample.1" in n]
    assert len(frozen) == 26 and len(down) == 8  # 17 BNs, 4 of them shortcuts
    with jax.enable_x64(True):
        jstate = H.jax_state(params, stats, tx)
        ks = [_jax_k(jcfg, s) for s in range(2)]
    assert ks[0] != ks[1]
    for s, k in enumerate(ks):
        images, labels = H.batch(IMAGE, BATCH, 20 + s)
        with jax.enable_x64(True):
            jstate, jm = jstep(jstate, jnp.asarray(images, jnp.float64),
                               jnp.asarray(labels))
        m = step(state, torch.from_numpy(images), torch.from_numpy(labels), k=k)
        for key in ("loss", "grad_norm", "top1", "top3", "step_ok"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=key, **H.TOL)
        H.assert_state_matches("nested", jstate, state.model)
    after = state.model.state_dict()
    for k, v in before.items():
        if k.endswith(("running_mean", "running_var")) or any(
                k == f for f in frozen):
            assert torch.equal(after[k], v), k
    for k in down:
        assert not torch.equal(after[k], before[k]), k
    assert state.step == state.opt_count == 2
    # without a k the step draws nested_k's, the same on every rank
    again = H.port_state("nested", cfg, params, stats)
    images, labels = H.batch(IMAGE, BATCH, 20)
    k0 = nested.nested_k(cfg.run.seed, 0, H.FEAT, cfg.model.nested_std)
    m0 = step(again, torch.from_numpy(images), torch.from_numpy(labels))
    ref = H.port_state("nested", cfg, params, stats)
    m1 = step(ref, torch.from_numpy(images), torch.from_numpy(labels), k=k0)
    assert float(m0["loss"]) == float(m1["loss"])


def test_nested_freeze_bn_steps_recover_after_a_non_finite_batch():
    """Three steps of the nested preset, the second on a batch with a NaN
    pixel: JAX skips that step alone, and so does the port. Each step's
    grad norm is JAX's: the frozen params are in no optimizer group, yet
    their gradients are that step's own, not summed over the steps (nor
    left non-finite by the skipped one)."""
    jcfg, cfg = H.cfgs("nested", IMAGE, BATCH, **OPTIM)
    jcfg.model.nested_std = cfg.model.nested_std = 40.0
    params, stats = H.variables("nested", IMAGE)
    tx = jax_schedule.build_optimizer(jcfg.optim, 1, freeze_bn=True)
    jstep = jax_steps.make_train_step(jcfg, H.jax_model("nested", freeze_bn=True), tx)
    state = H.port_state("nested", cfg, params, stats)
    step = steps.make_train_step(cfg)
    with jax.enable_x64(True):
        jstate = H.jax_state(params, stats, tx)
        ks = [_jax_k(jcfg, s) for s in range(3)]
    oks = []
    for s, k in enumerate(ks):
        images, labels = H.batch(IMAGE, BATCH, 40 + s)
        if s == 1:
            images[0, 0, 0, 0] = np.nan
        with jax.enable_x64(True):
            jstate, jm = jstep(jstate, jnp.asarray(images, jnp.float64),
                               jnp.asarray(labels))
        probe = copy.deepcopy(state.model)
        m = step(state, torch.from_numpy(images), torch.from_numpy(labels), k=k)
        for key in ("loss", "grad_norm", "step_ok"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=f"step {s}: {key}", **H.TOL)
        H.assert_state_matches("nested", jstate, state.model)
        oks.append(float(m["step_ok"]))
    assert oks == [1.0, 0.0, 1.0]
    assert state.step == 3 and state.opt_count == 2
    # the last step's gradients, frozen params' included, are one backward's
    probe.train()
    F.cross_entropy(probe(torch.from_numpy(images).permute(0, 3, 1, 2),
                          nested.prefix_mask(ks[-1], H.FEAT)),
                    torch.from_numpy(labels).long()).backward()
    for (name, p), q in zip(state.model.named_parameters(), probe.parameters()):
        assert torch.equal(p.grad, q.grad), name


# ------------------------------------------------------------------- eval --

def test_all_k_eval_over_padded_batches_matches_jax():
    jcfg, cfg = H.cfgs("nested", IMAGE, BATCH)
    params, stats = H.variables("nested", IMAGE)
    images, labels = H.batch(IMAGE, 7, 30)
    ds = ArrayDataset(images, labels)
    jloader = ShardedLoader(ds, BATCH, shuffle=False, num_workers=0,
                            host_id=0, num_hosts=1)
    with jax.enable_x64(True):
        jstate = H.jax_state(params, stats, jax_schedule.build_optimizer(
            jcfg.optim, 1, freeze_bn=True))
        estep = jax_steps.make_nested_eval_step(jcfg, H.jax_model(
            "nested", freeze_bn=True))
        t1 = t3 = n = 0
        for b, (im, lb) in enumerate(jloader):
            out = estep(jstate, jnp.asarray(im, jnp.float64), jnp.asarray(lb),
                        jnp.asarray(jloader.valid_mask(b)))
            t1, t3, n = t1 + out["top1_k"], t3 + out["top3_k"], n + out["n"]
        jacc, jk = jax_nested.best_k(t1, np.float32(float(n)))
        jtop3 = float(t3[int(jk)] / max(float(n), 1.0))
    loader = Loader(ds, BATCH, shuffle=False)
    batches = [(torch.from_numpy(im), torch.from_numpy(lb),
                torch.from_numpy(loader.valid_mask(b)))
               for b, (im, lb) in enumerate(loader)]
    assert len(batches) == 2 and float(n) == 7.0
    got = nested_eval(H.port_state("nested", cfg, params, stats),
                      steps.make_nested_eval_step(cfg), batches)
    assert got["best_k"] == int(jk)
    np.testing.assert_allclose(got["val_top1"], float(jacc), atol=1e-7)
    np.testing.assert_allclose(got["val_top3"], jtop3, atol=1e-7)


# -------------------------------------------------------------------- CLI --

def _rc(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        return e.code
    return 0


def test_cli_trains_nested_and_serves_its_checkpoint(tmp_path, capsys):
    out = str(tmp_path / "run")
    assert _rc(train_cli.main, [
        "nested", "--dataset", "synthetic", "--synthetic_size", "16",
        "--model", "resnet18", "--image_size", "32", "--num_classes", "10",
        "--batchsize", "4", "--epochs", "1", "--dtype", "float32",
        "--num_workers", "1", "--device", "cpu", "--out", out]) == 0
    printed = capsys.readouterr().out
    assert "[initial eval]" in printed and "best_k=" in printed
    ckpt = os.path.join(out, "ckpt_best.pt")  # the preset keeps the best only
    assert not os.path.exists(os.path.join(out, "ckpt_e0.pt"))
    with open(os.path.join(out, "history.json")) as f:
        assert '"best_k"' in f.read()
    sd = checkpoint.restore(ckpt)
    assert sd["step"] == sd["opt_count"] == 4
    assert "classifier.fc.weight" in sd["model"]
    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args([
        "nested", "--model", "resnet18", "--image_size", "32",
        "--num_classes", "10", "--dtype", "float32", "--device", "cpu",
        "--ckpt", ckpt]))
    engine = serve_cli.build_engine(cfg, torch.device("cpu"))
    preds = serve_cli.run_selfcheck(engine, cfg, 4)
    model = NestedModel(resnet.build_resnet("resnet18", 0, dtype=torch.float32),
                        NetClassifier(512, 10))
    model.load_state_dict(checkpoint.model_state(sd))
    imgs = np.random.default_rng(cfg.run.seed).integers(
        0, 256, (4, 32, 32, 3)).astype(np.uint8)
    _, idx = steps.make_topk_predict_step(cfg, 5)(
        model.to(memory_format=torch.channels_last).eval(),
        torch.from_numpy(imgs))
    assert [p.indices.tolist() for p in preds] == idx.tolist()
