"""Data parallelism of the port over torch.distributed, on the CPU: two gloo
ranks spawned as torchrun would start them (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and a MASTER_PORT from a free socket;
tests/torch_port_ddp_worker.py), held against the JAX package's `data`
mesh axis on two of conftest's eight virtual CPU devices. As in
tests/test_torch_port_resnet.py, the port runs in f32 and is held at atol
1e-5 / rtol 1e-4 (f32 sums in another order) against the JAX model run in
f64 (`jax.enable_x64`), at weights where f32 resolves the net's
gradients (that file's docstring; weight seed 0).

(a) BatchNorm with the world group, each rank on half of a batch, against
    flax's `nn.BatchNorm` on the whole batch: output, input gradient, the
    γ and β gradients summed over the ranks, and the running update (the
    biased variance: `nn.SyncBatchNorm`'s unbiased one would fail here,
    with 6 values a channel on a rank and 12 in all).
(b) Two train steps of the reduced ResNet-50 under DistributedDataParallel
    at batch 2 a rank, against JAX `make_train_step` on the mesh at global
    batch 4 and against the port in one process at batch 4: metrics, every
    parameter, momentum and running statistic; the two ranks' replicas
    bitwise equal.
(c) A NaN pixel on rank 1's half only: both ranks skip the step (the loss
    and the gradients are global), as the JAX mesh does.
(d) Eval over a val set of 7 samples at batch 2 on 2 ranks (each rank's
    shard padded by wrapping to 4, the padding masked): the JAX eval's
    `loss_sum`, `top1`, `top3` and `n` over the same set.
(e) The loader's shards and masks against the JAX `ShardedLoader`'s for
    several world sizes, batch sizes and set sizes; `--dp` off the world
    size and TResNet-M over two ranks are config errors (rc 2).
(f) `torchrun --nproc_per_node 2 -m ...cli.train --device cpu` resumes a
    1-rank checkpoint and writes one from rank 0 (no `module.` prefix),
    which a 1-rank trainer restores bitwise and trains on.
(g) The cdr and nested (freeze-BN) presets, two steps each over the two
    ranks: CDR's thresholds and masked gradients bitwise equal on both
    ranks, the nested k equal on both (and `nested_k`'s), the replicas
    bitwise equal after the steps; the nested all-K eval's per-K counts
    over the 7-sample val set, summed across the ranks, equal those of
    one process over the same samples, and so does its best K.
(h) PLC's ordered f(x) pass over the 7-sample set at batch 2 a rank (each
    rank's contiguous slice, padded by wrapping to 8, gathered with
    `all_gather_into_tensor`): every rank holds the logits of one process
    at batch 4 in dataset order, and after one LRT correction both ranks
    hold its labels, δ and count.
"""

import os
import socket
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.config import get_preset as jax_preset
from ddp_classification_pytorch_tpu.data.loader import ShardedLoader
from ddp_classification_pytorch_tpu.models import resnet as jax_resnet
from ddp_classification_pytorch_tpu.models.factory import ClassifierModel as JaxClassifier
from ddp_classification_pytorch_tpu.parallel import mesh as meshlib
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu.train import steps as jax_steps
from ddp_classification_pytorch_tpu.train.state import TrainState as JaxTrainState
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.data.loader import Loader
from ddp_classification_pytorch_tpu_torch.models import resnet
from ddp_classification_pytorch_tpu_torch.models.convert import resnet_from_jax
from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel
from ddp_classification_pytorch_tpu_torch.train import checkpoint, schedule, steps
from ddp_classification_pytorch_tpu_torch.ops.nested import nested_k
from ddp_classification_pytorch_tpu_torch.train.loop import Trainer, nested_eval
from ddp_classification_pytorch_tpu_torch.train.state import TrainState

import torch_port_heads as H
from torch_port_ddp_worker import ArrayDataset
from torch_port_helpers import OPTIM, random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_ddp_worker.py")
TOL = dict(atol=1e-5, rtol=1e-4)
WORLD, IMAGE, BATCH = 2, 64, 4  # BATCH: the global batch
REDUCED = dict(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10)
TIMEOUT_S = 180
PLC_DELTA = 0.6  # high enough that the random net's pass flips labels


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(**kw):
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in (os.environ.get("PYTHONPATH"),) if p])
    env.update(kw)
    return env


def _close(got, want, msg, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=msg,
                               **(tol or TOL))


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, IMAGE, IMAGE, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _batches():
    """Two good global batches, then one with a NaN pixel in rank 1's half."""
    good = [_batch(10), _batch(11)]
    images, labels = _batch(12)
    images = images.copy()
    images[3, 5, 6, 1] = np.nan
    return good + [(images, labels)]


def _bn_inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(0.4, 1.3, (4, 1, 3, 8)).astype(np.float32)  # NHWC
    return {"x": x, "g": rng.normal(size=x.shape).astype(np.float32),
            "weight": rng.uniform(0.5, 1.5, 8).astype(np.float32),
            "bias": rng.normal(0, 0.5, 8).astype(np.float32),
            "running_mean": rng.normal(0, 0.2, 8).astype(np.float32),
            "running_var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}


def _val_set():
    images, labels = _batch(20, n=7)
    return images, labels


@pytest.fixture(scope="module")
def variables():
    return random_variables(_jax_model(jnp.float32), IMAGE,
                            np.random.default_rng(0))


def _jax_model(dtype=jnp.float64):
    return JaxClassifier(backbone=jax_resnet.ResNet(
        block_cls=jax_resnet.Bottleneck, dtype=dtype, **REDUCED))


def _cfgs():
    cfgs = (jax_preset("baseline"), get_preset("baseline"))
    for cfg in cfgs:
        cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
        cfg.data.image_size, cfg.data.num_classes = IMAGE, 10
        for k, v in OPTIM.items():
            setattr(cfg.optim, k, v)
    return cfgs


@pytest.fixture(scope="module")
def spawned(variables, tmp_path_factory):
    """Start the two ranks (they run while the JAX references compile)."""
    tmp = tmp_path_factory.mktemp("ddp")
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    val_images, val_labels = _val_set()
    data = {
        "bn": {k: t(v) for k, v in _bn_inputs().items()},
        "steps": {"state_dict": resnet_from_jax(*variables),
                  "fc_state_dict": H.FROM_JAX["fc"](*variables),
                  "nested_state_dict": H.FROM_JAX["nested"](
                      *H.variables("nested", IMAGE)),
                  "reduced": REDUCED, "optim": dict(OPTIM),
                  "batches": [(t(i), t(lb)) for i, lb in _batches()],
                  "val_images": t(val_images), "val_labels": t(val_labels),
                  "val_batch": BATCH // WORLD, "plc_delta": PLC_DELTA,
                  "out": str(tmp)}}
    inp = str(tmp / "in.pt")
    torch.save(data, inp)
    env = _rank_env(WORLD_SIZE=str(WORLD))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, inp, str(tmp)], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    yield procs, tmp
    for p in procs:  # a test that failed before `ranks` collected them
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def ranks(spawned):
    procs, tmp = spawned
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


@pytest.fixture(scope="module")
def jax_run(variables):
    """The JAX step in f64 on a 2-device mesh (`data` = 2) over the three
    global batches: metrics and state after each; then its eval over the
    val set at global batch 4 (the ShardedLoader's padding masked)."""
    jcfg, _ = _cfgs()
    model = _jax_model()
    tx = jax_schedule.build_optimizer(jcfg.optim, 1)
    jstep = jax_steps.make_train_step(jcfg, model, tx)
    mesh = meshlib.make_mesh(meshlib.MeshSpec(data_parallel=WORLD),
                             devices=jax.devices()[:WORLD])
    out, totals = [], {}
    with jax.enable_x64(True):
        params, stats = (_f64(t) for t in variables)
        state = jax.device_put(
            JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=stats, opt_state=tx.init(params)),
            meshlib.replicated(mesh))
        for images, labels in _batches():
            batch = [jax.device_put(a, meshlib.batch_sharding(mesh))
                     for a in (images.astype(np.float64), labels)]
            state, m = jstep(state, *batch)
            assert len(batch[0].sharding.device_set) == WORLD
            out.append(({k: float(v) for k, v in m.items()},
                        resnet_from_jax(_f32(state.params),
                                        _f32(state.batch_stats))))
        ds = ArrayDataset(*_val_set())
        loader = ShardedLoader(ds, BATCH, shuffle=False, num_workers=0,
                               host_id=0, num_hosts=1)
        estep = jax_steps.make_eval_step(jcfg, model)
        for k, (images, labels) in enumerate(loader):
            r = estep(state, images.astype(np.float64), labels,
                      loader.valid_mask(k))
            for key, v in r.items():
                totals[key] = totals.get(key, 0.0) + float(v)
    return out, totals


def _one_process(variables):
    """The port in one process, no group, at the global batch."""
    _, cfg = _cfgs()
    model = ClassifierModel(resnet.ResNet(block_cls=resnet.Bottleneck,
                                          dtype=torch.float32, **REDUCED))
    model.backbone.load_state_dict(resnet_from_jax(*variables))
    model.to(memory_format=torch.channels_last)
    state = TrainState(model, schedule.build_optimizer(cfg.optim,
                                                       model.parameters()),
                       schedule.build_schedule(cfg.optim, 1))
    step = steps.make_train_step(cfg)
    out = []
    for images, labels in _batches():
        m = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.clone() for k, v in model.backbone.state_dict().items()}))
    return out


def _assert_replicas_equal(a, b):
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["momentum"], b["momentum"]):
        assert torch.equal(x, y)
    assert (a["step"], a["opt_count"]) == (b["step"], b["opt_count"])


def test_synced_batchnorm_matches_flax_on_the_global_batch(spawned, ranks):
    d = _bn_inputs()
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.float32)
    ra = {"mean": d["running_mean"], "var": d["running_var"]}

    def apply(x, s, b):
        return bn.apply({"params": {"scale": s, "bias": b}, "batch_stats": ra},
                        x, mutable=["batch_stats"])

    y, mutated = apply(d["x"], d["weight"], d["bias"])
    _, vjp = jax.vjp(lambda *a: apply(*a)[0], d["x"], d["weight"], d["bias"])
    dx, dw, db = vjp(jnp.asarray(d["g"]))
    got = [r["bn"] for r in ranks]
    _close(np.concatenate([g["y"] for g in got]), y, "y")
    _close(np.concatenate([g["dx"] for g in got]), dx, "dx")
    for g in got:
        _close(g["dweight"], dw, "dscale")
        _close(g["dbias"], db, "dbias")
        _close(g["running_mean"], mutated["batch_stats"]["mean"], "running_mean")
        _close(g["running_var"], mutated["batch_stats"]["var"], "running_var")
    # the unbiased update (nn.SyncBatchNorm's) lands elsewhere
    n = d["x"].shape[0] * d["x"].shape[1] * d["x"].shape[2]
    unbiased = 0.9 * d["running_var"] + 0.1 * d["x"].reshape(n, -1).var(0, ddof=1)
    assert not np.allclose(got[0]["running_var"].numpy(), unbiased, **TOL)


def test_two_ranks_match_the_jax_mesh_and_one_process(spawned, variables,
                                                      jax_run, ranks):
    jax_steps_out, _ = jax_run
    single = _one_process(variables)
    r0, r1 = (r["steps"] for r in ranks)
    for i in range(2):
        _assert_replicas_equal(r0["states"][i], r1["states"][i])
        assert r0["metrics"][i] == r1["metrics"][i]
        for name, (want_m, want_sd) in (("jax mesh", jax_steps_out[i]),
                                        ("one process", single[i])):
            for key in ("loss", "grad_norm", "top1", "top3", "step_ok"):
                _close(r0["metrics"][i][key], want_m[key],
                       f"step {i} {key} vs {name}")
            for k, w in want_sd.items():
                _close(r0["states"][i]["model"][k], w, f"step {i} {k} vs {name}")
        assert r0["metrics"][i]["step_ok"] == 1.0
    assert r0["states"][1]["step"] == r0["states"][1]["opt_count"] == 2


def test_nan_on_one_rank_skips_the_step_on_both(spawned, variables, jax_run,
                                               ranks):
    jax_steps_out, _ = jax_run
    r0, r1 = (r["steps"] for r in ranks)
    assert jax_steps_out[2][0]["step_ok"] == 0.0
    for r in (r0, r1):
        assert r["metrics"][2]["step_ok"] == 0.0
        assert not np.isfinite(r["metrics"][2]["loss"])
        after, before = r["states"][2], r["states"][1]
        _assert_replicas_equal(
            after, dict(before, step=before["step"] + 1))
        assert (after["step"], after["opt_count"]) == (3, 2)
    for k, w in jax_steps_out[2][1].items():
        _close(r0["states"][2]["model"][k], w, f"skipped step {k}")


def test_padded_eval_over_two_ranks_matches_jax(spawned, jax_run, ranks):
    _, want = jax_run
    assert want["n"] == 7.0
    for r in ranks:
        got = r["steps"]["eval"]
        assert r["steps"]["eval_batches"] == 2  # 7 → 8 = 2 ranks × 2 × 2
        assert (got["n"], got["top1"], got["top3"]) == (
            want["n"], want["top1"], want["top3"])
        _close(got["loss_sum"], want["loss_sum"], "loss_sum")


@pytest.mark.parametrize("n,world,batch", [(7, 2, 2), (10, 4, 1), (9, 2, 3),
                                           (16, 2, 4), (3, 4, 2)])
def test_loader_shards_like_the_jax_loader(n, world, batch):
    ds = ArrayDataset(np.arange(n, dtype=np.float32)[:, None],
                      np.arange(n, dtype=np.int32))
    for shuffle in (False, True):
        for r in range(world):
            port = Loader(ds, batch, shuffle=shuffle, seed=3, host_id=r,
                          num_hosts=world)
            ref = ShardedLoader(ds, batch, shuffle=shuffle, seed=3,
                                num_workers=0, host_id=r, num_hosts=world)
            for loader in (port, ref):
                loader.set_epoch(2)
            assert len(port) == len(ref)
            got = [lb for _, lb in port]
            want = [lb for _, lb in ref]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            if not shuffle:
                for k in range(len(port)):
                    np.testing.assert_array_equal(port.valid_mask(k),
                                                  ref.valid_mask(k))


def _rc(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        return e.code
    return 0


def _argv(out, epochs, *more):
    return ["baseline", "--dataset", "synthetic", "--synthetic_size", "16",
            "--model", "resnet18", "--image_size", "32", "--num_classes", "10",
            "--batchsize", "2", "--epochs", str(epochs), "--dtype", "float32",
            "--device", "cpu", "--num_workers", "1", "--out", out, *more]


def test_dp_off_the_world_size_and_tresnet_over_ranks_are_rc2(tmp_path,
                                                              monkeypatch):
    assert _rc(train_cli.main, _argv(str(tmp_path / "a"), 1, "--dp", "2")) == 2
    from ddp_classification_pytorch_tpu_torch.train.loop import check_world

    cfg = get_preset("baseline")
    cfg.model.arch = "tresnet_m"
    check_world(cfg, 1)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        check_world(cfg, 2)
    cfg.model.arch, cfg.parallel.data_parallel = "resnet50", 2
    check_world(cfg, 2)


def test_checkpoints_cross_world_sizes(tmp_path):
    """1 rank → 2 ranks (torchrun, gloo) → 1 rank."""
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert _rc(train_cli.main, _argv(one, 1)) == 0
    first = os.path.join(one, "ckpt_e0.pt")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         str(WORLD), "--master_addr", "127.0.0.1", "--master_port",
         str(_free_port()), "-m", "ddp_classification_pytorch_tpu_torch.cli.train",
         *_argv(two, 2, "--resume", first)],
        cwd=REPO, env=_rank_env(), capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"resumed from {first} at epoch 1" in proc.stdout
    assert "world=2 ddp=gloo global_batch=4" in proc.stdout
    assert proc.stdout.count("[trainer] workload=") == 1  # rank 0 prints
    second = os.path.join(two, "ckpt_e1.pt")
    saved = checkpoint.restore(second)
    assert not any(k.startswith("module.") for k in saved["model"])
    # 16 images: 8 steps at batch 2 on one rank, then 4 at 2 × 2
    assert (saved["step"], saved["opt_count"]) == (12, 12)
    assert not os.path.exists(os.path.join(two, "ckpt_e0.pt"))

    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
        _argv(str(tmp_path / "three"), 3, "--resume", second)))
    trainer = Trainer(cfg, torch.device("cpu"))
    assert trainer.start_epoch == 2 and trainer.state.ddp is None
    restored = trainer.state.state_dict()
    for k, v in saved["model"].items():
        assert torch.equal(restored["model"][k], v), k
    assert restored["optimizer"]["state"].keys() == saved["optimizer"]["state"].keys()
    for i, s in saved["optimizer"]["state"].items():
        assert torch.equal(restored["optimizer"]["state"][i]["momentum_buffer"],
                           s["momentum_buffer"])
    assert (restored["step"], restored["opt_count"]) == (12, 12)
    last = trainer.run()
    assert last["step_ok"] == 1.0 and trainer.state.step == 20


def test_cdr_and_nested_ranks_stay_equal(spawned, ranks):
    for head in ("cdr", "nested"):
        r0, r1 = (r[head] for r in ranks)
        for k in r0["model"]:
            assert torch.equal(r0["model"][k], r1["model"][k]), (head, k)
        assert r0["metrics"] == r1["metrics"]
        assert (r0["step"], r0["opt_count"]) == (r1["step"], r1["opt_count"]) == (2, 2)
        assert all(m["step_ok"] == 1.0 for m in r0["metrics"])
    c0, c1 = ranks[0]["cdr"]["masks"], ranks[1]["cdr"]["masks"]
    assert len(c0) == len(c1) == 2
    for (t0, g0), (t1, g1) in zip(c0, c1):
        assert torch.equal(t0, t1)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    _, cfg = H.cfgs("nested", IMAGE, BATCH)
    want = [nested_k(cfg.run.seed, s, H.FEAT, cfg.model.nested_std)
            for s in range(2)]
    assert ranks[0]["nested"]["ks"] == ranks[1]["nested"]["ks"] == want
    assert ranks[0]["cdr"]["ks"] == [] and ranks[0]["nested"]["masks"] == []


def test_nested_eval_counts_over_two_ranks_match_one_process(spawned, ranks):
    _, cfg = H.cfgs("nested", IMAGE, BATCH)
    params, stats = H.variables("nested", IMAGE)
    state = H.port_state("nested", cfg, params, stats)
    ds = ArrayDataset(*_val_set())
    loader = Loader(ds, BATCH, shuffle=False)
    batches = [(torch.from_numpy(im), torch.from_numpy(lb),
                torch.from_numpy(loader.valid_mask(k)))
               for k, (im, lb) in enumerate(loader)]
    estep = steps.make_nested_eval_step(cfg)
    outs = [estep(state, *b) for b in batches]
    for r in ranks:
        got = r["nested"]["counts"]
        assert float(got["n"]) == 7.0
        for key in ("top1_k", "top3_k"):
            assert torch.equal(got[key], sum(o[key] for o in outs)), key
        assert r["nested"]["eval"] == nested_eval(state, estep, batches)


def test_plc_pass_and_correction_over_two_ranks_match_one_process(
        spawned, ranks, variables, tmp_path, monkeypatch):
    from ddp_classification_pytorch_tpu_torch.train import loop
    from ddp_classification_pytorch_tpu_torch.train.plc_loop import PLCTrainer
    from torch_port_ddp_worker import plc_config

    cfg = plc_config({"plc_delta": PLC_DELTA}, BATCH)
    cfg.run.out_dir = str(tmp_path)
    model = ClassifierModel(resnet.ResNet(block_cls=resnet.Bottleneck,
                                          dtype=torch.float32, **REDUCED))
    model.backbone.load_state_dict(resnet_from_jax(*variables))
    model.to(memory_format=torch.channels_last)
    monkeypatch.setattr(loop, "create_train_state", lambda *a, **k: TrainState(
        model, schedule.build_optimizer(cfg.optim, model.parameters()),
        schedule.build_schedule(cfg.optim, 1)))
    ds = ArrayDataset(*_val_set())
    trainer = PLCTrainer(cfg, torch.device("cpu"), ds, ds)
    want = trainer.predict_train_logits()
    changed = trainer.correct_labels()
    assert want.shape == (7, 10) and changed > 0
    for r in ranks:
        got = r["plc"]
        np.testing.assert_allclose(got["logits"].numpy(), want, rtol=1e-6,
                                   atol=1e-6)
        assert np.array_equal(got["labels"].numpy(), ds.labels)
        assert (got["delta"], got["changed"]) == (trainer.delta, changed)
    assert torch.equal(ranks[0]["plc"]["logits"], ranks[1]["plc"]["logits"])
