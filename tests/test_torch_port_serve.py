"""The torch port's serving slice on the CPU: the JAX package's top-k
predict against the port's on one uint8 batch, then the port's engine,
checkpoint and CLI on their own.

Slice parity: the reduced TResNet (stages (1,1,1,1), width 0.5, f32, 10
classes) with the same weights on both sides (flax init, randomized BN,
carried across by `models/convert.py`), eval mode, head `fc`, k = 5.
Probabilities agree at 1e-5 and the top-5 indices are equal.
"""

import collections
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.config import get_preset as jax_get_preset
from ddp_classification_pytorch_tpu.models.factory import (
    ClassifierModel as JaxClassifierModel,
)
from ddp_classification_pytorch_tpu.models.tresnet import TResNet as JaxTResNet
from ddp_classification_pytorch_tpu.train.steps import (
    make_topk_predict_step as jax_make_topk_predict_step,
)
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.models.convert import tresnet_from_jax
from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel
from ddp_classification_pytorch_tpu_torch.models.tresnet import TResNet
from ddp_classification_pytorch_tpu_torch.serve.engine import (
    EngineClosed,
    QueueFull,
    ServingEngine,
)
from ddp_classification_pytorch_tpu_torch.train import checkpoint
from ddp_classification_pytorch_tpu_torch.train.state import init_weights_
from ddp_classification_pytorch_tpu_torch.train.steps import (
    make_topk_predict_step,
)

from torch_port_helpers import REDUCED, init_variables, randomize_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
JaxState = collections.namedtuple("JaxState", "params batch_stats")


def _port_model(seed: int = 0, num_classes: int = 10) -> ClassifierModel:
    kw = dict(REDUCED, num_classes=num_classes)
    model = ClassifierModel(TResNet(dtype=torch.float32, **kw))
    return init_weights_(model, torch.Generator().manual_seed(seed)).eval()


def _predict():
    return make_topk_predict_step(get_preset("baseline"), k=5)


def test_topk_predict_matches_jax():
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (3, 64, 64, 3)).astype(np.uint8)

    jax_model = JaxClassifierModel(JaxTResNet(dtype=jnp.float32, **REDUCED))
    variables = init_variables(jax_model, 64)
    params, stats = randomize_bn(variables["params"],
                                 variables["batch_stats"], rng)
    jcfg = jax_get_preset("baseline")
    jax_step = jax_make_topk_predict_step(jcfg, jax_model, 5)
    want_p, want_i = jax_step(JaxState(params, stats), jnp.asarray(images))

    port = ClassifierModel(TResNet(dtype=torch.float32, **REDUCED))
    port.backbone.load_state_dict(tresnet_from_jax(params, stats))
    got_p, got_i = _predict()(port.eval(), torch.from_numpy(images))

    assert got_p.dtype == torch.float32 and got_i.dtype == torch.int32
    assert got_p.shape == got_i.shape == (3, 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=1e-5, atol=1e-5)


def _engine(model=None, **kw) -> ServingEngine:
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("max_batch", 4)
    kw.setdefault("batch_timeout_ms", 0.0)
    return ServingEngine(model if model is not None else _port_model(),
                         _predict(), image_size=32, device=CPU, **kw)


def _images(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)


def test_bucket_padding_leaves_real_rows_unchanged():
    engine = _engine(buckets=(4,))
    imgs = _images(3)
    futures = [engine.submit(im) for im in imgs]
    assert engine.process_once() == 3
    assert engine.seen_buckets == {4}
    assert engine.metrics.rows_padded == 1
    model = engine._state
    for i, f in enumerate(futures):
        pred = f.result(timeout=0)
        alone_p, alone_i = _predict()(model, torch.from_numpy(imgs[i:i + 1]))
        np.testing.assert_array_equal(pred.indices, alone_i[0].numpy())
        np.testing.assert_allclose(pred.scores, alone_p[0].numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_queue_full_past_queue_depth():
    engine = _engine(queue_depth=2)
    for im in _images(2):
        engine.submit(im)
    with pytest.raises(QueueFull):
        engine.submit(_images(1)[0])
    assert engine.metrics.rejected == 1
    engine.close()


def test_submit_rejects_wrong_wire_shape_or_dtype():
    engine = _engine()
    with pytest.raises(ValueError, match="request must be"):
        engine.submit(np.zeros((32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="request must be"):
        engine.submit(np.zeros((16, 16, 3), np.uint8))


def test_drain_answers_everything_accepted():
    engine = _engine(batch_timeout_ms=2.0).start()
    futures = [engine.submit(im) for im in _images(7)]
    engine.drain()
    preds = [f.result(timeout=0) for f in futures]
    assert len(preds) == 7 and all(p.scores.shape == (5,) for p in preds)
    assert engine.metrics.completed == 7
    assert engine.seen_buckets <= set(engine.buckets)
    with pytest.raises(EngineClosed):
        engine.submit(_images(1)[0])


def test_swap_state_adopted_at_batch_boundary():
    """A swap published while a batch runs is not seen by that batch; the
    next batch runs on the new weights and carries their provenance."""
    old, new = _port_model(seed=0), _port_model(seed=1)
    predict = _predict()
    engine = None
    seen = []

    def swapping_predict(model, images):
        seen.append(model)
        if len(seen) == 1:
            engine.swap_state(new, digest="d1", generation=3)
        return predict(model, images)

    engine = ServingEngine(old, swapping_predict, image_size=32, device=CPU,
                           buckets=(1,), max_batch=1)
    f1 = engine.submit(_images(1, seed=1)[0])
    f2 = engine.submit(_images(1, seed=1)[0])
    engine.process_once()
    engine.process_once()
    p1, p2 = f1.result(timeout=0), f2.result(timeout=0)
    assert seen == [old, new]
    assert (p1.digest, p1.generation) == ("fresh", -1)
    assert (p2.digest, p2.generation) == ("d1", 3)
    assert engine.params_digest == "d1"
    assert not np.array_equal(p1.scores, p2.scores)


def test_state_compatible():
    engine = _engine()
    assert engine.state_compatible(_port_model(seed=5))
    assert not engine.state_compatible(_port_model(num_classes=7))


def test_close_fails_pending_requests():
    engine = _engine()
    f = engine.submit(_images(1)[0])
    engine.close()
    with pytest.raises(EngineClosed):
        f.result(timeout=0)


def test_checkpoint_round_trip_and_tamper(tmp_path):
    sd = _port_model().state_dict()
    path = str(tmp_path / "w.pt")
    digest = checkpoint.save(sd, path)
    assert open(checkpoint.checksum_path(path)).read().strip() == digest
    back = checkpoint.restore(path)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)

    with open(path, "r+b") as f:  # flip one byte in the middle
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="sha256"):
        checkpoint.restore(path)
    os.remove(checkpoint.checksum_path(path))
    with pytest.raises(ValueError, match="no sha256 sidecar"):
        checkpoint.restore(path)


SMALL = ["baseline", "--model", "tresnet_m", "--image_size", "64",
         "--num_classes", "10", "--device", "cpu"]


def _rc(argv) -> int:
    try:
        serve_cli.main(argv)
    except SystemExit as e:
        return int(e.code)
    return 0


def test_cli_tampered_checkpoint_exits_2(tmp_path, capsys):
    path = str(tmp_path / "w.pt")
    checkpoint.save({"x": torch.zeros(4)}, path)
    with open(path, "ab") as f:
        f.write(b"tamper")
    assert _rc(SMALL + ["--ckpt", path, "--selfcheck", "1"]) == 2
    assert "sha256" in capsys.readouterr().err


def test_cli_serves_a_verified_checkpoint(tmp_path, capsys):
    cfg = serve_cli.config_from_args(
        serve_cli.build_parser().parse_args(SMALL + ["--selfcheck", "1"]))
    from ddp_classification_pytorch_tpu_torch.train.state import (
        create_served_model,
    )

    path = str(tmp_path / "w.pt")
    checkpoint.save(create_served_model(cfg, CPU).state_dict(), path)
    assert _rc(SMALL + ["--ckpt", path, "--selfcheck", "2"]) == 0
    out = capsys.readouterr().out
    assert f"serving {path}" in out and "selfcheck ok: 2 requests" in out


@pytest.mark.parametrize("argv", [
    ["--model", "vgg19_bn"],                 # arch not ported yet
    ["--buckets", "4,2"],                    # not ascending
    ["--topk", "11"],                        # more than num_classes
    [],                                      # no weights, no selfcheck
], ids=["arch", "buckets", "topk", "no-weights"])
def test_cli_config_errors_exit_2(argv, capsys):
    sc = [] if argv == [] else ["--selfcheck", "1"]
    assert _rc(SMALL + argv + sc) == 2
    assert "config error" in capsys.readouterr().err


def test_cli_without_cuda_exits_3(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    argv = [a for a in SMALL if a not in ("--device", "cpu")]
    assert _rc(argv + ["--selfcheck", "1"]) == 3
    assert "backend unreachable" in capsys.readouterr().err


def test_cli_selfcheck_subprocess_exits_0():
    """The module entry point as a user runs it, rc and all."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "ddp_classification_pytorch_tpu_torch.cli.serve",
         *SMALL, "--selfcheck", "3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "[serve] selfcheck ok: 3 requests" in proc.stdout


def test_selfcheck_answers_every_request_from_the_batcher_thread():
    cfg = serve_cli.config_from_args(
        serve_cli.build_parser().parse_args(SMALL + ["--selfcheck", "5"]))
    engine = serve_cli.build_engine(cfg, CPU)
    engine.warmup()
    threads_before = threading.active_count()
    preds = serve_cli.run_selfcheck(engine, cfg, 5)
    assert len(preds) == 5
    assert all(np.isfinite(p.scores).all() for p in preds)
    assert engine.metrics.completed == 5
    assert threading.active_count() <= threads_before  # batcher joined
