"""Serving the JAX package's flax msgpack checkpoints: the port's reader
(`train/flax_msgpack.py`) against `flax.serialization.msgpack_restore`,
bitwise on every leaf of checkpoints the JAX package's `CheckpointManager`
wrote (a reduced ResNet-18, a reduced TResNet-M, a 2-block ViT, chunked
arrays); `cli/serve.py --ckpt
x.msgpack` answering JAX's `make_topk_predict_step` top-k on the same
checkpoint and uint8 images; the sidecar's verdicts (rc 2 when torn,
"legacy" when missing); and the encoder `chip_smoke.py` writes its card
fixture with, byte for byte `flax.serialization.to_bytes`."""

import collections
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from ddp_classification_pytorch_tpu.config import get_preset as jax_preset
from ddp_classification_pytorch_tpu.models import factory as jax_factory
from ddp_classification_pytorch_tpu.models import resnet as jax_resnet
from ddp_classification_pytorch_tpu.models.tresnet import TResNet as JaxTResNet
from ddp_classification_pytorch_tpu.models.vit import ViT as JaxViT
from ddp_classification_pytorch_tpu.train.checkpoint import (
    CheckpointManager as JaxManager,
)
from ddp_classification_pytorch_tpu.train.state import TrainState as JaxTrainState
from ddp_classification_pytorch_tpu.train.steps import (
    make_topk_predict_step as jax_topk,
)
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
from ddp_classification_pytorch_tpu_torch.models import convert
from ddp_classification_pytorch_tpu_torch.train import checkpoint, flax_msgpack
from ddp_classification_pytorch_tpu_torch.train.state import create_served_model

from torch_port_helpers import REDUCED, random_variables, random_vit_params
from torch_port_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
JaxState = collections.namedtuple("JaxState", "params batch_stats")


def _save(state, out_dir) -> str:
    mgr = JaxManager(str(out_dir), async_save=False)
    mgr.save(state, epoch=0)
    return os.path.join(str(out_dir), "ckpt_e0.msgpack")


def _state(params, stats):
    tx = optax.sgd(0.1, momentum=0.9)
    return JaxTrainState(step=jnp.asarray(3, jnp.int32), params=params,
                         batch_stats=stats, opt_state=tx.init(params))


def _same(a, b, path="") -> None:
    """flax's leaf `a` and the port reader's `b`: the same type, dtype,
    shape and bits (a bfloat16 leaf as a torch.bfloat16 tensor)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif getattr(a, "dtype", None) is not None and a.dtype.name == "bfloat16":
        assert isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16, path
        assert np.asarray(a).shape == tuple(b.shape), path
        assert np.array_equal(np.asarray(a).view(np.uint16),
                              b.view(torch.int16).numpy().view(np.uint16)), path
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype, (path, type(b))
        assert np.asarray(a).shape == np.asarray(b).shape, path
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _reduced(kind):
    """(flax model, params, batch_stats) of a reduced model, f32."""
    rng = np.random.default_rng(7)
    if kind == "resnet18":
        model = jax_factory.ClassifierModel(backbone=jax_resnet.ResNet(
            block_cls=jax_resnet.BasicBlock, stage_sizes=(1, 1, 1, 1),
            num_filters=8, num_classes=10, dtype=jnp.float32))
        params, stats = random_variables(model, 32, rng)
    elif kind == "tresnet_m":
        model = jax_factory.ClassifierModel(
            backbone=JaxTResNet(dtype=jnp.float32, **REDUCED))
        params, stats = random_variables(model, 32, rng)
    else:
        model = jax_factory.ClassifierModel(backbone=JaxViT(
            patch=16, dim=64, depth=2, heads=1, num_classes=10,
            dtype=jnp.float32))
        params, stats = random_vit_params(model, 32, rng), {}
    return model, params, stats


@pytest.mark.parametrize("kind", ["resnet18", "tresnet_m", "vit"])
def test_reader_is_bitwise_flax_on_jax_checkpoints(kind, tmp_path):
    """Every leaf — f32 params and statistics, the int32 step, the
    optimizer's momentum — as flax reads it; plus a bf16 copy of the
    params and a numpy scalar in the same file."""
    _, params, stats = _reduced(kind)
    state = _state(params, stats)
    path = _save(state, tmp_path)
    with open(path, "rb") as f:
        data = f.read()
    _same(flax.serialization.msgpack_restore(data), flax_msgpack.unpackb(data))
    extra = {"bf16": jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), params),
        "scalar": np.float32(1.25), "i64": np.int64(-7), "c": 2 - 1j}
    data = flax.serialization.to_bytes(extra)
    _same(flax.serialization.msgpack_restore(data), flax_msgpack.unpackb(data))
    # and the served model's weights: the converter over the read tree
    sd = checkpoint.load_jax_checkpoint(path)
    want = {k: v for k, v in convert.from_jax_variables(
        jax.device_get(params), jax.device_get(stats)).items()}
    assert sorted(sd) == sorted(want)
    assert all(torch.equal(sd[k], want[k]) for k in sd)


def test_chunked_arrays_read_as_flax_reads_them(tmp_path, monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    _, params, stats = _reduced("resnet18")
    path = _save(_state(params, stats), tmp_path)
    with open(path, "rb") as f:
        data = f.read()
    assert b"__msgpack_chunked_array__" in data
    _same(flax.serialization.msgpack_restore(data), flax_msgpack.unpackb(data))


@pytest.mark.parametrize("bad,text", [
    (b"\xc1", "starts no msgpack form"),
    (b"\x81\xa1a\xc7\x02\x05ab", "ext type 5"),
    (b"\x81\xa1a", "truncated"),
    (b"\xc0\xc0", "trailing bytes"),
    (b"\xc7\x06\x01\x92\x90\xa3abc", "malformed ndarray"),
    (b"\xc7\x0b\x01\x93\x90\xa6object\xc4\x00", "object dtype"),
    (b"\xc7\x0c\x01\x93\x90\xa7float99\xc4\x00", "unknown ndarray dtype"),
], ids=["reserved-byte", "ext-5", "truncated", "trailing", "bad-ndarray",
        "object", "dtype"])
def test_reader_refuses_what_flax_does_not_write(bad, text):
    with pytest.raises(ValueError, match=text):
        flax_msgpack.unpackb(bad)


def test_encoder_bytes_equal_flax_to_bytes(tmp_path, monkeypatch):
    """The smoke's card fixture: a port model's weights as the JAX train
    state tree (`chip_smoke.flax_train_state`), encoded byte for byte as
    flax's `to_bytes` (chunking included), and read back into the same
    weights."""
    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
        ["baseline", "--model", "resnet18", "--variant", "cifar",
         "--image_size", "32", "--num_classes", "10", "--dtype", "float32",
         "--device", "cpu", "--selfcheck", "1"]))
    sd = create_served_model(cfg, CPU).state_dict()
    tree = chip_smoke.flax_train_state(sd, convert)
    data = flax_msgpack.packb(tree)
    assert data == flax.serialization.to_bytes(tree)
    path = str(tmp_path / "ckpt_e0.msgpack")
    with open(path, "wb") as f:
        f.write(data)
    back = checkpoint.load_jax_checkpoint(path)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 4096)
    assert flax_msgpack.packb(tree) == flax.serialization.to_bytes(tree)


# ------------------------------------------------- served through the CLI --

SERVE = ["--model", "resnet18", "--variant", "cifar", "--image_size", "32",
         "--num_classes", "10", "--dtype", "float32", "--device", "cpu",
         "--max_batch", "4", "--batch_timeout_ms", "0"]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """JAX train states of the JAX factory's models at full ResNet-18
    (CIFAR stem) width, 32 px, 10 classes — weights and BN statistics
    random, as `random_variables` fills them —, written by the JAX
    manager: one per head."""
    out = {}
    rng = np.random.default_rng(11)
    for workload in ("baseline", "arcface", "nested"):
        cfg = jax_preset(workload)
        cfg.model.arch, cfg.model.variant = "resnet18", "cifar"
        cfg.model.dtype = "float32"
        cfg.data.image_size, cfg.data.num_classes = 32, 10
        model = jax_factory.build_model(cfg.model, 10)
        params, stats = random_variables(model, 32, rng)
        if workload == "arcface":  # the filler leaves it 0: every score equal
            params["margin"]["weight"] = rng.normal(
                size=params["margin"]["weight"].shape).astype(np.float32)
        state = _state(params, stats)
        path = _save(state, tmp_path_factory.mktemp(workload))
        out[workload] = (cfg, model, params, stats, path)
    return out


def _rc(argv):
    try:
        serve_cli.main(argv)
    except SystemExit as e:
        return int(e.code)
    return 0


@pytest.mark.parametrize("workload", ["baseline", "arcface", "nested"])
def test_cli_serves_a_jax_checkpoint_with_jax_topk(workload, written, capsys):
    jcfg, jmodel, params, stats, path = written[workload]
    argv = [workload, *SERVE, "--ckpt", path, "--selfcheck", "4"]
    assert _rc(argv) == 0
    out = capsys.readouterr().out
    assert f"serving {path}" in out and "selfcheck ok: 4 requests" in out

    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(argv))
    engine = serve_cli.build_engine(cfg, CPU)
    engine.warmup()
    preds = serve_cli.run_selfcheck(engine, cfg, 4)
    images = np.random.default_rng(cfg.run.seed).integers(
        0, 256, (4, 32, 32, 3)).astype(np.uint8)
    want_p, want_i = jax_topk(jcfg, jmodel, cfg.serve.topk)(
        JaxState(params, stats), jnp.asarray(images))
    np.testing.assert_array_equal(np.stack([p.indices for p in preds]),
                                  np.asarray(want_i))
    np.testing.assert_allclose(np.stack([p.scores for p in preds]),
                               np.asarray(want_p), rtol=0, atol=1e-5)


def test_torn_jax_checkpoint_is_rc_2_and_legacy_accepted(written, tmp_path,
                                                         capsys):
    _, _, _, _, path = written["baseline"]
    torn = str(tmp_path / "ckpt_e0.msgpack")
    with open(path, "rb") as f:
        data = f.read()
    with open(torn, "wb") as f:
        f.write(data[: len(data) // 2])
    with open(path + ".sha256") as f:
        sidecar = f.read()
    with open(torn + ".sha256", "w") as f:
        f.write(sidecar)
    assert _rc(["baseline", *SERVE, "--ckpt", torn, "--selfcheck", "1"]) == 2
    assert "does not match its sha256 sidecar" in capsys.readouterr().err

    os.remove(torn + ".sha256")  # no sidecar: JAX's "legacy", read as is
    assert _rc(["baseline", *SERVE, "--ckpt", torn, "--selfcheck", "1"]) == 2
    assert "msgpack: truncated" in capsys.readouterr().err
    with open(torn, "wb") as f:
        f.write(data)
    assert _rc(["baseline", *SERVE, "--ckpt", torn, "--selfcheck", "1"]) == 0
    assert "no sha256 sidecar" in capsys.readouterr().out


def test_weights_of_another_model_are_rc_2(written, capsys):
    """A JAX checkpoint of another head or class count does not fit the
    served model: rc 2, as a `.pt` that does not fit."""
    _, _, _, _, path = written["arcface"]
    assert _rc(["baseline", *SERVE, "--ckpt", path, "--selfcheck", "1"]) == 2
    assert "config error" in capsys.readouterr().err
    _, _, _, _, path = written["baseline"]
    argv = ["baseline", *SERVE, "--ckpt", path, "--selfcheck", "1"]
    argv[argv.index("--num_classes") + 1] = "7"
    assert _rc(argv) == 2
    assert "weights do not fit" in capsys.readouterr().err
