"""Serving over several devices (`--serve_devices`), the dp bucket rule and
`--platform`: `ServeConfig.resolve_buckets(dp)` equal to the JAX
package's (error text included), `parallel/mesh.py::serve_devices` equal
to JAX's `serve_mesh` in its refusals, an engine over two CPU devices
against the one-device engine, and the CLI's rc discipline."""

import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.config import get_preset as jax_preset
from ddp_classification_pytorch_tpu.parallel import mesh as jax_mesh
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.parallel.mesh import serve_devices
from ddp_classification_pytorch_tpu_torch.serve.engine import ServingEngine

from torch_port_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SMALL = ["baseline", "--model", "tresnet_m", "--image_size", "32",
         "--num_classes", "10", "--dtype", "float32", "--device", "cpu"]


def _resolve(cfg, max_batch, buckets, dp):
    cfg.serve.max_batch, cfg.serve.buckets = max_batch, buckets
    try:
        return cfg.serve.resolve_buckets(dp)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("max_batch,buckets", [
    (8, ()), (6, ()), (1, ()), (3, ()), (8, (2, 4, 8)), (8, (1, 2, 4, 8)),
    (6, (2, 6)), (4, (4,)), (8, (3, 6)), (8, (4, 2)), (16, (8,)), (0, ()),
], ids=lambda v: str(v))
def test_resolve_buckets_matches_jax(max_batch, buckets, dp):
    jax_out = _resolve(jax_preset("baseline"), max_batch, buckets, dp)
    port_out = _resolve(get_preset("baseline"), max_batch, buckets, dp)
    assert port_out == jax_out
    if isinstance(port_out, str) and "divisible" in port_out:
        assert "serve-bucket-dp-indivisible" in port_out


@pytest.mark.parametrize("n", [0, 1, 3, 8, 9, -1])
def test_serve_devices_match_jax_serve_mesh(n):
    """The first n of the visible devices (0 = all); more than exist or a
    negative count is the same ValueError as JAX's."""
    import jax

    try:
        want = int(jax_mesh.serve_mesh(n).size)
    except ValueError as e:
        want = str(e)
    try:
        got = len(serve_devices(n, devices=[CPU] * len(jax.devices())))
    except ValueError as e:
        got = str(e)
    assert got == want


def _cfg(extra=()):
    return serve_cli.config_from_args(serve_cli.build_parser().parse_args(
        SMALL + ["--max_batch", "4", "--batch_timeout_ms", "0",
                 "--selfcheck", "1", *extra]))


def _answers(engine, imgs):
    futures = [engine.submit(im) for im in imgs]
    assert engine.process_once() == len(imgs)
    return [f.result(timeout=30) for f in futures]


def test_two_cpu_devices_answer_as_one():
    """Over two devices each bucket splits into two row blocks: the answers
    are bitwise the one-device predict of each block, gathered in order,
    and equal the one-device engine's at the whole bucket in indices,
    with probabilities within 1e-6 (the CPU's kernels sum in another
    order at another batch size: 3e-8 to 2e-7 apart here)."""
    cfg = _cfg()
    one = serve_cli.build_engine(cfg, CPU)
    two = ServingEngine.from_config(cfg, one._state, one._predict, CPU,
                                    devices=[CPU, CPU])
    assert (two.dp, two.serve_devices) == (2, 2)
    assert two.buckets == cfg.serve.resolve_buckets(2) == (2, 4)
    one.warmup()
    two.warmup()
    imgs = np.random.default_rng(3).integers(0, 256, (4, 32, 32, 3)).astype(
        np.uint8)
    for b in two.buckets:
        got, ref = _answers(two, imgs[:b]), _answers(one, imgs[:b])
        share = b // 2
        blocks = [one._predict(one._state, torch.from_numpy(
            imgs[i * share:(i + 1) * share])) for i in range(2)]
        np.testing.assert_array_equal(
            np.stack([p.scores for p in got]),
            np.concatenate([s.numpy() for s, _ in blocks]))
        np.testing.assert_array_equal(
            np.stack([p.indices for p in got]),
            np.concatenate([i.numpy() for _, i in blocks]))
        for p, q in zip(got, ref):
            np.testing.assert_array_equal(p.indices, q.indices)
            np.testing.assert_allclose(p.scores, q.scores, rtol=0, atol=1e-6)
    assert two.seen_buckets == {2, 4}
    one.drain()
    two.drain()


def test_indivisible_bucket_refused_by_the_engine():
    cfg = _cfg()
    model = serve_cli.build_engine(cfg, CPU)._state
    with pytest.raises(ValueError, match="serve-bucket-dp-indivisible"):
        ServingEngine(model, lambda m, x: None, image_size=32, device=CPU,
                      devices=[CPU, CPU], buckets=(1, 2), max_batch=2)


def _rc(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        return int(e.code)
    return 0


@pytest.mark.parametrize("extra,rc,text", [
    (["--serve_devices", "2"], 2, "exceeds the 1 visible devices"),
    (["--serve_devices", "1"], 0, "serve_devices=1 dp=1"),
    (["--serve_devices", "0"], 0, "serve_devices=1 dp=1"),
    (["--serve_devices", "1", "--buckets", "3"], 2, "max_batch=4 exceeds"),
], ids=["too-many", "one", "all", "bad-buckets"])
def test_cli_serve_devices(extra, rc, text, capsys):
    argv = SMALL + ["--max_batch", "4", "--selfcheck", "2", *extra]
    assert _rc(serve_cli.main, argv) == rc
    out = capsys.readouterr()
    assert text in (out.err if rc else out.out)


def _without_device(argv):
    return [a for a in argv if a not in ("--device", "cpu")]


def test_cli_platform_cpu_serves_as_device_cpu(capsys):
    argv = _without_device(SMALL) + ["--platform", "cpu", "--selfcheck", "2"]
    assert _rc(serve_cli.main, argv) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "selfcheck ok: 2 requests" in out
    argv = SMALL + ["--platform", "cpu", "--selfcheck", "2"]  # agreeing
    assert _rc(serve_cli.main, argv) == 0


@pytest.mark.parametrize("main", [serve_cli.main, train_cli.main],
                         ids=["serve", "train"])
@pytest.mark.parametrize("flags,text", [
    (["--platform", "tpu"], "no TPU route"),
    (["--platform", "gpu", "--device", "cpu"], "disagree"),
    (["--platform", "cuda", "--device", "cpu"], "disagree"),
    (["--platform", "cpu", "--device", "cuda"], "disagree"),
], ids=["tpu", "gpu-cpu", "cuda-cpu", "cpu-cuda"])
def test_cli_platform_refusals_exit_2(main, flags, text, capsys, tmp_path):
    if main is serve_cli.main:
        argv = _without_device(SMALL) + ["--selfcheck", "1"]
    else:
        argv = ["baseline", "--dataset", "synthetic", "--synthetic_size", "8",
                "--model", "resnet18", "--image_size", "32",
                "--num_classes", "4", "--batchsize", "4", "--epochs", "1",
                "--out", str(tmp_path / "r")]
    assert _rc(main, argv + flags) == 2
    assert text in capsys.readouterr().err


def test_cli_platform_gpu_without_a_card_is_rc_3(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the platform resolves")
    argv = _without_device(SMALL) + ["--platform", "gpu", "--selfcheck", "1"]
    assert _rc(serve_cli.main, argv) == 3
    assert "backend unreachable" in capsys.readouterr().err


def test_train_cli_platform_cpu_trains(tmp_path, capsys):
    argv = ["baseline", "--dataset", "synthetic", "--synthetic_size", "8",
            "--model", "resnet18", "--variant", "cifar", "--image_size", "32",
            "--num_classes", "4", "--batchsize", "4", "--epochs", "1",
            "--dtype", "float32", "--platform", "cpu",
            "--out", str(tmp_path / "r")]
    assert _rc(train_cli.main, argv) == 0
    assert "[epoch 0]" in capsys.readouterr().out
