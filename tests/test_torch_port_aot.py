"""The port's AOT sidecar (`serve/aot.py`) against the JAX package's: each
rung of the load ladder, driven on both with the same fault, gives the
same outcome (a load or a miss, and which file became `*.corrupt`); the
port's bank → load round trip over fake kernel libraries in a temporary
build directory (a warm boot builds nothing and sets `aot_hit`); and
`_resolve_aot_dir` equal to the JAX CLI's.

The JAX side banks one tiny jitted function's executable with
`save_bucket_executables` and loads it with `load_bucket_executables`, as
`ServingEngine.warmup` there does (tests/test_serve_aot.py drives the
same functions through its engine)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.cli import serve as jax_serve_cli
from ddp_classification_pytorch_tpu.config import get_preset as jax_preset
from ddp_classification_pytorch_tpu.serve import aot as jax_aot
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.ops import _build
from ddp_classification_pytorch_tpu_torch.serve import aot

from torch_port_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
BUCKETS = (2,)
SERVE = ["baseline", "--model", "resnet18", "--variant", "cifar",
         "--image_size", "32", "--num_classes", "10", "--dtype", "float32",
         "--device", "cpu", "--max_batch", "2", "--buckets", "2",
         "--batch_timeout_ms", "0"]


# ---------------------------------------------------------- the JAX side --

def _jax_fn(scale):
    return jax.jit(lambda x: (x * scale).sum(axis=1))


def _jax_lower(fn, bucket):
    return fn.lower(jnp.zeros((bucket, 4), jnp.float32))


def _jax_bank(d):
    fn = _jax_fn(2.0)
    lowered = {b: _jax_lower(fn, b) for b in BUCKETS}
    assert jax_aot.save_bucket_executables(
        d, lowered, {b: lo.compile() for b, lo in lowered.items()}, None)


def _jax_load(d, buckets=BUCKETS, scale=2.0):
    fn = _jax_fn(scale)
    return jax_aot.load_bucket_executables(
        d, None, buckets, lambda b: _jax_lower(fn, b))


# --------------------------------------------------------- the port side --

@pytest.fixture
def libs(tmp_path, monkeypatch):
    """Two fake kernel libraries (sources in tmp, 'built' into an empty
    build dir) standing for fused_abn and flash_attention."""
    build = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    srcs = {}
    for name in ("fused_abn", "flash_attention"):
        src = tmp_path / f"{name}.cu"
        src.write_text(f"// {name}\n__global__ void k() {{}}\n")
        srcs[name] = [str(src)]
    monkeypatch.setattr(aot, "kernel_libraries", lambda: srcs)
    build.mkdir()
    for name, s in srcs.items():
        with open(_build.library_path(name, s), "wb") as f:
            f.write(b"\x7fELF " + name.encode() * 64)
    return srcs


def _model():
    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
        SERVE + ["--selfcheck", "1"]))
    from ddp_classification_pytorch_tpu_torch.train.state import (
        create_served_model,
    )

    return create_served_model(cfg, CPU)


def _port_bank(d, model):
    assert aot.save_kernel_libraries(d, [CPU], BUCKETS, model)


def _port_load(d, model, buckets=BUCKETS):
    return aot.load_kernel_libraries(d, [CPU], buckets, model)


def _outcome(loaded, d):
    corrupt = sorted(f for f in os.listdir(d) if f.endswith(".corrupt"))
    kinds = ["manifest" if f.startswith(aot.MANIFEST) else "payload"
             for f in corrupt]
    return ("load" if loaded is not None else "miss", kinds)


def _payload(d, port):
    names = [f for f in os.listdir(d) if f != aot.MANIFEST
             and not f.endswith((".corrupt", ".tmp"))]
    return os.path.join(d, sorted(names)[0])


def _edit_manifest(d, edit):
    path = os.path.join(d, aot.MANIFEST)
    with open(path) as f:
        m = json.load(f)
    edit(m)
    with open(path, "w") as f:
        json.dump(m, f)


def _fault(rung, d, port, srcs):
    """Apply `rung`'s fault to the sidecar in `d`; returns the keyword
    changes the load takes (the bucket set, the program)."""
    if rung == "manifest_missing":
        os.remove(os.path.join(d, aot.MANIFEST))
    elif rung == "manifest_unparseable":
        with open(os.path.join(d, aot.MANIFEST), "w") as f:
            f.write("{not json")
    elif rung == "fingerprint_drift":
        key = "torch_version" if port else "jax_version"
        _edit_manifest(d, lambda m: m.update({key: "0.0.0-stale"}))
    elif rung == "bucket_set_drift":
        return {"buckets": (2, 4)}
    elif rung == "program_drift":
        if port:  # a library's source changed since the bank
            with open(srcs["fused_abn"][0], "a") as f:
                f.write("// edited\n")
        else:  # the model code changed: another program lowers
            return {"scale": 3.0}
    elif rung == "torn_payload":
        with open(_payload(d, port), "r+b") as f:
            f.truncate(16)
    return {}


RUNGS = ["clean", "manifest_missing", "manifest_unparseable",
         "fingerprint_drift", "bucket_set_drift", "program_drift",
         "torn_payload"]
WANT = {"clean": ("load", []), "manifest_unparseable": ("miss", ["manifest"]),
        "torn_payload": ("miss", ["payload"])}


@pytest.mark.parametrize("rung", RUNGS)
def test_ladder_rung_matches_the_jax_sidecar(rung, libs, tmp_path):
    jd, pd = str(tmp_path / "jax_aot"), str(tmp_path / "port_aot")
    _jax_bank(jd)
    kw = _fault(rung, jd, False, libs)
    jax_out = _outcome(_jax_load(jd, **kw), jd)

    model = _model()
    _port_bank(pd, model)
    kw = _fault(rung, pd, True, libs)
    kw.pop("scale", None)
    port_out = _outcome(_port_load(pd, model, **kw), pd)
    assert port_out == jax_out == WANT.get(rung, ("miss", []))


def test_model_structure_drift_is_a_miss(libs, tmp_path):
    """The program digest covers the served model: another arch's sidecar
    (the same kernel libraries) is not this one's."""
    d = str(tmp_path / "aot")
    _port_bank(d, _model())
    from ddp_classification_pytorch_tpu_torch.train.state import (
        create_served_model,
    )

    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
        SERVE + ["--selfcheck", "1", "--num_classes", "7"]))
    assert _port_load(d, create_served_model(cfg, CPU)) is None


def test_bank_load_round_trip_warm_boot_builds_nothing(libs, tmp_path,
                                                       monkeypatch):
    """A cold engine banks the libraries of the build dir (payloads, then
    the manifest); with the build dir emptied a warm engine loads them
    back (bytes equal), `_build.build` then finds them without nvcc, and
    warmup records zero builds with `aot_hit` set; its answers equal the
    cold engine's."""
    d = str(tmp_path / "aot")
    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
        SERVE + ["--selfcheck", "1", "--aot_cache", d]))
    built = {n: open(_build.library_path(n, s), "rb").read()
             for n, s in libs.items()}
    img = np.random.default_rng(0).integers(0, 256, (32, 32, 3)).astype(np.uint8)

    cold = serve_cli.build_engine(cfg, CPU)
    assert cold.aot_dir == d
    cold.warmup()
    assert not cold.aot_hit
    assert sorted(os.listdir(d)) == sorted(
        [aot.MANIFEST] + [os.path.basename(_build.library_path(n, s))
                          for n, s in libs.items()])
    f = cold.submit(img)
    cold.process_once()
    p_cold = f.result(timeout=30)
    cold.close()

    shutil.rmtree(_build.BUILD_DIR)
    calls = []

    def no_nvcc():
        calls.append("find_nvcc")
        raise _build.BuildError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    warm = serve_cli.build_engine(cfg, CPU)
    warm.warmup()
    assert warm.aot_hit and warm.boot["builds"] == 0
    assert "kernel libraries from the AOT sidecar, 0 builds" in \
        serve_cli.warm_banner(warm)
    for name, srcs in libs.items():
        path = _build.build(name, srcs)
        assert open(path, "rb").read() == built[name]
    assert calls == []
    f = warm.submit(img)
    warm.process_once()
    p_warm = f.result(timeout=30)
    warm.close()
    np.testing.assert_array_equal(p_cold.indices, p_warm.indices)
    np.testing.assert_array_equal(p_cold.scores, p_warm.scores)


def test_banking_failure_is_reported_not_raised(libs, tmp_path, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert not aot.save_kernel_libraries(str(blocker / "aot"), [CPU],
                                         BUCKETS, _model())
    assert "AOT sidecar publish failed" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["auto", "off", "", "DIR"])
@pytest.mark.parametrize("weights", ["ckpt", "watch", "none"])
def test_resolve_aot_dir_matches_the_jax_cli(mode, weights, tmp_path):
    got = []
    for cfg, resolve in ((jax_preset("baseline"), jax_serve_cli._resolve_aot_dir),
                         (get_preset("baseline"), serve_cli._resolve_aot_dir)):
        cfg.serve.aot_cache = str(tmp_path / "side") if mode == "DIR" else mode
        if weights == "ckpt":
            cfg.serve.checkpoint = str(tmp_path / "run" / "ckpt_e3.pt")
        elif weights == "watch":
            cfg.serve.watch_dir = str(tmp_path / "run")
        got.append(resolve(cfg))
    assert got[0] == got[1]
    assert (got[1] == "") == (mode == "off" or (weights == "none"
                                                and mode != "DIR"))


def test_cli_aot_cache_flag(tmp_path):
    """--aot_cache reaches the engine: `off` disables, a dir is taken as
    it is, and the serve banner names it."""
    for flag, want in (("off", ""), (str(tmp_path / "x"), str(tmp_path / "x"))):
        cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
            SERVE + ["--selfcheck", "1", "--aot_cache", flag]))
        engine = serve_cli.build_engine(cfg, CPU)
        assert engine.aot_dir == want
        engine.close()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    proc = subprocess.run(
        [sys.executable, "-m", "ddp_classification_pytorch_tpu_torch.cli.serve",
         *SERVE, "--selfcheck", "2", "--aot_cache", str(tmp_path / "side")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"aot={tmp_path / 'side'}" in proc.stdout
    assert "cold boot: 0 kernel library builds; eager on the CPU" in proc.stdout
    assert os.path.isfile(tmp_path / "side" / aot.MANIFEST)
