"""The port's HTTP front end (`serve/http.py`), its decoder, the serve CLI
over HTTP with hot reload, and ViT serving, against the JAX package on
the CPU.

- Decoding: an RGB JPEG, an RGB PNG, a grayscale PNG and an RGBA PNG,
  non-square, made from a numpy seed, through the port's `decode_image` +
  val `Transform` and through JAX's `Transform(Image.open(...))`: the
  uint8 wire arrays are bitwise equal.
- HTTP parity: a reduced ResNet-18 (basic blocks (1, 1, 1, 1), 8 filters,
  CIFAR stem, 32 px, f32, 10 classes, one bucket) with the same weights
  (`models/convert.py::resnet_from_jax`) behind JAX's `make_server` and
  the port's, each on an ephemeral port, driven by one script: the same
  status codes, `Retry-After` values, JSON keys and states for /healthz,
  /metrics.json, 404s, an undecodable body (400), a full queue (503
  busy), an admission shed (503 with `shed_tenant`), answers (200: top-k
  indices equal, scores within 1e-5) and a drained engine (503
  draining); the /metrics family names equal up to the differences named
  in `METRIC_FAMILIES_ONLY_JAX`.
- The CLI as a subprocess: `--watch D --port P` serves, hot-swaps a new
  verified checkpoint, quarantines a torn one, and drains on SIGTERM with
  rc 0; its events pass JAX's `validate_events`. Bad fleet/admission
  knobs exit rc 2.
- The ViT leg: a reduced ViT (depth 2, width 64, 2 heads, 64 px, 16
  tokens, f32) served through `create_served_model` with
  `model.flash_attention` (the flash forward's plain version on the CPU)
  against JAX's `make_topk_predict_step` with the Pallas flash kernel in
  interpret mode: top-k equal, scores within 1e-5.
"""

import collections
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from urllib.error import HTTPError

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ddp_classification_pytorch_tpu.config import get_preset as jax_preset
from ddp_classification_pytorch_tpu.data.transforms import (
    build_transform as jax_build_transform,
)
from ddp_classification_pytorch_tpu.models import resnet as jax_resnet
from ddp_classification_pytorch_tpu.models.factory import (
    ClassifierModel as JaxClassifier,
)
from ddp_classification_pytorch_tpu.models.vit import ViT as JaxViT
from ddp_classification_pytorch_tpu.obs import events as jax_events
from ddp_classification_pytorch_tpu.serve import engine as jax_engine
from ddp_classification_pytorch_tpu.serve import fleet as jax_fleet
from ddp_classification_pytorch_tpu.serve import http as jax_http
from ddp_classification_pytorch_tpu.serve.metrics import (
    ServeMetrics as JaxServeMetrics,
)
from ddp_classification_pytorch_tpu.train.steps import (
    make_topk_predict_step as jax_topk_step,
)
from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.data.transforms import build_transform
from ddp_classification_pytorch_tpu_torch.models import resnet, vit
from ddp_classification_pytorch_tpu_torch.models.convert import (
    resnet_from_jax,
    vit_from_jax,
)
from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel
from ddp_classification_pytorch_tpu_torch.ops import flash_attention as port_fa
from ddp_classification_pytorch_tpu_torch.serve import engine as port_engine
from ddp_classification_pytorch_tpu_torch.serve import fleet as port_fleet
from ddp_classification_pytorch_tpu_torch.serve import http as port_http
from ddp_classification_pytorch_tpu_torch.serve.metrics import ServeMetrics
from ddp_classification_pytorch_tpu_torch.train import checkpoint
from ddp_classification_pytorch_tpu_torch.train.state import create_served_model
from ddp_classification_pytorch_tpu_torch.train.steps import (
    make_topk_predict_step,
)

from torch_port_helpers import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
JaxState = collections.namedtuple("JaxState", "params batch_stats")
TOL = dict(atol=1e-5, rtol=0)


# ------------------------------------------------------------- decoding --
def _encoded(seed: int = 11):
    """(name, bytes) of four non-square images from a numpy seed."""
    rng = np.random.default_rng(seed)
    smooth = rng.integers(0, 256, (3, 4, 3)).astype(np.uint8)
    rgb = np.asarray(Image.fromarray(smooth).resize((250, 190), Image.BILINEAR))
    rgb = np.clip(rgb.astype(np.int16) + rng.integers(-12, 13, rgb.shape),
                  0, 255).astype(np.uint8)
    out = []
    for name, img, fmt in (
            ("rgb_jpeg", Image.fromarray(rgb), "JPEG"),
            ("rgb_png", Image.fromarray(rgb[:150, :230]), "PNG"),
            ("gray_png", Image.fromarray(rgb[:170, :120, 1].copy()), "PNG"),
            ("rgba_png", Image.fromarray(np.dstack(
                [rgb[:, :140], rng.integers(0, 256, (190, 140))
                 .astype(np.uint8)])), "PNG")):
        assert img.mode == {"gray": "L", "rgba": "RGBA"}.get(name[:4], "RGB")
        buf = io.BytesIO()
        img.save(buf, format=fmt)
        out.append((name, buf.getvalue()))
    return out


ENCODED = _encoded()


@pytest.mark.parametrize("size,crop", [(224, 256), (32, 36)],
                         ids=["224", "32"])
@pytest.mark.parametrize("name,data", ENCODED, ids=[n for n, _ in ENCODED])
def test_decode_and_val_transform_bitwise_jax(name, data, size, crop):
    jax_t = jax_build_transform("baseline", False, image_size=size,
                                crop_size=crop, out_dtype="uint8")
    port_t = build_transform("baseline", False, image_size=size,
                             crop_size=crop, out_dtype="uint8")
    want = jax_t(Image.open(io.BytesIO(data)), np.random.default_rng(0))
    got = port_t(port_http.decode_image(data), np.random.default_rng(0))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)


def test_decode_refuses_undecodable_bytes():
    assert port_http.decoder_available()
    for bad in (b"", b"not an image", ENCODED[0][1][:40]):
        with pytest.raises(Exception):
            port_http.decode_image(bad)


# ------------------------------------------------------------ HTTP parity --
# /metrics families only the JAX engine exposes, each with its reason:
# none. The port's ServeMetrics registers every family of the JAX one,
# `engine_recompiles_total` included (it stays 0: eager PyTorch compiles
# nothing per bucket), and the watcher, fleet and admission layers are
# copies; a family either side adds or drops fails the test
METRIC_FAMILIES_ONLY_JAX = frozenset()
IMAGE, CROP, CLASSES, K = 32, 36, 10, 5


@pytest.fixture(scope="module")
def nets():
    """The JAX and port engines' ingredients over the same weights."""
    jmodel = JaxClassifier(backbone=jax_resnet.ResNet(
        stage_sizes=(1, 1, 1, 1), block_cls=jax_resnet.BasicBlock,
        num_filters=8, num_classes=CLASSES, cifar_stem=True,
        dtype=jnp.float32))
    params, stats = random_variables(jmodel, IMAGE, np.random.default_rng(5))
    jcfg = jax_preset("baseline")
    port = ClassifierModel(resnet.ResNet(
        (1, 1, 1, 1), resnet.BasicBlock, num_classes=CLASSES, num_filters=8,
        cifar_stem=True, dtype=torch.float32))
    port.backbone.load_state_dict(resnet_from_jax(params, stats))
    cfg = get_preset("baseline")
    cfg.data.image_size, cfg.data.num_classes = IMAGE, CLASSES
    cfg.data.train_crop_size = CROP
    cfg.serve.buckets, cfg.serve.max_batch = (1,), 1
    cfg.serve.batch_timeout_ms, cfg.serve.queue_depth, cfg.serve.topk = 0, 1, K
    return {"jax_state": JaxState(params, stats),
            "jax_predict": jax_topk_step(jcfg, jmodel, K),
            "port_model": port.eval(), "cfg": cfg}


def _jax_engine(nets):
    return jax_engine.ServingEngine(
        nets["jax_state"], nets["jax_predict"], image_size=IMAGE,
        input_dtype="uint8", max_batch=1, batch_timeout_ms=0, queue_depth=1,
        buckets=(1,), metrics=JaxServeMetrics(),
        transform=jax_build_transform("baseline", False, image_size=IMAGE,
                                      crop_size=CROP, out_dtype="uint8"))


def _port_engine(nets):
    cfg = nets["cfg"]
    return port_engine.ServingEngine.from_config(
        cfg, nets["port_model"], make_topk_predict_step(cfg, K), CPU,
        metrics=ServeMetrics())


def _call(base, method, path, data=None, headers=None):
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            code, hdrs, body = r.status, r.headers, r.read()
    except HTTPError as e:
        code, hdrs, body = e.code, e.headers, e.read()
    ctype = hdrs.get("Content-Type", "")
    parsed = json.loads(body) if ctype == "application/json" else body.decode()
    return code, hdrs.get("Retry-After"), ctype, parsed


def _families(text):
    return {line.split()[0].split("{")[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def _http_script(http_mod, fleet_mod, engine, wire, png):
    """The wire contract, step by step: [(step, status, Retry-After,
    Content-Type, JSON keys, state)], the /metrics families, and the
    bodies of the answered requests."""
    adm = fleet_mod.AdmissionController(engine, tenants="a:3,b:1",
                                        deadline_ms=1.0, rate_fn=lambda: 1.0)
    servers = [http_mod.make_server(engine, 0),
               http_mod.make_server(engine, 0, admission=adm)]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    plain, gated = (f"http://127.0.0.1:{s.server_address[1]}" for s in servers)
    steps, answers = [], []

    def step(name, base, method, path, data=None, headers=None):
        code, retry, ctype, body = _call(base, method, path, data, headers)
        keys = sorted(body) if isinstance(body, dict) else None
        state = body.get("state") if isinstance(body, dict) else None
        extra = (body.get("shed_tenant"), body.get("ok"),
                 body.get("generation"), body.get("digest")) \
            if isinstance(body, dict) else None
        steps.append((name, code, retry, ctype, keys, state, extra))
        if code == 200 and path == "/predict":
            answers.append(body)
        return body

    try:
        step("healthz", plain, "GET", "/healthz")
        step("metrics.json", plain, "GET", "/metrics.json")
        families = _families(step("metrics", plain, "GET", "/metrics"))
        step("get unknown", plain, "GET", "/nope")
        step("post unknown", plain, "POST", "/nope", png)
        step("undecodable", plain, "POST", "/predict", b"\x89PNG broken")
        queued = engine.submit(wire)  # the one queue slot: full
        step("queue full", plain, "POST", "/predict", png)
        step("admission shed", gated, "POST", "/predict", png,
             {"X-Tenant": "b"})
        step("shed default tenant", gated, "POST", "/predict", png)
        engine.start()
        answers.append(queued.result(timeout=60))
        step("answer", plain, "POST", "/predict", png)
        step("admitted", gated, "POST", "/predict", png, {"X-Tenant": "a"})
        families |= _families(step("metrics after", plain, "GET", "/metrics"))
        engine.drain()
        step("draining", plain, "POST", "/predict", png)
        step("healthz drained", plain, "GET", "/healthz")
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
    return steps, families, answers


def test_http_wire_contract_matches_jax(nets):
    png = dict(ENCODED)["rgb_png"]
    port_t = build_transform("baseline", False, image_size=IMAGE,
                             crop_size=CROP, out_dtype="uint8")
    wire = port_t(port_http.decode_image(png), np.random.default_rng(0))
    want, want_fam, want_ans = _http_script(jax_http, jax_fleet,
                                            _jax_engine(nets), wire, png)
    got, got_fam, got_ans = _http_script(port_http, port_fleet,
                                         _port_engine(nets), wire, png)
    assert [s[:6] for s in got] == [s[:6] for s in want]
    assert [s[6] for s in got] == [s[6] for s in want]  # tenants, ok, "fresh"
    codes = {s[0]: (s[1], s[2], s[5]) for s in got}
    assert codes["queue full"] == (503, "1", "busy")
    assert codes["admission shed"] == (503, "1", "busy")
    assert codes["draining"] == (503, "5", "draining")
    assert codes["undecodable"][0] == 400 and codes["get unknown"][0] == 404
    assert codes["answer"][0] == codes["admitted"][0] == 200
    shed = next(s for s in got if s[0] == "admission shed")
    assert shed[6][0] == "b" and "est_wait_ms" in shed[4]
    assert want_fam - got_fam == METRIC_FAMILIES_ONLY_JAX
    assert got_fam - want_fam == set()
    # the answers: the queued wire array and two HTTP bodies, each the
    # same image — top-k indices equal, scores within 1e-5
    assert len(got_ans) == len(want_ans) == 3
    q_want, q_got = want_ans[0], got_ans[0]
    np.testing.assert_array_equal(q_got.indices, np.asarray(q_want.indices))
    np.testing.assert_allclose(q_got.scores, np.asarray(q_want.scores), **TOL)
    for w, g in zip(want_ans[1:], got_ans[1:]):
        assert sorted(g) == sorted(w)
        assert [c for c, _ in g["topk"]] == [c for c, _ in w["topk"]]
        np.testing.assert_allclose([s for _, s in g["topk"]],
                                   [s for _, s in w["topk"]], **TOL)
        assert [c for c, _ in g["topk"]] == q_got.indices.tolist()


# -------------------------------------------------------------------- CLI --
CLI = ["baseline", "--model", "resnet18", "--variant", "cifar",
       "--image_size", "32", "--num_classes", "10", "--dtype", "float32",
       "--device", "cpu"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rc(argv) -> int:
    try:
        serve_cli.main(argv)
    except SystemExit as e:
        return int(e.code)
    return 0


def _wait(cond, timeout_s: float, what: str):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_cli_serves_http_with_hot_reload_and_drains(tmp_path):
    run = tmp_path / "run"
    cfg = serve_cli.config_from_args(
        serve_cli.build_parser().parse_args(CLI + ["--selfcheck", "1"]))
    model = create_served_model(cfg, CPU)
    mgr = checkpoint.CheckpointManager(str(run))
    mgr.save(model, epoch=0)
    events = str(tmp_path / "events.jsonl")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, SCENARIO_EVENTS=events,
               SCENARIO_SOURCE="replica0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddp_classification_pytorch_tpu_torch.cli.serve",
         *CLI, "--watch", str(run), "--port", str(port), "--reload_poll_s",
         "0.2", "--log_every_s", "0.5", "--fleet_dir", str(tmp_path / "fleet"),
         "--out", str(tmp_path / "out")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    base = f"http://127.0.0.1:{port}"
    png = dict(ENCODED)["rgb_jpeg"]
    try:
        def health():
            try:
                return _call(base, "GET", "/healthz")[3]
            except OSError:
                assert proc.poll() is None, proc.communicate()
                return None

        h = _wait(health, 120, "the server")
        assert h["ok"] is True and h["watcher_alive"] is True
        assert h["fleet_role"] == "leader"
        code, _, _, body = _call(base, "POST", "/predict", png)
        assert code == 200 and body["generation"] == 0
        assert body["digest"] == checkpoint.file_digest(mgr.epoch_path(0))
        assert len(body["topk"]) == 5

        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.5)
        mgr.save(model, epoch=1)

        def generation(g):
            code, _, _, b = _call(base, "POST", "/predict", png)
            return code == 200 and b["generation"] == g and b

        body = _wait(lambda: generation(1), 30, "the swap to epoch 1")
        assert body["digest"] == checkpoint.file_digest(mgr.epoch_path(1))
        # a torn candidate, published as a trainer publishes: the bytes,
        # then the sidecar (torn before it becomes visible to the watcher)
        stage = checkpoint.CheckpointManager(str(tmp_path / "stage"))
        stage.save(model, epoch=2)
        with open(stage.epoch_path(2), "r+b") as fh:
            fh.seek(100)
            fh.write(b"\xde\xad\xbe\xef")
        for src in (stage.epoch_path(2), checkpoint.checksum_path(
                stage.epoch_path(2))):
            os.replace(src, os.path.join(run, os.path.basename(src)))
        _wait(lambda: os.path.exists(mgr.epoch_path(2) + ".corrupt"), 30,
              "the quarantine")
        assert generation(1)
        h = health()
        assert h["reloads"] == 1 and h["reloads_rejected"] == 1
        assert h["generation"] == 1 and h["lease_generation"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    assert "[serve] drained clean" in out
    assert "hot-reloaded checkpoint epoch 1" in out
    log = jax_events.read_events(events)
    assert jax_events.validate_events(log) == []
    kinds = [r["kind"] for r in log]
    for kind in ("serve_ready", "verify_ok", "swap", "quarantine",
                 "drain_token_acquire", "drain_token_release", "drain_begin",
                 "drain_end"):
        assert kind in kinds, (kind, kinds)
    assert kinds.index("serve_ready") < kinds.index("drain_begin") \
        < kinds.index("drain_end") == len(kinds) - 1
    assert not os.listdir(tmp_path / "fleet" / "serve_fleet")  # lease gone


@pytest.mark.parametrize("argv", [
    ["--admission_tenants", "a:0"],
    ["--admission_tenants", "a:1,a:2"],
    ["--admission_deadline_ms", "5", "--admission_tenants", ":3"],
    ["--fleet_ttl_s", "0"],
    ["--ckpt", "w.pt", "--watch", "runs/x"],
    ["--serve_devices", "1"],            # JAX-only flags the port refuses
    ["--aot_cache", "off"],
    ["--strict_compile"],
    ["--platform", "cpu"],
], ids=["tenant-weight", "tenant-dup", "tenant-name", "fleet-ttl",
        "ckpt-and-watch", "serve-devices", "aot-cache", "strict-compile",
        "platform"])
def test_cli_bad_serve_knobs_exit_2(argv, capsys):
    assert _rc(CLI + argv + ["--port", "1"]) == 2
    err = capsys.readouterr().err
    assert "config error" in err or "unrecognized arguments" in err


def test_cli_port_without_pil_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(port_http, "decoder_available", lambda: False)
    assert _rc(CLI + ["--port", "1", "--selfcheck", "1"]) == 2
    assert "PIL" in capsys.readouterr().err


# ------------------------------------------------------------- ViT leg --
VIT = dict(patch=16, dim=64, depth=2, heads=2)


def test_served_vit_with_flash_matches_jax(monkeypatch):
    jmodel = JaxClassifier(backbone=JaxViT(
        dtype=jnp.float32, use_flash=True, flash_min_tokens=0,
        num_classes=CLASSES, **VIT))
    x = jnp.zeros((1, 64, 64, 3))
    params = jax.jit(lambda k: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(9)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.normal(0.0, 0.1, v.shape).astype(np.float32)
                         if path[-1].key == "bias" else np.asarray(v)), params)
    images = rng.integers(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    want_p, want_i = jax_topk_step(jax_preset("baseline"), jmodel, K)(
        JaxState(params, {}), jnp.asarray(images))

    monkeypatch.setitem(vit.VIT_CONFIGS, "vit_t16", tuple(VIT.values()))
    cfg = get_preset("baseline")
    cfg.model.arch, cfg.model.dtype = "vit_t16", "float32"
    cfg.model.flash_attention, cfg.model.flash_min_tokens = True, 0
    cfg.data.image_size, cfg.data.num_classes = 64, CLASSES
    cfg.serve.topk = K
    model = create_served_model(cfg, CPU, {
        f"backbone.{k}": v for k, v in vit_from_jax(params).items()})
    assert not model.training
    assert all(b.attn.use_flash for b in model.backbone.blocks)
    assert model.backbone.patch_embed.weight.dtype == torch.float32  # masters
    calls = []
    ref = port_fa.flash_forward_ref
    monkeypatch.setattr(port_fa, "flash_forward_ref",
                        lambda *a, **k: calls.append(1) or ref(*a, **k))
    engine = port_engine.ServingEngine.from_config(
        cfg, model, make_topk_predict_step(cfg, K), CPU)
    futures = [engine.submit(im) for im in images]
    while engine.process_once():
        pass
    preds = [f.result(timeout=0) for f in futures]
    assert len(calls) == VIT["depth"] * engine.metrics.batches  # flash route
    assert port_fa.flash_forward.launches == 0  # no kernel on the CPU
    np.testing.assert_array_equal(np.stack([p.indices for p in preds]),
                                  np.asarray(want_i))
    np.testing.assert_allclose(np.stack([p.scores for p in preds]),
                               np.asarray(want_p), **TOL)
