"""`serve` entry point of the port — stand up the micro-batching inference
engine (serve/engine.py) on the card, over fresh or checkpointed weights.

    python -m ddp_classification_pytorch_tpu_torch.cli.serve baseline \
        --model tresnet_m --selfcheck 32
    python -m ddp_classification_pytorch_tpu_torch.cli.serve baseline \
        --model resnet50 --ckpt runs/r50/ckpt_e89.pt --selfcheck 8
    python -m ddp_classification_pytorch_tpu_torch.cli.serve arcface \
        --model resnet50 --ckpt runs/arc/ckpt_e29.pt   # or nested
    python -m ddp_classification_pytorch_tpu_torch.cli.serve nested \
        --model vgg19_bn --ckpt runs/vgg/ckpt_best.pt

The workload's preset names the head: `arcface` serves softmax over
s·cosθ, `nested` the unmasked logits of its bias-free classifier, the
others (cdr's too) a plain fc model.

The JAX serve CLI's subset, with its rc discipline:

- deterministic config errors (bad buckets, topk > classes, an arch or head
  not ported yet, a corrupt `--ckpt`) exit **rc 2** — supervisors must
  not replay them; every ported arch (the ResNets, VGG19-BN, TResNet-M,
  the ViTs) is served under every head;
- no CUDA device (and `--device cpu` not asked for) exits **rc 3**, the JAX
  CLI's "backend unreachable" code; it never carries on on the CPU;
- **SIGTERM/SIGINT drain gracefully**: intake stops, every already-queued
  request is answered, metrics print one final line, exit **rc 0**.

`--selfcheck N` serves N seeded uint8 requests through the full engine path
(warmup → batcher thread → drain) and exits — the smoke `chip_smoke.py` and
the tests drive.

The train → publish → watch → serve loop, as with the JAX CLI:

    python -m ddp_classification_pytorch_tpu_torch.cli.serve baseline \
        --model tresnet_m --watch runs/t --port 8000 \
        [--fleet_dir runs/fleet --fleet_replica 0] \
        [--admission_deadline_ms 250 --admission_tenants "a:3,b:1"]
    curl -X POST --data-binary @img.jpg localhost:8000/predict

- `--watch <run dir>` serves the newest verified `ckpt_eN.pt` there and
  hot-swaps each newer one in at a batch boundary (`serve/reload.py`);
  a torn candidate becomes `*.corrupt` and serving goes on. `--ckpt` and
  `--watch` each supply the weights, and are mutually exclusive.
- `--port P` answers `POST /predict` (the body decoded with PIL; rc 2 at
  startup where PIL cannot be imported), `GET /healthz`, `/metrics`,
  `/metrics.json` (`serve/http.py`).
- `--fleet_dir` joins a serve fleet (leases, the rolling wave's drain
  token); `--admission_deadline_ms` sheds by measured queue wait, per
  `X-Tenant` (`serve/fleet.py`). A bad tenant spec is rc 2.
- SIGTERM: HTTP stops, the watcher stops, the queue drains, the fleet
  lease goes, `[serve] drained clean`, rc 0. With `SCENARIO_EVENTS` set
  the run appends `serve_ready`, `verify_ok`, `swap`, `drain_begin` and
  `drain_end` (`obs/events.py`).

Not ported yet (ROADMAP.md): `--serve_devices` (one card per process),
the AOT sidecar and `--strict_compile` (eager PyTorch compiles nothing per
bucket; a CUDA graph per bucket is the counterpart), `--platform`; the
parser does not know these flags (rc 2).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config, get_preset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ddp_classification_pytorch_tpu_torch.cli.serve",
        description="micro-batched inference serving on the card",
    )
    p.add_argument("workload", choices=["baseline", "arcface", "cdr", "nested", "plc"],
                   help="preset whose model/head the weights were trained "
                        "with (same presets as the JAX CLI)")

    m = p.add_argument_group("model")
    m.add_argument("--model", "--arch", dest="model", default="",
                   help="resnet18 | resnet34 | resnet50 (default) | "
                        "resnet101 | resnet152 | vgg19_bn | tresnet_m | timm "
                        "| vit_t16 | vit_s16 | vit_b16")
    m.add_argument("--variant", default="", help="ResNet stem: imagenet | "
                   "cifar (default imagenet)")
    m.add_argument("--dtype", default="", help="bfloat16 | float32 compute dtype")
    m.add_argument("--num_classes", type=int, default=0)
    m.add_argument("--image_size", type=int, default=0)
    m.add_argument("--input_dtype", default="", choices=["", "uint8", "float32"],
                   help="request wire format (default uint8: raw pixels, "
                        "normalized on the device)")

    s = p.add_argument_group("serving")
    s.add_argument("--ckpt", default="",
                   help="the port's checkpoint to serve (sha256-verified; a "
                        "corrupt file is a deterministic rc 2)")
    s.add_argument("--watch", default="",
                   help="run dir to serve from AND poll for checkpoint "
                        "hot-reload (newest verified checkpoint wins; "
                        "corrupt candidates are quarantined, serving "
                        "continues on the previous weights)")
    s.add_argument("--reload_poll_s", type=float, default=-1.0,
                   help="hot-reload poll cadence for --watch (default 5)")
    s.add_argument("--buckets", default="",
                   help="comma list of padded batch shapes, ascending "
                        "(default: powers of two up to --max_batch)")
    s.add_argument("--max_batch", type=int, default=0,
                   help="largest micro-batch the deadline batcher assembles "
                        "(default 8)")
    s.add_argument("--batch_timeout_ms", type=float, default=-1.0,
                   help="deadline from the first queued request until a "
                        "partial batch flushes (default 5; 0 = never wait)")
    s.add_argument("--queue_depth", type=int, default=0,
                   help="bounded intake queue; submits beyond it are "
                        "rejected (default 64)")
    s.add_argument("--topk", type=int, default=0,
                   help="classes returned per request (default 5)")
    s.add_argument("--port", type=int, default=-1,
                   help=">0: stdlib HTTP front-end (POST /predict, "
                        "GET /healthz|/metrics); default: engine only")
    s.add_argument("--selfcheck", type=int, default=0,
                   help="serve N seeded requests through the full engine "
                        "path, print metrics, drain, exit 0 (smoke mode)")
    s.add_argument("--fleet_dir", "--fleet-dir", dest="fleet_dir", default="",
                   help="shared fleet run dir: replicas heartbeat via "
                        "<dir>/serve_fleet/lease.r<id> and serialize hot "
                        "reloads through one drain token (rolling wave, at "
                        "most one replica draining); default: lone replica")
    s.add_argument("--fleet_replica", "--fleet-replica", dest="fleet_replica",
                   type=int, default=-1,
                   help="this replica's id in the shared --fleet_dir "
                        "(lowest live id is the leader; default 0)")
    s.add_argument("--fleet_ttl_s", "--fleet-ttl-s", dest="fleet_ttl_s",
                   type=float, default=-1.0,
                   help="lease/drain-token freshness horizon: a lease older "
                        "than this is a dead replica, a stale token is "
                        "taken over (default 15)")
    s.add_argument("--admission_deadline_ms", "--admission-deadline-ms",
                   dest="admission_deadline_ms", type=float, default=-1.0,
                   help=">0: shed requests when the MEASURED queue wait "
                        "(depth / observed service rate) exceeds this "
                        "deadline — fair-share tenants shed at 1x, any "
                        "tenant at 2x; 503 bodies carry the depth + shed "
                        "tenant (default 0 = engine queue bound only)")
    s.add_argument("--admission_tenants", "--admission-tenants",
                   dest="admission_tenants", default="",
                   help="per-tenant weighted fair shares for admission, "
                        "'name:weight,name:weight' (requests pick a tenant "
                        "via the X-Tenant header; default: one 'default' "
                        "tenant at weight 1)")

    r = p.add_argument_group("run")
    r.add_argument("--out", default="", help="output dir")
    r.add_argument("--tensorboard", action="store_true",
                   help="write serve/* scalar curves to <out>/tb")
    r.add_argument("--log_every_s", type=float, default=-1.0,
                   help="metrics console line cadence (default 10)")
    r.add_argument("--seed", type=int, default=-1)
    r.add_argument("--device", default="", choices=["", "cuda", "cpu"],
                   help="default cuda; cpu only when asked (rc 3 when cuda "
                        "is missing and cpu was not asked for)")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = get_preset(args.workload)
    if args.model:
        cfg.model.arch = args.model
    if args.dtype:
        cfg.model.dtype = args.dtype
    if args.variant:
        cfg.model.variant = args.variant
    if args.num_classes:
        cfg.data.num_classes = args.num_classes
    if args.image_size:
        cfg.data.image_size = args.image_size
    if args.input_dtype:
        cfg.data.input_dtype = args.input_dtype
    if args.seed >= 0:
        cfg.run.seed = args.seed
    if args.out:
        cfg.run.out_dir = args.out
    if args.tensorboard:
        cfg.run.tensorboard = True

    sv = cfg.serve
    if args.ckpt:
        sv.checkpoint = args.ckpt
    if args.watch:
        sv.watch_dir = args.watch
    if args.reload_poll_s >= 0:
        sv.reload_poll_s = args.reload_poll_s
    if args.buckets:
        sv.buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    if args.max_batch:
        sv.max_batch = args.max_batch
    if args.batch_timeout_ms >= 0:
        sv.batch_timeout_ms = args.batch_timeout_ms
    if args.queue_depth:
        sv.queue_depth = args.queue_depth
    if args.topk:
        sv.topk = args.topk
    if args.port >= 0:
        sv.port = args.port
    if args.log_every_s >= 0:
        sv.log_every_s = args.log_every_s
    if args.fleet_dir:
        sv.fleet_dir = args.fleet_dir
    if args.fleet_replica >= 0:
        sv.fleet_replica = args.fleet_replica
    if args.fleet_ttl_s >= 0:
        sv.fleet_ttl_s = args.fleet_ttl_s
    if args.admission_deadline_ms >= 0:
        sv.admission_deadline_ms = args.admission_deadline_ms
    if args.admission_tenants:
        sv.admission_tenants = args.admission_tenants

    sv.resolve_buckets()  # raises ValueError on bad knob combinations
    sv.validate_fleet()  # fleet/admission knobs are config-shaped too
    if sv.topk > cfg.data.num_classes:
        raise ValueError(
            f"serve.topk={sv.topk} exceeds num_classes={cfg.data.num_classes}")
    if cfg.model.arch in ("tresnet_m", "timm") and cfg.data.image_size % 4:
        raise ValueError(f"image_size={cfg.data.image_size} must be a "
                         "multiple of 4 (TResNet's space-to-depth stem)")
    if sv.checkpoint and sv.watch_dir:
        raise ValueError("--ckpt and --watch are mutually exclusive: an "
                         "explicit checkpoint pins the weights, a watch dir "
                         "hot-reloads them")
    if not (sv.checkpoint or sv.watch_dir or args.selfcheck):
        raise ValueError("serving needs weights: pass --ckpt <file> or "
                         "--watch <run_dir> (or --selfcheck N to smoke the "
                         "engine on fresh weights)")
    return cfg


def served_model_builder(cfg: Config, device: torch.device):
    """`state_dict -> served model` for `cfg` on `device` (ValueError when
    the weights do not fit): what a hot reload builds each candidate with."""
    from ..train.state import create_served_model

    return lambda state_dict: create_served_model(cfg, device, state_dict)


def build_engine(cfg: Config, device: torch.device):
    """Model (fresh from `run.seed`, or the verified `serve.checkpoint`) →
    predict → engine, with the val transform of the data preset for
    `submit_image`. Raises ValueError for everything config-shaped."""
    from ..serve.engine import ServingEngine
    from ..serve.metrics import ServeMetrics
    from ..train import checkpoint
    from ..train.steps import make_topk_predict_step

    state_dict = None
    if cfg.serve.checkpoint:  # a trainer's train state, or bare weights
        state_dict = checkpoint.model_state(
            checkpoint.restore(cfg.serve.checkpoint))
    model = served_model_builder(cfg, device)(state_dict)
    predict = make_topk_predict_step(cfg, cfg.serve.topk)
    return ServingEngine.from_config(cfg, model, predict, device,
                                     metrics=ServeMetrics())


def run_selfcheck(engine, cfg: Config, n: int) -> List:
    """Serve `n` seeded requests (made as the JAX CLI makes them) through
    the batcher thread, then drain. Returns the Predictions; raises if any
    is missing or not finite."""
    rng = np.random.default_rng(cfg.run.seed)
    h = cfg.data.image_size
    imgs = (rng.integers(0, 256, (n, h, h, 3)).astype(np.uint8)
            if cfg.data.input_dtype == "uint8"
            else rng.normal(size=(n, h, h, 3)).astype(np.float32))
    engine.start()
    futures = [engine.submit(img) for img in imgs]
    preds = [f.result(timeout=120) for f in futures]
    engine.drain()
    bad = [i for i, p in enumerate(preds) if not np.isfinite(p.scores).all()]
    if bad:
        raise RuntimeError(f"selfcheck: non-finite scores for requests {bad}")
    return preds


class Serving:
    """The serve path's layers over one engine, wired from `cfg` as `main`
    wires them: the engine (`build_engine`), the fleet member
    (`--fleet_dir`), the admission controller (`--admission_deadline_ms`),
    the checkpoint watcher (`--watch`, its newest verified checkpoint
    already adopted) and, once started, the HTTP server (`--port`). The
    in-process counterpart of the CLI (`chip_smoke.py` drives it)."""

    def __init__(self, cfg: Config, device: torch.device):
        from ..utils.logging import host0_print

        self.cfg = cfg
        self.engine = engine = build_engine(cfg, device)  # ValueError: rc 2
        metrics = engine.metrics
        self.fleet = self.admission = self.watcher = self.server = None
        if cfg.serve.fleet_dir:
            from ..serve.fleet import FleetMember

            # shares the engine registry so fleet_* gauges ride /metrics;
            # the lease heartbeat itself piggybacks on the watcher's poll
            self.fleet = FleetMember(cfg.serve.fleet_dir,
                                     cfg.serve.fleet_replica,
                                     ttl_s=cfg.serve.fleet_ttl_s,
                                     registry=metrics.registry)
        if cfg.serve.admission_deadline_ms > 0:
            from ..serve.fleet import AdmissionController

            self.admission = AdmissionController(
                engine, tenants=cfg.serve.admission_tenants,
                deadline_ms=cfg.serve.admission_deadline_ms,
                registry=metrics.registry)
        if cfg.serve.watch_dir:
            from ..serve.reload import CheckpointWatcher
            from ..utils import chaos as chaoslib

            # watcher_io drills aim CHAOS_FAULT_SPEC at a replica; its
            # one-shot markers live under this replica's own out dir, not
            # the shared watch dir (each replica owns its poll counter)
            plan = chaoslib.plan_for_run("", cfg.run.out_dir or ".", 0)
            self.watcher = CheckpointWatcher(
                cfg.serve.watch_dir, engine, served_model_builder(cfg, device),
                poll_s=cfg.serve.reload_poll_s, metrics=metrics,
                fleet=self.fleet, chaos=plan if plan else None)
            loaded = self.watcher.restore_initial()
            host0_print(f"[serve] watching {cfg.serve.watch_dir} "
                        + (f"(serving epoch {loaded})" if loaded >= 0 else
                           "(no verified checkpoint yet; serving fresh "
                           "weights until one lands)"))

    def start(self) -> "Serving":
        """The batcher, the watcher's poll thread and the HTTP server
        (after `engine.warmup()`), then `serve_ready`."""
        from ..obs.events import emit
        from ..utils.logging import host0_print

        port = self.cfg.serve.port
        self.engine.start()
        if self.watcher is not None:
            self.watcher.start()
        if port:
            from ..serve.http import start_server

            self.server = start_server(self.engine, port,
                                       watcher=self.watcher, fleet=self.fleet,
                                       admission=self.admission)
            host0_print(f"[serve] http on :{port} (POST /predict, "
                        "GET /healthz, GET /metrics)", flush=True)
        if self.fleet is not None and self.watcher is None:
            # --ckpt pins the weights (no watcher poll to ride): announce
            # the pinned digest once so the registry sees this replica
            self.fleet.heartbeat(digest=self.engine.params_digest,
                                 generation=self.engine.params_generation)
        emit("serve_ready", port=port, epoch=(
            self.watcher.loaded_epoch if self.watcher is not None else -1))
        return self

    def drain(self) -> None:
        """Graceful drain: HTTP intake stops first, the watcher stops,
        every already-accepted request is served, the fleet lease goes."""
        from ..obs.events import emit
        from ..utils.logging import host0_print

        engine = self.engine
        host0_print("[serve] SIGTERM/SIGINT: draining — intake stopped, "
                    f"{engine.queue_depth} request(s) queued")
        emit("drain_begin", queued=engine.queue_depth)
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
        if self.watcher is not None:
            self.watcher.stop()
        engine.drain()
        if self.fleet is not None:
            self.fleet.leave()  # drop the lease now, not after the TTL
        emit("drain_end")


def _install_signal_handlers(stop: threading.Event):
    """SIGTERM/SIGINT → set the drain event (the serve loop does the actual
    drain: stop intake, flush queue, exit rc 0). Returns the previous
    handlers so tests can restore them."""
    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        prev[sig] = signal.signal(sig, lambda *_: stop.set())
    return prev


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..utils.backend_probe import BackendUnavailable, resolve_device
    from ..utils.logging import host0_print

    args = build_parser().parse_args(argv)
    try:
        cfg = config_from_args(args)
    except ValueError as e:
        print(f"[serve] config error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    if cfg.serve.port:
        from ..serve.http import decoder_available

        if not decoder_available():
            # deterministic: the same environment refuses the same way
            print("[serve] config error: --port decodes request bodies "
                  "with PIL, which cannot be imported here",
                  file=sys.stderr)
            raise SystemExit(2)
    try:
        device = resolve_device(args.device)
    except BackendUnavailable as e:
        print(f"[serve] backend unreachable: {e}", file=sys.stderr)
        raise SystemExit(3) from None
    try:
        serving = Serving(cfg, device)
    except ValueError as e:
        # unknown arch/head, corrupt --ckpt, weights that do not fit: config
        # shaped, deterministic → rc 2
        print(f"[serve] config error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    engine, metrics = serving.engine, serving.engine.metrics
    if cfg.serve.checkpoint:
        host0_print(f"[serve] serving {cfg.serve.checkpoint}")

    host0_print(f"[serve] arch={cfg.model.arch} classes={cfg.data.num_classes} "
                f"dtype={cfg.model.dtype} wire={cfg.data.input_dtype} "
                f"buckets={list(engine.buckets)} "
                f"max_batch={cfg.serve.max_batch} "
                f"timeout={cfg.serve.batch_timeout_ms}ms "
                f"topk={cfg.serve.topk} device={device}")
    engine.warmup()
    host0_print(f"[serve] warm: {len(engine.buckets)} buckets run once")

    tb = None
    if cfg.run.tensorboard:
        from ..utils.tensorboard import SummaryWriter

        tb = SummaryWriter(os.path.join(cfg.run.out_dir, "tb"), "serve")

    if args.selfcheck:
        run_selfcheck(engine, cfg, args.selfcheck)
        if serving.watcher is not None:
            serving.watcher.stop()
        if serving.fleet is not None:
            serving.fleet.leave()
        host0_print(metrics.log_line(engine.queue_depth))
        if tb is not None:
            metrics.to_tensorboard(tb, 0)
            tb.close()
        host0_print(f"[serve] selfcheck ok: {args.selfcheck} requests, "
                    f"buckets used {sorted(engine.seen_buckets)}")
        return

    stop = threading.Event()
    _install_signal_handlers(stop)
    serving.start()
    step = 0
    while not stop.wait(cfg.serve.log_every_s):
        host0_print(metrics.log_line(engine.queue_depth), flush=True)
        if tb is not None:
            metrics.to_tensorboard(tb, step)
            tb.flush()
        step += 1
    serving.drain()
    host0_print(metrics.log_line(engine.queue_depth))
    if tb is not None:
        metrics.to_tensorboard(tb, step)
        tb.close()
    host0_print("[serve] drained clean")


if __name__ == "__main__":
    main()
