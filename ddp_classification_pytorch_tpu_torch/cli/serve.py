"""`serve` entry point of the port — stand up the micro-batching inference
engine (serve/engine.py) on the card, over fresh or checkpointed weights.

    python -m ddp_classification_pytorch_tpu_torch.cli.serve baseline \
        --model tresnet_m --selfcheck 32
    python -m ddp_classification_pytorch_tpu_torch.cli.serve baseline \
        --model resnet50 --ckpt runs/r50/ckpt_e89.pt --selfcheck 8
    python -m ddp_classification_pytorch_tpu_torch.cli.serve arcface \
        --model resnet50 --ckpt runs/arc/ckpt_e29.pt   # or nested

The workload's preset names the head: `arcface` serves softmax over
s·cosθ, `nested` the unmasked logits of its bias-free classifier, the
others (cdr's too) a plain fc model.

The JAX serve CLI's subset, with its rc discipline:

- deterministic config errors (bad buckets, topk > classes, an arch or head
  not ported yet — the arcface and nested heads are served on the ResNets
  only —, a corrupt `--ckpt`) exit **rc 2** — supervisors must not
  replay them;
- no CUDA device (and `--device cpu` not asked for) exits **rc 3**, the JAX
  CLI's "backend unreachable" code; it never carries on on the CPU;
- **SIGTERM/SIGINT drain gracefully**: intake stops, every already-queued
  request is answered, metrics print one final line, exit **rc 0**.

`--selfcheck N` serves N seeded uint8 requests through the full engine path
(warmup → batcher thread → drain) and exits — the smoke `chip_smoke.py` and
the tests drive. Not ported yet: `--watch` hot reload, the HTTP front end
(`--port`), the fleet and admission layers, the AOT sidecar and
`--serve_devices` (ROADMAP.md).
"""

from __future__ import annotations

import argparse
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
                        "resnet101 | resnet152 | tresnet_m | timm")
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
    s.add_argument("--selfcheck", type=int, default=0,
                   help="serve N seeded requests through the full engine "
                        "path, print metrics, drain, exit 0 (smoke mode)")

    r = p.add_argument_group("run")
    r.add_argument("--out", default="", help="output dir")
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

    sv = cfg.serve
    if args.ckpt:
        sv.checkpoint = args.ckpt
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

    sv.resolve_buckets()  # raises ValueError on bad knob combinations
    if sv.topk > cfg.data.num_classes:
        raise ValueError(
            f"serve.topk={sv.topk} exceeds num_classes={cfg.data.num_classes}")
    if cfg.model.arch in ("tresnet_m", "timm") and cfg.data.image_size % 4:
        raise ValueError(f"image_size={cfg.data.image_size} must be a "
                         "multiple of 4 (TResNet's space-to-depth stem)")
    if not (sv.checkpoint or args.selfcheck):
        raise ValueError("serving needs weights: pass --ckpt <file> (or "
                         "--selfcheck N to smoke the engine on fresh "
                         "weights)")
    return cfg


def build_engine(cfg: Config, device: torch.device):
    """Model (fresh from `run.seed`, or the verified `serve.checkpoint`) →
    predict → engine. Raises ValueError for everything config-shaped."""
    from ..serve.engine import ServingEngine
    from ..serve.metrics import ServeMetrics
    from ..train import checkpoint
    from ..train.state import create_served_model
    from ..train.steps import make_topk_predict_step

    state_dict = None
    if cfg.serve.checkpoint:  # a trainer's train state, or bare weights
        state_dict = checkpoint.model_state(
            checkpoint.restore(cfg.serve.checkpoint))
    model = create_served_model(cfg, device, state_dict)
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


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..utils.backend_probe import BackendUnavailable, resolve_device
    from ..utils.logging import host0_print

    args = build_parser().parse_args(argv)
    try:
        cfg = config_from_args(args)
    except ValueError as e:
        print(f"[serve] config error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    try:
        device = resolve_device(args.device)
    except BackendUnavailable as e:
        print(f"[serve] backend unreachable: {e}", file=sys.stderr)
        raise SystemExit(3) from None
    try:
        engine = build_engine(cfg, device)
    except ValueError as e:
        # unknown arch/head, corrupt --ckpt, weights that do not fit: config
        # shaped, deterministic → rc 2
        print(f"[serve] config error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
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

    if args.selfcheck:
        run_selfcheck(engine, cfg, args.selfcheck)
        host0_print(engine.metrics.log_line(engine.queue_depth))
        host0_print(f"[serve] selfcheck ok: {args.selfcheck} requests, "
                    f"buckets used {sorted(engine.seen_buckets)}")
        return

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    engine.start()
    while not stop.wait(cfg.serve.log_every_s):
        host0_print(engine.metrics.log_line(engine.queue_depth))
    # graceful drain: intake stops first, then every already-accepted
    # request is served, then exit 0
    host0_print("[serve] SIGTERM/SIGINT: draining — intake stopped, "
                f"{engine.queue_depth} request(s) queued")
    engine.drain()
    host0_print(engine.metrics.log_line(engine.queue_depth))
    host0_print("[serve] drained clean")


if __name__ == "__main__":
    main()
