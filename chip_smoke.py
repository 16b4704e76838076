#!/usr/bin/env python3
"""On-card smoke of the torch port: builds its kernels, holds each against
its plain PyTorch version, and drives the port's main path — serving
TResNet-M at full width and depth — on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and ignored):

1. device — CUDA is required (no CPU fallback); prints the card's name and
   power limit as nvidia-smi gives them;
2. build — K1 from `ops/csrc/fused_abn.cu` with nvcc for sm_90a;
3. kernel vs plain — K1 against `fused_bn_leaky_relu_ref` at every ABN shape
   TResNet-M gives it at bucket 8 / 224 px, plus a ragged channel count and
   an odd row count, in f32 (atol/rtol 1e-5) and bf16 (compared in f32,
   atol/rtol 1e-2: one bf16 ulp of slack); per shape: max error, kernel and
   plain device µs (kernel durations from torch.profiler, mean of 20 calls,
   L2 warm as after the conv that feeds it), the kernel's wall µs as the
   host drives it (CUDA events, median of 20), and the bound;
4. the main path — `cli/serve.py`'s selfcheck sequence in process:
   TResNet-M, 224 px, 2173 classes, bf16, uint8 wire, buckets 1/2/4/8,
   warmup → batcher thread → drain over 32 seeded requests. Every future is
   answered with finite probabilities and K1's launch count rose by exactly
   36 per forward (warmup buckets + served batches);
5. the slice, kernel vs plain — one bucket-8 batch through the served model
   with random non-degenerate weights, once with K1 and once with every
   ABN site calling the plain version on the same CUDA tensors; logits agree
   within 5% of their standard deviation (bf16 activations through 36
   ABN sites; the two differ only where an f32 result rounds to bf16 on the
   other side of a tie); then the same weights in f32 on the CPU (the
   plain path the CPU tests hold against the JAX package) as the reference
   for two images: within 10% of the logits' spread, same top-1;
6. timings — the 36 K1 launches of one bucket-8 forward as a sequence, and
   the served forward per bucket: device time (summed kernel durations from
   torch.profiler) and wall time as the host drives it (CUDA events), with
   the SM clock and power draw read beside them;
7. a `{"kernels": [...]}` line, then `{"ok": true, "device": {...}}` last.

Numerics on the card: `torch.backends.cudnn.allow_tf32 = False` and
`torch.backends.cuda.matmul.allow_tf32 = False` (f32 convolutions and
matmuls are compared in full f32). Details land in
`chiprun_out/chip_smoke.json`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
ABN_OPS_PER_ELEMENT = 6  # sub, mul, fma (2), compare, mul by slope
REPS = 20
SERVE_ARGV = ["baseline", "--model", "tresnet_m", "--image_size", "224",
              "--num_classes", "2173", "--dtype", "bfloat16",
              "--input_dtype", "uint8", "--buckets", "1,2,4,8",
              "--max_batch", "8", "--selfcheck", "32", "--device", "cuda"]
ABN_SITES = 36  # stem + abn1 of 21 blocks + abn2 of 14 bottlenecks


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*a) -> None:
    print(*a, flush=True)


def abn_bound_ms(shapes, itemsize: int):
    """Least time the card needs for K1 over `shapes`, and what bounds it:
    the larger of bytes moved (x read once, y written once, 4 f32 (C,)
    vectors) over the memory rate and f32 operations over the f32 peak."""
    nbytes = sum(int(np.prod(s)) * 2 * itemsize + 4 * s[1] * 4 for s in shapes)
    ops = sum(int(np.prod(s)) * ABN_OPS_PER_ELEMENT for s in shapes)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def wall_ms(torch, fn, reps: int = REPS) -> float:
    """Median time of `fn` as the host drives it: CUDA events around each
    call with nothing queued ahead, so the host's launch overhead counts —
    what a request sees."""
    fn()
    events = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
              for _ in range(reps)]
    for s, e in events:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


class DeviceTimer:
    """Device time per call of labelled regions: the summed durations of the
    kernels each region launches, read by torch.profiler (CUPTI) — the
    card's busy time, whatever gaps the host leaves. All regions share ONE
    profiler session (in one process, repeated sessions stopped recording
    device activity after about sixteen). A region runs its calls and
    synchronizes inside a `record_function` range, with 2 ms idle on each
    side; a kernel counts toward the region whose host range, widened by
    1 ms each way, holds its start. The range's own mirror on the device
    timeline (a span from its first kernel to its last, gaps included) is
    not a kernel and is left out."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile, record_function

        self.torch = torch
        self.record_function = record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.regions = []

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def run(self, label: str, fn, reps: int = REPS) -> None:
        fn()  # warm, outside the region
        self.torch.cuda.synchronize()
        time.sleep(0.002)
        with self.record_function(label):
            for _ in range(reps):
                fn()
            self.torch.cuda.synchronize()
        time.sleep(0.002)
        self.regions.append((label, reps))

    def results(self) -> dict:
        """label -> (device ms per call, names of the kernels it ran)."""
        cuda = self.torch.autograd.DeviceType.CUDA
        events = self.prof.events()
        labels = {label for label, _ in self.regions}
        ranges = {e.name: e.time_range for e in events
                  if e.name in labels and e.device_type != cuda}
        kernels = [(e.time_range.start, e.time_range.elapsed_us(), e.name)
                   for e in events
                   if e.device_type == cuda and e.name not in labels]
        out = {}
        for label, reps in self.regions:
            r = ranges[label]
            mine = [(d, n) for t, d, n in kernels
                    if r.start - 1e3 <= t <= r.end + 1e3]
            check(bool(mine), f"torch.profiler recorded no device time for {label}")
            out[label] = (sum(d for d, _ in mine) / reps / 1e3,
                          [n for _, n in mine])
        return out


def clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def randomize_(torch, model, seed: int) -> None:
    """Random non-degenerate weights (the recipe of the oracle tests):
    fan-in-scaled normal conv/linear weights, BN γ ~ U(0.5, 1.5), biases
    ~ N(0, 0.1), running mean ~ N(0, 0.2), running var ~ U(0.5, 2)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                new = torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5
            elif name.endswith("weight"):
                new = torch.rand(p.shape, generator=gen) + 0.5
            else:
                new = torch.randn(p.shape, generator=gen) * 0.1
            p.copy_(new)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.2)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) * 1.5 + 0.5)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this script runs on the "
              "card only, with no CPU fallback", file=sys.stderr)
        return 1
    from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli
    from ddp_classification_pytorch_tpu_torch.models import tresnet
    from ddp_classification_pytorch_tpu_torch.ops import fused_abn
    from ddp_classification_pytorch_tpu_torch.train.state import create_served_model
    from ddp_classification_pytorch_tpu_torch.train.steps import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        device_input_epilogue,
        make_topk_predict_step,
    )
    from ddp_classification_pytorch_tpu_torch.utils.backend_probe import (
        resolve_device,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {}
    k1 = fused_abn.fused_bn_leaky_relu

    # -------------------------------------------------------- 1. device --
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] {name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    report["card"] = card
    device = resolve_device("cuda")

    # --------------------------------------------------------- 2. build --
    t0 = time.perf_counter()
    lib = fused_abn.build()
    build_s = time.perf_counter() - t0
    log(f"[build] {os.path.relpath(lib, REPO)} in {build_s:.2f} s")
    with open(lib + ".log") as f:
        for line in f.read().splitlines():
            log(f"[build] nvcc: {line}")
    report["build_s"] = build_s

    # ABN shapes at bucket 8 come from the model itself: hooks on one
    # forward of a second instance of the served model (phases 5 and 6
    # reuse it), outside the counted run
    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(SERVE_ARGV))
    model = create_served_model(cfg, device)
    predict = make_topk_predict_step(cfg, cfg.serve.topk)
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda _m, args: shapes.append(tuple(args[0].shape)))
        for m in model.modules() if isinstance(m, tresnet.FusedABN)]
    h = cfg.data.image_size
    probe = torch.zeros((8, h, h, 3), dtype=torch.uint8, device=device)
    predict(model, probe)
    for hk in hooks:
        hk.remove()
    check(len(shapes) == ABN_SITES,
          f"{len(shapes)} ABN sites in one forward, expected {ABN_SITES}")

    # ------------------------------------------ 3. kernel vs plain (K1) --
    gen = torch.Generator(device=device).manual_seed(0)
    ragged = [(393, 48), (1001, 37)]  # odd M; C = 48 and a C off every vector width
    cases = sorted(set(shapes), key=lambda s: (-s[2], s[1])) + ragged
    max_err = 0.0
    per_shape = []
    for shape in cases:
        c = shape[1]

        def vec(lo, hi):
            return torch.rand(c, device=device, generator=gen) * (hi - lo) + lo

        scale, bias = vec(0.5, 1.5), vec(-0.5, 0.5)
        mean, var = vec(-0.5, 0.5), vec(0.5, 2.0)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            if len(shape) == 4:  # (N, C, H, W) channels_last, as the model has it
                n, _, hh, ww = shape
                x = (torch.randn((n, hh, ww, c), device=device, generator=gen)
                     * 1.5 + 0.3).to(dtype).permute(0, 3, 1, 2)
            else:  # (M, C) rows
                x = (torch.randn(shape, device=device, generator=gen)
                     * 1.5 + 0.3).to(dtype)
            args = (x, scale, bias, mean, var, 1e-5, tresnet.SLOPE)
            y, ref = k1(*args), fused_abn.fused_bn_leaky_relu_ref(*args)
            torch.cuda.synchronize()
            check(y.dtype == dtype and y.shape == x.shape, f"K1 output {shape}")
            err = (y.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=tol)
            max_err = max(max_err, err)
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err,
                   "kernel_wall_us": wall_ms(torch, lambda: k1(*args)) * 1e3,
                   "bound_us": abn_bound_ms([shape], x.element_size())[0] * 1e3,
                   "sites_per_forward": shapes.count(shape)}
            per_shape.append((row, args))  # device times: phase 6
        log(f"[k1] {shape}: K1 agrees with the plain version (f32, bf16)")

    # -------------------------------------------------- 4. the main path --
    k1.launches = 0  # count only the main path's launches
    t0 = time.perf_counter()
    engine = serve_cli.build_engine(cfg, device)
    engine.warmup()
    preds = serve_cli.run_selfcheck(engine, cfg, 32)
    wall = time.perf_counter() - t0
    launches = k1.launches
    forwards = len(engine.buckets) + engine.metrics.batches
    snap = engine.metrics.snapshot(engine.queue_depth)
    log(engine.metrics.log_line(engine.queue_depth))
    check(len(preds) == 32 and engine.metrics.completed == 32,
          "not every request was answered")
    check(all(p.scores.shape == (5,) and np.isfinite(p.scores).all()
              and (p.scores >= 0).all() and p.scores.sum() <= 1.0 + 1e-3
              for p in preds), "non-finite or invalid probabilities")
    check(launches == ABN_SITES * forwards,
          f"K1 launched {launches} times over {forwards} forwards "
          f"({len(engine.buckets)} warmup + {engine.metrics.batches} batches), "
          f"expected {ABN_SITES * forwards}")
    lat = sorted(p.latency_ms for p in preds)
    serve = {"requests": 32, "forwards": forwards, "launches": launches,
             "first_batch_ms": lat[0], "last_batch_ms": lat[-1],
             "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
             "bucket_hist": snap["bucket_hist"], "wall_s": wall,
             "selfcheck_images_per_s": 32 / wall}
    log(f"[serve] {name}: {json.dumps(serve)}")
    report["serve"] = serve

    # ------------------------------------- 5. the slice, kernel vs plain --
    randomize_(torch, model, seed=1)
    rng = np.random.default_rng(cfg.run.seed)
    batch = torch.from_numpy(
        rng.integers(0, 256, (8, h, h, 3)).astype(np.uint8)).to(device)
    mean = torch.from_numpy(IMAGENET_MEAN).view(1, 3, 1, 1).to(device)
    std = torch.from_numpy(IMAGENET_STD).view(1, 3, 1, 1).to(device)

    def logits():
        with torch.inference_mode():
            x = device_input_epilogue(batch.permute(0, 3, 1, 2), mean, std)
            return model(x).float()

    before = k1.launches
    with_kernel = logits()
    check(k1.launches == before + ABN_SITES, "kernel forward skipped K1")
    tresnet.fused_bn_leaky_relu = fused_abn.fused_bn_leaky_relu_ref
    try:
        with_plain = logits()
    finally:
        tresnet.fused_bn_leaky_relu = k1
    check(k1.launches == before + ABN_SITES, "plain forward launched K1")
    spread = with_plain.std().item()
    diff = (with_kernel - with_plain).abs().max().item()
    log(f"[slice] logits std {spread:.6g}, max |kernel - plain| {diff:.6g}, "
        f"top-1 agreement "
        f"{(with_kernel.argmax(1) == with_plain.argmax(1)).float().mean().item()}")
    check(torch.isfinite(with_kernel).all().item(), "non-finite logits")
    check(spread > 1e-3, f"degenerate logits (std {spread})")
    check(diff <= 0.05 * spread,
          f"slice logits disagree: max diff {diff} > 5% of std {spread}")
    report["slice"] = {"logits_std": spread, "max_abs_diff": diff}

    # the same weights in f32 on the CPU (plain ABN, which the CPU tests
    # hold against the JAX package) as the reference for two images: the
    # bf16 card forward stays within 10% of the logits' spread
    # (bf16 rounding through ~70 conv/norm layers) and agrees on top-1
    ref_cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
        SERVE_ARGV[:-2] + ["--dtype", "float32", "--device", "cpu"]))
    ref_model = create_served_model(ref_cfg, torch.device("cpu"),
                                    state_dict=model.state_dict())
    with torch.inference_mode():
        x = device_input_epilogue(batch[:2].cpu().permute(0, 3, 1, 2),
                                  mean.cpu(), std.cpu())
        ref_logits = ref_model(x).float()
    ref_spread = ref_logits.std().item()
    ref_diff = (with_kernel[:2].cpu() - ref_logits).abs().max().item()
    top1 = (with_kernel[:2].cpu().argmax(1) == ref_logits.argmax(1)).all().item()
    log(f"[slice] card bf16 vs CPU f32 reference (2 images): max |diff| "
        f"{ref_diff:.6g}, logits std {ref_spread:.6g}, top-1 equal {top1}")
    check(ref_diff <= 0.1 * ref_spread and top1,
          f"served logits off the f32 CPU reference: {ref_diff} vs std "
          f"{ref_spread}, top-1 equal {top1}")
    report["slice"].update(ref_max_abs_diff=ref_diff, ref_logits_std=ref_spread)

    # ------------------------------------------------------ 6. timings --
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    sites = []
    for shape in shapes:  # the 36 launches of one bucket-8 forward, in order
        n, c, hh, ww = shape
        x = torch.randn((n, hh, ww, c), device=device,
                        generator=gen).to(torch.bfloat16).permute(0, 3, 1, 2)
        vecs = [torch.rand(c, device=device, generator=gen) + 0.5
                for _ in range(4)]
        sites.append((x, *vecs, 1e-5, tresnet.SLOPE))
    plain = fused_abn.fused_bn_leaky_relu_ref
    served = engine._state
    bucket_imgs = {b: torch.zeros((b, h, h, 3), dtype=torch.uint8, device=device)
                   for b in engine.buckets}
    seq = {"wall_ms": wall_ms(torch, lambda: [k1(*a) for a in sites]),
           "bound_ms": abn_bound_ms(shapes, 2)[0],
           "bound_by": abn_bound_ms(shapes, 2)[1]}
    forward = {b: {"wall_ms": wall_ms(torch, lambda im=im: predict(served, im))}
               for b, im in bucket_imgs.items()}
    with DeviceTimer(torch) as timer:  # device times, host overhead aside
        for i, (row, args) in enumerate(per_shape):
            timer.run(f"k1 {i}", lambda a=args: k1(*a))
            timer.run(f"plain {i}", lambda a=args: plain(*a))
        timer.run("k1 seq", lambda: [k1(*a) for a in sites])
        timer.run("plain seq", lambda: [plain(*a) for a in sites])
        for b, im in bucket_imgs.items():
            timer.run(f"forward {b}", lambda im=im: predict(served, im), reps=10)
    res = timer.results()
    del sites
    for label, (_, names) in res.items():  # attribution check: K1 regions
        if label.startswith("k1 "):           # hold exactly their launches
            want = REPS * (ABN_SITES if label == "k1 seq" else 1)
            check(len(names) == want and all("fused_abn" in n for n in names),
                  f"profiler region {label}: {len(names)} kernels, want {want} K1")
    dev = {label: ms for label, (ms, _) in res.items()}
    for i, (row, _) in enumerate(per_shape):
        row.update(kernel_us=dev[f"k1 {i}"] * 1e3, plain_us=dev[f"plain {i}"] * 1e3)
        log("[k1] " + json.dumps(row))
    seq.update(ms=dev["k1 seq"], plain_ms=dev["plain seq"])
    log(f"[timing] {name}: K1 x{ABN_SITES} at bucket 8: {json.dumps(seq)}")
    for b, f in forward.items():
        f.update(device_ms=dev[f"forward {b}"],
                 device_busy=dev[f"forward {b}"] / f["wall_ms"],
                 images_per_s=b / f["wall_ms"] * 1e3)
        log(f"[timing] {name}: served forward, bucket {b}: {json.dumps(f)}")
    log(f"[timing] clocks.sm, clocks.max.sm, power.draw: {clocks()}")
    report["k1_shapes"] = [row for row, _ in per_shape]
    report["k1_forward_sequence"] = seq
    report["forward"] = forward

    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    # ------------------------------------------------------- 7. summary --
    log(json.dumps({"kernels": [{
        "name": "fused_bn_leaky_relu",
        "route": "cuda",
        "source": "ddp_classification_pytorch_tpu_torch/ops/csrc/fused_abn.cu",
        "replaces": "ddp_classification_pytorch_tpu/ops/pallas_kernels.py:37",
        "tpu": "ops/pallas_kernels.py::_fused_kernel",
        "checked": True,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": seq["ms"],
        "plain_ms": seq["plain_ms"],
        "bound_ms": seq["bound_ms"],
        "bound_by": seq["bound_by"],
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
