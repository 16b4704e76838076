"""Micro-batching inference engine: bounded queue → deadline batcher →
bucket-padded predict on the device(s) → per-request futures. The
counterpart of the JAX package's `serve/engine.py`.

- **Bounded intake.** `submit()` puts a request on a `queue_depth`-bounded
  queue and returns a `concurrent.futures.Future`; a full queue raises
  `QueueFull` immediately (backpressure the caller can act on) instead of
  letting latency grow without bound.
- **Deadline batcher.** One batcher thread collects up to `max_batch`
  requests, waiting at most `batch_timeout_ms` past the FIRST queued request
  before flushing a partial batch.
- **Bucket padding.** The collected batch pads (zero rows) to the smallest
  bucket that fits, so the predict sees at most `len(buckets)` shapes. Pad
  rows are discarded on return (the eval-mode forward has no cross-sample
  op, so padding cannot perturb real rows).
- **A CUDA graph per bucket.** On a card, `warmup()` runs each bucket once
  eagerly (which builds and loads the kernel libraries, creates the
  thread's cuBLAS/cuDNN handles and the predict's constants), then
  captures one `torch.cuda.CUDAGraph` per bucket and serve device over a
  static input buffer, `make_topk_predict_step`'s epilogue, forward,
  softmax and top-k, and static (B, k) outputs: the counterpart of the
  JAX package's one compiled executable per bucket. A batch copies its
  pinned host rows into the static input (`non_blocking=True`), replays
  the graph, and copies the (B, k) outputs back. A capture that fails
  raises out of `warmup()`: nothing serves a bucket eagerly on the card.
  On the CPU there are no graphs and every batch runs eagerly.
- **Launch counts.** The kernel wrappers count at capture, where nothing
  runs; the engine takes each graph's capture counts back off and adds
  them on every replay, so the counters stay counts of kernels that ran.
- **The compile sentinel** (`analysis/compile_sentinel.py`). `warmup()`
  arms it first and holds the contract of the JAX engine: a cold boot
  records exactly `len(buckets)` captures per serve device, and at most
  one kernel library build per library on the path (none if they were
  already built). The sentinel stays armed: a steady-state capture or
  build is counted at the batch boundary (`metrics.record_recompile`),
  and under `strict_compile` it sets `fatal_error`, stops intake and
  raises `SteadyStateRecompile` (cli.serve exits rc 2).
- **The AOT sidecar** (`serve/aot.py`). With `aot_dir`, `warmup()` first
  loads the banked kernel libraries (a warm boot: zero builds, asserted,
  `aot_hit`; the graphs are captured all the same), or, on a miss, banks
  the libraries it built or found for the next replica.
- **Serve devices.** Over several devices (`devices`, from
  `--serve_devices`) each holds its own model replica, device thread and
  graphs; a bucket splits into equal row blocks, one a device, and the
  results are gathered in order. Every bucket must divide evenly.
- **uint8 wire.** Each bucket owns one pinned host buffer (on a card); only
  the (B, k) scores and indices come back. Normalization runs on the
  device (`train/steps.py::device_input_epilogue`).
- **One thread a device.** Warmup, capture and every batch run their device
  work on that device's thread: PyTorch keeps cuBLAS/cuDNN handles per
  thread, so a warmup run on another thread would leave the first served
  batch to create its own.
- **Atomic weight swap.** `swap_state()` publishes a new model which the
  batcher adopts at the next batch boundary — no batch mixes two models.
  Where graphs are captured, adoption copies the new parameters and
  buffers into the captured model's tensors in place (`copy_` under
  `no_grad`, on each device's thread): a graph reads the tensors it was
  captured with, so rebinding them would leave it serving the old weights
  with no error. It captures nothing (a hot reload records no sentinel
  event). Without graphs the new model replaces the old.
- **Graceful drain.** `drain()` stops intake (further submits raise
  `EngineClosed`), flushes everything already queued, and joins the
  batcher — the SIGTERM rc-0 contract of `cli/serve.py`.
- **Image intake.** `submit_image()` takes a decoded HWC uint8 RGB array
  (`serve/http.py` decodes request bodies) through the eval pipeline's
  val `Transform` (resize + center crop in numpy, uint8 wire) on the
  caller's thread, then `submit()`s it; it never touches the device, so
  HTTP handler threads transform in parallel.

The engine is fully exercisable in-process: construct it without `start()`
and drive `process_once()` directly — no thread. An engine driven without
`warmup()` captures a bucket's graph at its first batch.
"""


from __future__ import annotations

import copy
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

# held while a capture reads the kernel wrappers' launch counters and while
# a replay adds to them: a capture on one device thread must not count a
# replay on another as its own
_COUNT_LOCK = threading.Lock()


class QueueFull(RuntimeError):
    """Intake queue at serve.queue_depth — backpressure, retry later."""


class EngineClosed(RuntimeError):
    """Engine is draining or closed — no new requests."""


@dataclass
class Prediction:
    """Per-request result: top-k class indices + softmax scores, plus the
    provenance of the weights that answered (which checkpoint digest and
    generation the batch ran under)."""

    indices: np.ndarray  # (k,) int32
    scores: np.ndarray   # (k,) float32
    latency_ms: float    # submit → result, end to end
    digest: str = "fresh"  # sha256 of the adopted checkpoint; "fresh" = init
    generation: int = -1   # adopted checkpoint epoch; -1 = never reloaded


@dataclass
class _Request:
    image: np.ndarray
    future: Future
    t_submit: float


@dataclass
class _Graph:
    """One bucket's captured predict on one device: replay reads `static_in`
    and writes `scores` / `indices`; `launches` are the kernel wrappers'
    counts of one replay."""

    graph: Any  # torch.cuda.CUDAGraph
    static_in: torch.Tensor
    scores: torch.Tensor
    indices: torch.Tensor
    launches: Tuple[Tuple[Callable, int], ...]


def launch_counters() -> List[Callable]:
    """The kernel wrappers that count their launches (`.launches`)."""
    from ..ops import flash_attention as fa
    from ..ops import fused_abn

    return [fused_abn.fused_bn_leaky_relu, fused_abn.bn_stats,
            fused_abn.abn_grad_sums, fused_abn.abn_grad_input,
            fa.flash_forward, fa.flash_dq, fa.flash_dkv]


class ServingEngine:
    """See module docstring. `predict` is
    `(model, images (B, H, W, 3) on the device) -> (scores (B, k),
    indices (B, k))`, built by `train/steps.py::make_topk_predict_step`.
    `devices` (default `[device]`) are the serve devices; `state` lies on
    the first."""

    def __init__(
        self,
        state: nn.Module,
        predict: Callable[[nn.Module, torch.Tensor], Tuple[Any, Any]],
        *,
        image_size: int,
        device: torch.device,
        input_dtype: str = "uint8",
        max_batch: int = 8,
        batch_timeout_ms: float = 5.0,
        queue_depth: int = 64,
        buckets: Sequence[int] = (1, 2, 4, 8),
        metrics: Optional[Any] = None,
        transform: Optional[Callable[[np.ndarray, np.random.Generator],
                                     np.ndarray]] = None,
        devices: Optional[Sequence[torch.device]] = None,
        strict_compile: bool = False,
        aot_dir: str = "",
    ):
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets}")
        if max_batch > buckets[-1]:
            raise ValueError(
                f"max_batch={max_batch} exceeds largest bucket {buckets[-1]}")
        self.devices = [torch.device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        # data-parallel serving: each padded bucket splits into dp equal
        # row blocks. `ServeConfig.resolve_buckets(dp)` already enforces
        # this for config-driven engines; re-checked for direct
        # construction (the JAX engine's error)
        self.dp = self.serve_devices = len(self.devices)
        bad = [b for b in buckets if b % self.dp]
        if bad:
            raise ValueError(
                f"serve buckets {bad} not divisible by the serve mesh's "
                f"data-parallel width dp={self.dp} "
                "(error: serve-bucket-dp-indivisible)")
        self._predict = predict
        self.transform = transform  # val Transform for submit_image
        self.image_size = int(image_size)
        self._np_dtype = np.uint8 if input_dtype == "uint8" else np.float32
        self._wire = torch.uint8 if input_dtype == "uint8" else torch.float32
        self.max_batch = int(max_batch)
        self.batch_timeout_s = float(batch_timeout_ms) / 1e3
        self.buckets = buckets
        # one host staging buffer per bucket, pinned when the devices are
        # cards so the H2D copies can run asynchronously. Reuse is safe:
        # every batch ends in a D2H read of its result, which waits for its
        # copy
        h = self.image_size
        self.graph_mode = self.device.type == "cuda"
        self._host: Dict[int, torch.Tensor] = {
            b: torch.zeros((b, h, h, 3), dtype=self._wire,
                           pin_memory=self.graph_mode)
            for b in buckets}
        # (device index, bucket) → its captured predict (cards only)
        self._graphs: Dict[Tuple[int, int], _Graph] = {}
        self._set_replicas(state)
        if metrics is None:
            from .metrics import ServeMetrics

            metrics = ServeMetrics()
        self.metrics = metrics
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=int(queue_depth))
        self._swap_lock = threading.Lock()
        self._pending_state: Optional[Tuple[nn.Module, str, int]] = None
        # provenance of the weights currently answering: "fresh" until the
        # first verified checkpoint is adopted (swap_state with a digest)
        self._digest = "fresh"
        self._generation = -1
        self._closed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # which padded shapes actually ran (tests assert ⊆ buckets)
        self.seen_buckets: set = set()
        # the one thread per device that touches it (each worker starts at
        # its first task, not here)
        self._executors = [
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix=f"serve-device{i}")
            for i in range(self.dp)]
        # recompile guard: warmup() arms it; steady-state captures and
        # builds are counted, and with strict_compile the engine stops
        # intake and surfaces SteadyStateRecompile via `fatal_error`
        self.strict_compile = bool(strict_compile)
        self.compile_sentinel: Optional[Any] = None
        self._sentinel: Optional[Any] = None  # armed from warmup's start
        self.fatal_error: Optional[BaseException] = None
        # AOT sidecar (serve/aot.py): "" disables
        self.aot_dir = aot_dir
        self.aot_hit = False
        self.boot: Dict[str, Any] = {}  # what warmup() did, for the banner

    @classmethod
    def from_config(cls, cfg, state, predict, device, metrics=None,
                    devices=None, aot_dir=""):
        """Engine wired from a Config tree (serve + data sections). The val
        transform of the data section's preset feeds `submit_image` (the
        JAX CLI's `build_transform(preset, train=False, ...)`); a dataset
        kind without one (synthetic) leaves it None. `devices` (default
        `[device]`) are the serve devices: buckets resolve against their
        count."""
        from ..data.transforms import build_transform, preset_for_dataset

        devices = list(devices) if devices else [torch.device(device)]
        preset = preset_for_dataset(cfg.data.dataset, cfg.data.transform)
        transform = None if preset is None else build_transform(
            preset, train=False, image_size=cfg.data.image_size,
            crop_size=cfg.data.train_crop_size, out_dtype=cfg.data.input_dtype)
        return cls(
            state, predict,
            image_size=cfg.data.image_size,
            device=devices[0],
            devices=devices,
            input_dtype=cfg.data.input_dtype,
            max_batch=cfg.serve.max_batch,
            batch_timeout_ms=cfg.serve.batch_timeout_ms,
            queue_depth=cfg.serve.queue_depth,
            buckets=cfg.serve.resolve_buckets(len(devices)),
            metrics=metrics,
            transform=transform,
            strict_compile=cfg.serve.strict_compile,
            aot_dir=aot_dir,
        )

    def _set_replicas(self, state: nn.Module) -> None:
        """`state` answers on the first device (and on any other device
        equal to it); each other device holds its own copy."""
        self._state = state
        self._replicas = [state if d == self.device
                          else copy.deepcopy(state).to(d)
                          for d in self.devices]

    # -------------------------------------------------------------- intake --
    @property
    def queue_depth(self) -> int:
        return self._q.qsize()

    @property
    def closed(self) -> bool:
        return self._closed

    def submit(self, image: Any) -> Future:
        """Enqueue one request; resolves to a `Prediction`.

        `image` must already be the wire tensor: (image_size, image_size, 3)
        in the engine's input dtype — validated here because a mismatched row
        would otherwise poison a whole padded batch."""
        if self._closed:
            raise EngineClosed("engine is draining; intake stopped")
        arr = np.asarray(image)
        want = (self.image_size, self.image_size, 3)
        if arr.shape != want or arr.dtype != self._np_dtype:
            raise ValueError(
                f"request must be shape {want} dtype {np.dtype(self._np_dtype)}, "
                f"got {arr.shape} {arr.dtype}")
        req = _Request(arr, Future(), time.monotonic())
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self.metrics.record_reject()
            raise QueueFull(
                f"intake queue full ({self._q.maxsize} pending)") from None
        self.metrics.record_submit()
        return req.future

    def submit_image(self, img: np.ndarray) -> Future:
        """Transform a decoded (H, W, 3) uint8 RGB image through the SAME
        val `data.transforms.Transform` the eval pipeline uses — resize /
        center crop on the host, the wire dtype out — then submit."""
        if self.transform is None:
            raise ValueError("engine has no transform; pass the val "
                             "Transform (build_transform(train=False, "
                             "out_dtype=input_dtype)) at construction")
        arr = np.asarray(img)
        if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
            raise ValueError(f"submit_image takes an (H, W, 3) uint8 RGB "
                             f"array, got {arr.shape} {arr.dtype}")
        return self.submit(self.transform(arr, np.random.default_rng(0)))

    # ---------------------------------------------------------- hot reload --
    def swap_state(self, new_state: nn.Module, digest: str = "",
                   generation: int = -1) -> None:
        """Publish a new model; adopted atomically at the next batch
        boundary. `digest` and `generation` name the verified checkpoint the
        weights came from, so every Prediction attests which weights
        answered. Where graphs are captured, a model whose `state_dict`
        does not match the captured one (`state_compatible`) is refused
        here (ValueError): its weights cannot be copied in."""
        if self._graphs and not self.state_compatible(new_state):
            raise ValueError("swap_state: the new model's state_dict keys, "
                             "shapes or dtypes differ from the captured one")
        with self._swap_lock:
            self._pending_state = (new_state, digest or "fresh",
                                   int(generation))

    @property
    def params_digest(self) -> str:
        """sha256 of the checkpoint currently answering ("fresh" = init
        weights, nothing adopted yet)."""
        with self._swap_lock:
            return self._digest

    @property
    def params_generation(self) -> int:
        with self._swap_lock:
            return self._generation

    def state_compatible(self, new_state: nn.Module) -> bool:
        """Whether `new_state` can take over from the model serving now:
        the same `state_dict` keys, with the same shapes and dtypes."""
        cur, new = self._state.state_dict(), new_state.state_dict()
        if list(cur) != list(new):
            return False
        return all(cur[k].shape == new[k].shape and cur[k].dtype == new[k].dtype
                   for k in cur)

    def _adopt(self, new_state: nn.Module) -> None:
        """Make `new_state`'s weights the ones answering (at a batch
        boundary): copied into every replica's tensors where graphs read
        them, else the new model replaces the old."""
        if not self._graphs:
            self._set_replicas(new_state)
            return
        new = new_state.state_dict()

        def copy_into(i: int) -> None:
            with torch.no_grad():
                for k, t in self._replicas[i].state_dict().items():
                    t.copy_(new[k])
            torch.cuda.synchronize(self.devices[i])

        for f in [ex.submit(copy_into, i)
                  for i, ex in enumerate(self._executors)]:
            f.result()

    # ------------------------------------------------------------- serving --
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]  # unreachable: max_batch <= buckets[-1]

    def _collect(self, first_timeout_s: float):
        """Up to max_batch requests: block up to `first_timeout_s` for the
        first, then at most batch_timeout_ms past its arrival for company."""
        try:
            first = (self._q.get(timeout=first_timeout_s)
                     if first_timeout_s > 0 else self._q.get_nowait())
        except queue.Empty:
            return []
        reqs = [first]
        deadline = time.monotonic() + self.batch_timeout_s
        while len(reqs) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                reqs.append(self._q.get(timeout=remaining)
                            if remaining > 0 else self._q.get_nowait())
            except queue.Empty:
                break
        return reqs

    def _capture(self, i: int, bucket: int) -> _Graph:
        """Run device i's share of `bucket` once eagerly on zeros, then
        capture it; on device i's thread."""
        dev, model = self.devices[i], self._replicas[i]
        h = self.image_size
        static_in = torch.zeros((bucket // self.dp, h, h, 3), dtype=self._wire,
                                device=dev)
        # the eager pass builds and loads the kernel libraries, sets the
        # kernels' shared-memory attributes and looks up the tensor-map
        # encoder, creates this thread's cuBLAS/cuDNN handles and the
        # predict's constants: no such host work is first met inside the
        # capture
        self._predict(model, static_in)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        counters = launch_counters()
        with _COUNT_LOCK:
            before = [f.launches for f in counters]
            # "thread_local": an unsafe call on this thread still fails the
            # capture, while other threads (HTTP handlers, a watcher
            # building the next model, another engine of the process) go on
            # with their own device work on their own streams
            with torch.cuda.device(dev), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                scores, indices = self._predict(model, static_in)
            launches = tuple((f, f.launches - b)
                             for f, b in zip(counters, before)
                             if f.launches != b)
            for f, n in launches:  # the capture ran none of them
                f.launches -= n
        if self._sentinel is not None:
            self._sentinel.record(
                f"capture:b{bucket}@{dev}",
                f"{tuple(static_in.shape)} {self._wire}".replace("torch.", ""))
        return _Graph(graph, static_in, scores, indices, launches)

    def _run_share(self, i: int, bucket: int, rows: torch.Tensor,
                   model: nn.Module) -> Tuple[np.ndarray, np.ndarray]:
        """Device i's row block of a padded batch, on device i's thread: a
        graph replay on a card, the eager predict on the CPU."""
        if not self.graph_mode:
            scores, indices = self._predict(
                model, rows.to(self.devices[i], non_blocking=True))
            return scores.cpu().numpy(), indices.cpu().numpy()
        g = self._graphs.get((i, bucket))
        if g is None:
            g = self._graphs[(i, bucket)] = self._capture(i, bucket)
        g.static_in.copy_(rows, non_blocking=True)
        g.graph.replay()
        with _COUNT_LOCK:
            for f, n in g.launches:
                f.launches += n
        return g.scores.cpu().numpy(), g.indices.cpu().numpy()  # device sync

    def _forward(self, bucket: int, rows: Sequence[np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Fill the bucket's host buffer (real rows, then zero padding),
        hand each device its row block, and gather the (B, k) results in
        order."""
        host = self._host[bucket]
        buf = host.numpy()
        for i, row in enumerate(rows):
            buf[i] = row
        buf[len(rows):] = 0
        share = bucket // self.dp
        futures = [ex.submit(self._run_share, i, bucket,
                             host[i * share:(i + 1) * share],
                             self._replicas[i])
                   for i, ex in enumerate(self._executors)]
        parts = [f.result() for f in futures]
        if len(parts) == 1:
            return parts[0]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def _run_batch(self, reqs) -> None:
        with self._swap_lock:
            pending, self._pending_state = self._pending_state, None
        if pending is not None:
            self._adopt(pending[0])
        with self._swap_lock:
            if pending is not None:
                self._digest, self._generation = pending[1], pending[2]
            # read under the lock: the whole batch is answered by ONE
            # model even if a swap lands mid-flight
            digest, generation = self._digest, self._generation
        n = len(reqs)
        bucket = self._bucket_for(n)
        try:
            scores, indices = self._forward(bucket, [r.image for r in reqs])
        except Exception as e:
            # one bad batch must not kill the server: the requests carry the
            # failure, the batcher keeps serving
            self.metrics.record_error(n)
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        self.seen_buckets.add(bucket)
        now = time.monotonic()
        lats = []
        for i, r in enumerate(reqs):  # pad rows [n:] are discarded here
            lat_ms = (now - r.t_submit) * 1e3
            lats.append(lat_ms)
            r.future.set_result(Prediction(indices[i], scores[i], lat_ms,
                                           digest=digest,
                                           generation=generation))
        self.metrics.record_batch(bucket, n, lats)
        self._check_compile_sentinel()

    def _check_compile_sentinel(self) -> None:
        """Batch-boundary recompile check (requests already answered). A
        steady-state capture or build is counted + logged; under
        strict_compile the engine stops intake and raises — the batcher
        thread turns that into `fatal_error` for cli.serve (rc 2)."""
        if self.compile_sentinel is None:
            return
        from ..analysis.compile_sentinel import SteadyStateRecompile

        try:
            events = self.compile_sentinel.check(strict=self.strict_compile)
        except SteadyStateRecompile as e:
            self.metrics.record_recompile(self.compile_sentinel.violations)
            self.fatal_error = e
            self._closed = True  # stop intake; queued work still flushes
            raise
        if events:
            self.metrics.record_recompile(len(events))

    def process_once(self, timeout_s: float = 0.0) -> int:
        """Collect and run ONE micro-batch inline; returns requests served
        (0 = nothing queued). The in-process driving surface tests and
        `drain()` use — identical code path to the batcher thread."""
        reqs = self._collect(timeout_s)
        if not reqs:
            return 0
        self._run_batch(reqs)
        return len(reqs)

    def warmup(self) -> None:
        """Ready every bucket before traffic, so the first real request
        pays no one-time cost, and prove it with the compile sentinel:

        - **warm boot** (a valid AOT sidecar at `aot_dir`): the banked
          kernel libraries are placed where `ops/_build.py` finds them;
          the sentinel must count ZERO builds (`aot_hit`);
        - **cold boot**: on a card, exactly `len(buckets)` captures per
          serve device and at most one build per kernel library; then the
          libraries are banked into the sidecar for the next replica.

        On a card each bucket runs once eagerly and is then captured (one
        graph per bucket and device); on the CPU each runs once eagerly.
        The sentinel stays armed afterwards."""
        from ..analysis.compile_sentinel import CompileSentinel
        from . import aot

        sentinel = CompileSentinel(tag="serve")
        sentinel.arm()
        self._sentinel = sentinel
        t0 = time.perf_counter()
        try:
            loaded = None
            if self.aot_dir:
                loaded = aot.load_kernel_libraries(
                    self.aot_dir, self.devices, self.buckets, self._state)
            if self.graph_mode:
                # one device after the other: the captures' launch counts
                # are read off process-wide counters
                for i, ex in enumerate(self._executors):
                    for b in self.buckets:
                        ex.submit(self._warm_graph, i, b).result()
            else:
                for b in self.buckets:
                    self._forward(b, [])
            events = sentinel.take()
            builds = [e for e in events if e.name.startswith("build:")]
            captures = [e for e in events if e.name.startswith("capture:")]
            want = len(self.buckets) * self.dp if self.graph_mode else 0
            if len(captures) != want:
                raise RuntimeError(
                    f"serve warmup captured {len(captures)} graphs, expected "
                    f"exactly {want} (one per bucket {list(self.buckets)} and "
                    f"serve device) — the bucket→graph contract is broken")
            if len(builds) > len(aot.kernel_libraries()):
                raise RuntimeError(
                    f"serve warmup built {len(builds)} kernel libraries, more "
                    f"than the {len(aot.kernel_libraries())} there are: "
                    f"{[e.name for e in builds]}")
            if loaded is not None:
                if builds:
                    raise RuntimeError(
                        f"warm serve boot built {[e.name for e in builds]} — "
                        "the AOT sidecar promised zero builds")
                self.aot_hit = True
            elif self.aot_dir:
                aot.save_kernel_libraries(self.aot_dir, self.devices,
                                          self.buckets, self._state)
            self.boot = {"captures": len(captures), "builds": len(builds),
                         "aot_hit": self.aot_hit,
                         "warmup_s": time.perf_counter() - t0}
        except BaseException:
            # a failed warmup must not leak an armed sentinel
            sentinel.disarm()
            self._sentinel = None
            raise
        self.compile_sentinel = sentinel  # armed: steady state begins

    def _warm_graph(self, i: int, bucket: int) -> None:
        self._graphs[(i, bucket)] = self._capture(i, bucket)

    def drop_graph(self, bucket: int) -> None:
        """Forget `bucket`'s graphs (a test hook): its next batch captures
        anew — a steady-state capture, which the sentinel reports."""
        for i in range(self.dp):
            self._graphs.pop((i, bucket), None)

    # ------------------------------------------------------------ lifecycle --
    def start(self) -> "ServingEngine":
        if self._thread is not None:
            return self
        if self._closed:
            raise EngineClosed("cannot start a drained engine")

        def loop():
            from ..analysis.compile_sentinel import SteadyStateRecompile

            while not self._stop.is_set():
                try:
                    self.process_once(timeout_s=0.05)
                except SteadyStateRecompile:
                    # fatal_error is set and intake stopped; keep flushing
                    # the already-accepted queue so drain stays graceful
                    continue

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serve-batcher")
        self._thread.start()
        return self

    def drain(self, timeout_s: float = 30.0) -> None:
        """Graceful shutdown: stop intake, flush everything queued, join the
        batcher. Every request accepted before the drain gets its result."""
        from ..analysis.compile_sentinel import SteadyStateRecompile

        self._closed = True  # submit() now raises EngineClosed
        deadline = time.monotonic() + timeout_s
        if self._thread is not None:
            while not self._q.empty() and time.monotonic() < deadline:
                time.sleep(0.005)
            self._stop.set()
            self._thread.join(timeout=max(deadline - time.monotonic(), 0.1))
            self._thread = None
        # anything left (thread raced its stop flag, or engine never started)
        # flushes inline — same process_once the thread ran. A strict-mode
        # recompile during the flush must not break the rc-0 drain contract:
        # fatal_error is already recorded, the queued requests still answer
        try:
            while True:
                try:
                    if not self.process_once(timeout_s=0.0):
                        break
                except SteadyStateRecompile:
                    continue
        finally:
            self._release()

    def close(self) -> None:
        """Abort: stop the batcher and fail whatever is still queued
        (EngineClosed on the pending futures). `drain()` is the graceful
        sibling."""
        self._closed = True
        self._stop.set()
        try:
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None
            while True:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                if not req.future.done():
                    req.future.set_exception(EngineClosed("engine closed"))
        finally:
            self._release()

    def _release(self) -> None:
        """The device threads stopped and the sentinel disarmed (both
        idempotent)."""
        for ex in self._executors:
            ex.shutdown(wait=True)
        if self._sentinel is not None:
            self._sentinel.disarm()
