"""Micro-batching inference engine: bounded queue → deadline batcher →
bucket-padded predict on the device → per-request futures. The counterpart
of the JAX package's `serve/engine.py`, on one device.

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
- **uint8 wire.** Each bucket owns one pinned host buffer (on a CUDA
  device); a batch is written into it and copied to the device with
  `non_blocking=True`, and only the (B, k) scores and indices come back.
  Normalization runs on the device (`train/steps.py::device_input_epilogue`).
- **One device thread.** Warmup and every batch run their device work on
  the engine's single device thread: PyTorch keeps cuBLAS/cuDNN handles per
  thread, so a warmup run on another thread would leave the first served
  batch to create its own.
- **Atomic weight swap.** `swap_state()` publishes a new model which the
  batcher adopts at the next batch boundary — no batch mixes two models.
- **Graceful drain.** `drain()` stops intake (further submits raise
  `EngineClosed`), flushes everything already queued, and joins the
  batcher — the SIGTERM rc-0 contract of `cli/serve.py`.
- **Image intake.** `submit_image()` takes a decoded HWC uint8 RGB array
  (`serve/http.py` decodes request bodies) through the eval pipeline's
  val `Transform` (resize + center crop in numpy, uint8 wire) on the
  caller's thread, then `submit()`s it; it never touches the device, so
  HTTP handler threads transform in parallel.

The engine is fully exercisable in-process: construct it without `start()`
and drive `process_once()` directly — no thread.

Not ported yet (later slices): the serve mesh, the AOT executable sidecar
and the compile sentinel (eager PyTorch compiles nothing per bucket; the
port's counterpart of a warm boot is a CUDA graph per bucket).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn


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


class ServingEngine:
    """See module docstring. `predict` is
    `(model, images (B, H, W, 3) on the device) -> (scores (B, k),
    indices (B, k))`, built by `train/steps.py::make_topk_predict_step`."""

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
    ):
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets}")
        if max_batch > buckets[-1]:
            raise ValueError(
                f"max_batch={max_batch} exceeds largest bucket {buckets[-1]}")
        self._state = state
        self._predict = predict
        self.transform = transform  # val Transform for submit_image
        self.device = torch.device(device)
        self.image_size = int(image_size)
        self._np_dtype = np.uint8 if input_dtype == "uint8" else np.float32
        self.max_batch = int(max_batch)
        self.batch_timeout_s = float(batch_timeout_ms) / 1e3
        self.buckets = buckets
        # one host staging buffer per bucket, pinned when the device is a
        # card so the H2D copy can run asynchronously. Reuse is safe: every
        # batch ends in a D2H read of its result, which waits for its copy
        h = self.image_size
        pin = self.device.type == "cuda"
        wire = torch.uint8 if input_dtype == "uint8" else torch.float32
        self._host: Dict[int, torch.Tensor] = {
            b: torch.zeros((b, h, h, 3), dtype=wire, pin_memory=pin)
            for b in buckets}
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
        # the one thread that touches the device (its worker starts at the
        # first submit, not here)
        self._device = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="serve-device")

    @classmethod
    def from_config(cls, cfg, state, predict, device, metrics=None):
        """Engine wired from a Config tree (serve + data sections). The val
        transform of the data section's preset feeds `submit_image` (the
        JAX CLI's `build_transform(preset, train=False, ...)`); a dataset
        kind without one (synthetic) leaves it None."""
        from ..data.transforms import build_transform, preset_for_dataset

        preset = preset_for_dataset(cfg.data.dataset, cfg.data.transform)
        transform = None if preset is None else build_transform(
            preset, train=False, image_size=cfg.data.image_size,
            crop_size=cfg.data.train_crop_size, out_dtype=cfg.data.input_dtype)
        return cls(
            state, predict,
            image_size=cfg.data.image_size,
            device=device,
            input_dtype=cfg.data.input_dtype,
            max_batch=cfg.serve.max_batch,
            batch_timeout_ms=cfg.serve.batch_timeout_ms,
            queue_depth=cfg.serve.queue_depth,
            buckets=cfg.serve.resolve_buckets(),
            metrics=metrics,
            transform=transform,
        )

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
        answered."""
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

    def _forward(self, state: nn.Module, bucket: int,
                 rows: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """Fill the bucket's host buffer (real rows, then zero padding), copy
        it to the device, predict, and bring back only the (B, k) result —
        on the device thread."""
        def work():
            host = self._host[bucket]
            buf = host.numpy()
            for i, row in enumerate(rows):
                buf[i] = row
            buf[len(rows):] = 0
            scores, indices = self._predict(
                state, host.to(self.device, non_blocking=True))
            return scores.cpu().numpy(), indices.cpu().numpy()  # device sync

        return self._device.submit(work).result()

    def _run_batch(self, reqs) -> None:
        with self._swap_lock:
            if self._pending_state is not None:
                self._state, self._digest, self._generation = \
                    self._pending_state
                self._pending_state = None
            # capture under the lock: the whole batch is answered by ONE
            # model even if a swap lands mid-flight
            state, digest, generation = (self._state, self._digest,
                                         self._generation)
        n = len(reqs)
        bucket = self._bucket_for(n)
        try:
            scores, indices = self._forward(state, bucket,
                                            [r.image for r in reqs])
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
        """Run every bucket once on zeros before traffic, so the first real
        request pays no one-time cost (the kernel library's build and load,
        cuDNN's plan selection, the allocator's first blocks)."""
        for b in self.buckets:
            self._forward(self._state, b, [])

    # ------------------------------------------------------------ lifecycle --
    def start(self) -> "ServingEngine":
        if self._thread is not None:
            return self
        if self._closed:
            raise EngineClosed("cannot start a drained engine")

        def loop():
            while not self._stop.is_set():
                self.process_once(timeout_s=0.05)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serve-batcher")
        self._thread.start()
        return self

    def drain(self, timeout_s: float = 30.0) -> None:
        """Graceful shutdown: stop intake, flush everything queued, join the
        batcher. Every request accepted before the drain gets its result."""
        self._closed = True  # submit() now raises EngineClosed
        deadline = time.monotonic() + timeout_s
        if self._thread is not None:
            while not self._q.empty() and time.monotonic() < deadline:
                time.sleep(0.005)
            self._stop.set()
            self._thread.join(timeout=max(deadline - time.monotonic(), 0.1))
            self._thread = None
        # anything left (thread raced its stop flag, or engine never started)
        # flushes inline — same process_once the thread ran
        while self.process_once(timeout_s=0.0):
            pass
        self._device.shutdown(wait=True)

    def close(self) -> None:
        """Abort: stop the batcher and fail whatever is still queued
        (EngineClosed on the pending futures). `drain()` is the graceful
        sibling."""
        self._closed = True
        self._stop.set()
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
        self._device.shutdown(wait=True)
