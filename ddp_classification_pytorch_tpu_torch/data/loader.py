"""Batch loader — the JAX package's `data/loader.py::ShardedLoader`: the
same epoch permutation, padded by wrapping to a multiple of `num_hosts ×
batch_size` and sliced per host (`shard_indices_for_host`; a host here is
a rank of the process group, so every rank takes the same number of
steps), `set_epoch`, `__len__`, the eval `valid_mask` that zeroes the wrap
padding on each rank (`loader.py:35-72,173` there), item transforms on a
thread pool of `num_workers`, a producer thread that keeps `prefetch`
batches ready in a bounded queue, and the `batcher` hook through which
the native dataplane assembles whole batches.

With `num_workers=0` every batch is assembled on the calling thread; any
other count gives the same batches in the same order.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]


def shard_indices_for_host(n: int, epoch: int, seed: int, batch_size: int,
                           shuffle: bool = True, host_id: int = 0,
                           num_hosts: int = 1,
                           drop_last: bool = False) -> np.ndarray:
    """Deterministic per-host index shard for one epoch: the permutation of
    seed ⊕ epoch, padded by wrapping to a multiple of num_hosts·batch_size
    (DistributedSampler's pad-by-repeat), then the host's contiguous
    slice."""
    idx = np.arange(n, dtype=np.int64)
    if shuffle:
        rng = np.random.default_rng(
            np.uint32(seed) ^ np.uint32((epoch * 0x9E3779B9) & 0xFFFFFFFF))
        rng.shuffle(idx)
    chunk = num_hosts * batch_size
    if drop_last:
        idx = idx[: (n // chunk) * chunk]
    elif n % chunk:
        idx = np.resize(idx, ((n // chunk) + 1) * chunk)
    per_host = len(idx) // num_hosts
    return idx[host_id * per_host: (host_id + 1) * per_host]


class Loader:
    """Iterates (images, labels) numpy batches: images keep the dataset's
    dtype (uint8 on the default wire), labels int32. `dataset` supports
    `__len__` and, without a `batcher`, `__getitem__(i, rng)` → (HWC
    image, int label[, index]). `batcher(indices, epoch, batch_idx)` → (images,
    labels) replaces the per-item path (`data/native.py`). `host_id` and
    `num_hosts` are this process's rank and the world size: the loader
    yields that rank's shard."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 999, drop_last: bool = False,
                 num_workers: int = 0, prefetch: int = 2,
                 batcher: Optional[Callable[[np.ndarray, int, int], Batch]] = None,
                 host_id: int = 0, num_hosts: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.host_id, self.num_hosts = host_id, num_hosts
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 0)
        self.prefetch = max(prefetch, 1)
        self.batcher = batcher
        self.epoch = 0
        self._pool: Optional[ThreadPoolExecutor] = None

    def close(self) -> None:
        """Release the worker threads (idempotent; the next pass starts a
        new pool)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):
        self.close()

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle hook (reference sampler.set_epoch, BASELINE/main.py:269)."""
        self.epoch = epoch

    def _per_host_len(self) -> int:
        """This host's padded epoch length (`shard_indices_for_host`'s,
        without the permutation)."""
        n, chunk = len(self.dataset), self.num_hosts * self.batch_size
        if self.drop_last:
            return (n // chunk) * chunk // self.num_hosts
        return ((n + chunk - 1) // chunk) * chunk // self.num_hosts

    def __len__(self) -> int:
        return self._per_host_len() // self.batch_size

    def valid_mask(self, batch_idx: int) -> np.ndarray:
        """(batch_size,) 1.0 where the row is a real sample, 0.0 where it is
        wrap-padding (ordered loaders only). Index arithmetic only, so a
        prefetcher's stager thread may call it."""
        if self.shuffle:
            raise ValueError("valid_mask is defined for ordered loaders")
        start = self.host_id * self._per_host_len() + batch_idx * self.batch_size
        pos = start + np.arange(self.batch_size)
        return (pos < len(self.dataset)).astype(np.float32)

    def _load_batch(self, batch_idx: int, indices: np.ndarray) -> Batch:
        if self.batcher is not None:
            return self.batcher(indices, self.epoch, batch_idx)
        epoch = self.epoch

        def load(j_and_i):
            j, i = j_and_i
            rng = np.random.default_rng((self.seed, epoch, int(i), j))
            return self.dataset.__getitem__(int(i), rng)

        if self.num_workers > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.num_workers)
            items = list(self._pool.map(load, enumerate(indices)))
        else:
            items = [load(ji) for ji in enumerate(indices)]
        # an item may carry its index after the label (the PLC dataset's
        # (image, label, index)); the loader knows the index already
        images = np.stack([it[0] for it in items])
        labels = np.asarray([it[1] for it in items], np.int32)
        return images, labels

    def _batches(self) -> Tuple[np.ndarray, int]:
        indices = shard_indices_for_host(
            len(self.dataset), self.epoch, self.seed, self.batch_size,
            self.shuffle, self.host_id, self.num_hosts, self.drop_last)
        return indices, len(indices) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        indices, n_batches = self._batches()
        b = self.batch_size
        if self.num_workers == 0:
            for k in range(n_batches):
                yield self._load_batch(k, indices[k * b: (k + 1) * b])
            return
        if n_batches == 0:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        error: list = []

        def put_or_stop(item) -> bool:
            """Bounded put that gives up when the consumer has gone: a
            producer never blocks for good on a full queue at teardown."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for k in range(n_batches):
                    if stop.is_set():
                        return
                    batch = self._load_batch(k, indices[k * b: (k + 1) * b])
                    if not put_or_stop(batch):
                        return
            except BaseException as e:  # re-raised at the iteration site
                error.append(e)
            finally:
                put_or_stop(None)

        t = threading.Thread(target=producer, daemon=True, name="loader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
            if error:
                # a silently short epoch would corrupt training unseen
                raise error[0]
        finally:
            stop.set()
            while True:  # drain, so a producer blocked on put can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10.0)
