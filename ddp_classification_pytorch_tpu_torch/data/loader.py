"""Single-process batch loader — the port's part of the JAX package's
`data/loader.py`: the same epoch permutation and wrap-padding
(`shard_indices_for_host` with one host), `set_epoch`, `__len__` and the
eval `valid_mask`. Batches are assembled on the calling thread; worker
threads, the native batcher and device-side prefetch are not ported yet
(ROADMAP.md)."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def shard_indices_for_host(n: int, epoch: int, seed: int, batch_size: int,
                           shuffle: bool = True, host_id: int = 0,
                           num_hosts: int = 1,
                           drop_last: bool = False) -> np.ndarray:
    """Deterministic per-host index shard for one epoch: the permutation of
    seed ⊕ epoch, padded by wrapping to a multiple of num_hosts·batch_size
    (DistributedSampler's pad-by-repeat), then the host's contiguous
    slice. The port runs one host: host_id 0 of 1."""
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
    `__len__` and `__getitem__(i, rng)` → (HWC image, int label)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 999, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle hook (reference sampler.set_epoch, BASELINE/main.py:269)."""
        self.epoch = epoch

    def _padded_len(self) -> int:
        n, b = len(self.dataset), self.batch_size
        if self.drop_last:
            return (n // b) * b
        return ((n + b - 1) // b) * b

    def __len__(self) -> int:
        return self._padded_len() // self.batch_size

    def valid_mask(self, batch_idx: int) -> np.ndarray:
        """(batch_size,) 1.0 where the row is a real sample, 0.0 where it is
        wrap-padding (ordered loaders only)."""
        assert not self.shuffle, "valid_mask is defined for ordered loaders"
        pos = batch_idx * self.batch_size + np.arange(self.batch_size)
        return (pos < len(self.dataset)).astype(np.float32)

    def _load_batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        items = [self.dataset.__getitem__(
            int(i), np.random.default_rng((self.seed, self.epoch, int(i), j)))
            for j, i in enumerate(indices)]
        images = np.stack([im for im, _ in items])
        labels = np.asarray([lb for _, lb in items], np.int32)
        return images, labels

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        indices = shard_indices_for_host(
            len(self.dataset), self.epoch, self.seed, self.batch_size,
            self.shuffle, drop_last=self.drop_last)
        for b in range(len(indices) // self.batch_size):
            yield self._load_batch(
                indices[b * self.batch_size: (b + 1) * self.batch_size])
