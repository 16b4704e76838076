"""CIFAR-10/100 from local files — the port's copy of the JAX package's
`data/cifar.py` (no download). Reads the standard `cifar-10-batches-py` /
`cifar-100-python` pickle layouts; point `DataConfig.train_dir` at the
extracted directory or its parent.

The pickles hold raw uint8 pixels, so no decoder is needed: the JAX
side's `Image.fromarray` → `np.asarray` round trip is the identity on
uint8 RGB, and the port hands the array to the transform directly.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

from .transforms import Transform


def _load_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _load_cifar10(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for n in names:
        d = _load_pickle(os.path.join(root, n))
        xs.append(np.asarray(d["data"], np.uint8))
        ys.extend(d["labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.asarray(ys, np.int32)


def _load_cifar100(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    d = _load_pickle(os.path.join(root, "train" if train else "test"))
    x = np.asarray(d["data"], np.uint8).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.asarray(d["fine_labels"], np.int32)


def _find_root(root: str, kind: str) -> str:
    sub = "cifar-10-batches-py" if kind == "cifar10" else "cifar-100-python"
    for cand in (root, os.path.join(root, sub)):
        probe = "data_batch_1" if kind == "cifar10" else "train"
        if os.path.exists(os.path.join(cand, probe)):
            return cand
    raise FileNotFoundError(
        f"no {kind} pickle files under {root!r} (expected {sub}/ layout; "
        "this environment cannot download datasets)")


class CIFARDataset:
    """In-memory CIFAR with the loader's `__getitem__(i, rng)` protocol."""

    def __init__(self, root: str, train: bool, transform: Transform,
                 kind: str = "cifar10"):
        loader = _load_cifar10 if kind == "cifar10" else _load_cifar100
        self.images, self.labels = loader(_find_root(root, kind), train)
        self.transform = transform
        self.num_classes = 10 if kind == "cifar10" else 100
        self.class_names = [str(i) for i in range(self.num_classes)]

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        return self.transform(self.images[i], rng), int(self.labels[i])
