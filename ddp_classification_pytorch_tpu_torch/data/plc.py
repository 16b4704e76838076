"""PLC's (Clothing1M-style) annotation-file dataset and label tooling — the
port's copy of the JAX package's `data/plc.py`.

Parity with `PLC/FolderDataset.py`:
- `FolderDataset` (:9-82): key-list and label files per split
  (`annotations/{split}_key_list.txt`, `noisy_label_kv.txt`,
  `clean_label_kv.txt`), an optional per-class subsample of `cls_size`
  by a seeded permutation (:43-50), `__getitem__` → (image, label, index)
  (:56-75) so correction loops can address samples, and in-place label
  mutation `update_corrupted_label` (:80-82);
- `build_annotations` derives the key lists from a folder tree, and
  `check_bad_images` lists the files that do not decode.

Items decode with `data/native.py::decode_image` (the JAX package's
`Image.open(...).convert("RGB")`) and go through the numpy `Transform`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .transforms import Transform


def _read_kv(path: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = int(parts[1])
    return out


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


@dataclasses.dataclass
class PLCDataset:
    """Split dataset over an annotation dir (PLC/FolderDataset.py:9-54)."""

    data_root: str
    keys: List[str]
    labels: np.ndarray  # mutable — label-correction target
    clean_labels: Optional[np.ndarray]
    transform: Transform

    @classmethod
    def from_annotations(
        cls,
        data_root: str,
        split: str,
        transform: Transform,
        cls_size: int = 0,
        num_classes: int = 14,
        seed: int = 123,
    ) -> "PLCDataset":
        ann = os.path.join(data_root, "annotations")
        keys = _read_list(os.path.join(ann, f"{split}_key_list.txt"))
        noisy = _read_kv(os.path.join(ann, "noisy_label_kv.txt"))
        clean_path = os.path.join(ann, "clean_label_kv.txt")
        clean = _read_kv(clean_path) if os.path.exists(clean_path) else {}

        # train labels come from the noisy file; val/test prefer clean
        # (FolderDataset.py:20-38)
        src = noisy if split == "train" else (clean or noisy)
        keys = [k for k in keys if k in src]
        labels = np.asarray([src[k] for k in keys], np.int64)

        if cls_size and split == "train":
            # per-class subsample with np.random.permutation (:43-50)
            rng = np.random.RandomState(seed)
            keep: List[int] = []
            for c in range(num_classes):
                idx = np.nonzero(labels == c)[0]
                idx = rng.permutation(idx)[:cls_size]
                keep.extend(idx.tolist())
            keep_arr = np.asarray(sorted(keep), np.int64)
            keys = [keys[i] for i in keep_arr]
            labels = labels[keep_arr]

        clean_arr = (
            np.asarray([clean.get(k, -1) for k in keys], np.int64) if clean else None
        )
        return cls(data_root, keys, labels.copy(), clean_arr, transform)

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, i: int, rng: Optional[np.random.Generator] = None):
        """→ (image, label, index): the index lets correction loops
        address samples (FolderDataset.py:56-75). The image is the
        transform's output (uint8 HWC on the uint8 wire, normalized
        float32 on the float32 wire)."""
        from .native import decode_image

        rng = rng or np.random.default_rng()
        img = decode_image(os.path.join(self.data_root, self.keys[i]))
        return self.transform(img, rng), int(self.labels[i]), i

    def update_corrupted_label(self, new_labels: Sequence[int]) -> None:
        """In-place label replacement for correction loops
        (FolderDataset.py:80-82)."""
        new = np.asarray(new_labels, np.int64)
        if new.shape != self.labels.shape:
            raise ValueError(f"label shape {new.shape} != {self.labels.shape}")
        self.labels[:] = new


def build_annotations(
    image_root: str,
    out_dir: str,
    splits: Tuple[str, ...] = ("train", "val", "test"),
    val_frac: float = 0.1,
    test_frac: float = 0.1,
    seed: int = 0,
) -> None:
    """The annotation builder (for the hardcoded-path one-offs at
    PLC/FolderDataset.py:85-152): scans `image_root/<class>/<img>` and
    writes the key lists and the label files (labels = folder index)."""
    from .imagefolder import scan_image_folder

    paths, labels, _ = scan_image_folder(image_root)
    keys = [os.path.relpath(p, image_root) for p in paths]
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(keys))
    n_val = int(len(keys) * val_frac)
    n_test = int(len(keys) * test_frac)
    split_idx = {
        "val": order[:n_val],
        "test": order[n_val : n_val + n_test],
        "train": order[n_val + n_test :],
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "noisy_label_kv.txt"), "w") as f:
        for k, lb in zip(keys, labels):
            f.write(f"{k} {lb}\n")
    with open(os.path.join(out_dir, "clean_label_kv.txt"), "w") as f:
        for k, lb in zip(keys, labels):
            f.write(f"{k} {lb}\n")
    for split in splits:
        with open(os.path.join(out_dir, f"{split}_key_list.txt"), "w") as f:
            for i in split_idx.get(split, []):
                f.write(keys[int(i)] + "\n")


def check_bad_images(
    image_root: str,
    keys: Optional[Sequence[str]] = None,
    num_workers: int = 8,
) -> List[str]:
    """The files under `image_root` that do not decode to RGB.

    The reference's `check_bad_image` (PLC/FolderDataset.py:156-184) walks
    a hardcoded absolute path and prints offenders; this takes the root
    (and optionally an explicit key list, e.g. a split's `*_key_list.txt`
    contents), decodes each file with `data/native.py::decode_image` and
    returns the relative paths that fail, in key order. The decodes run
    on a thread pool (the C call drops the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from .native import DataplaneDecodeError, decode_image, get_decoder

    if keys is None:
        from .imagefolder import scan_image_folder

        paths, _, _ = scan_image_folder(image_root)
        keys = [os.path.relpath(p, image_root) for p in paths]
    get_decoder()  # a build failure is DataplaneUnavailable, not a bad file

    def probe(key: str) -> Optional[str]:
        try:
            decode_image(os.path.join(image_root, key))
            return None
        except DataplaneDecodeError:
            return key

    with ThreadPoolExecutor(max(num_workers, 1)) as ex:
        return [k for k in ex.map(probe, keys) if k is not None]
