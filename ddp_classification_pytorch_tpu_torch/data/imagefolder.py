"""ImageFolder data with the reference's per-class caps — the port's copy
of the JAX package's `data/imagefolder.py`.

`ImageFolderMy` (BASELINE/main.py:97-121, ARCFACE/arc_main.py:178-204,
CDR/main.py:69-94): class directories under `root`, label = sorted class
index, images capped per class, optionally only the first `max_classes`
class dirs. The scan runs once, in sorted order.

The dataset carries paths, labels and a `Transform`. The baseline and
clothing1m kinds are read a whole batch at a time by the native dataplane
(`data/native.py::NativeBatcher`); the others (cdr, cifar) take the item
route, as the JAX package's do: `__getitem__` decodes one file with
`data/native.py::decode_image` (the port imports no PIL) and applies the
transform.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .transforms import Transform

# what the JAX scan lists; the dataplane decodes JPEG and PNG, and names a
# BMP or WebP file it cannot decode (ROADMAP.md)
_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def scan_image_folder(root: str, imgs_per_class: int = 0,
                      max_classes: int = 0
                      ) -> Tuple[List[str], List[int], List[str]]:
    """→ (paths, labels, class_names). The caps are the reference's: glob
    order within a class, cap after the glob (BASELINE/main.py:105-113)."""
    class_dirs = sorted(d for d in glob.glob(os.path.join(root, "*"))
                        if os.path.isdir(d))
    if max_classes:
        class_dirs = class_dirs[:max_classes]
    paths: List[str] = []
    labels: List[int] = []
    names: List[str] = []
    for idx, cdir in enumerate(class_dirs):
        names.append(os.path.basename(cdir))
        files = sorted(f for f in glob.glob(os.path.join(cdir, "*"))
                       if f.lower().endswith(_EXTS))
        if imgs_per_class:
            files = files[:imgs_per_class]
        paths.extend(files)
        labels.extend([idx] * len(files))
    return paths, labels, names


@dataclasses.dataclass
class ImageFolderDataset:
    """Paths and labels of a scanned folder: batches from the native
    batcher, or items through `transform`."""

    paths: Sequence[str]
    labels: np.ndarray
    class_names: Sequence[str]
    transform: Optional[Transform] = None

    @classmethod
    def from_root(cls, root: str, imgs_per_class: int = 0,
                  max_classes: int = 0,
                  transform: Optional[Transform] = None
                  ) -> "ImageFolderDataset":
        paths, labels, names = scan_image_folder(root, imgs_per_class,
                                                 max_classes)
        if not paths:
            raise FileNotFoundError(f"no class dirs with images under {root!r}")
        return cls(paths, np.asarray(labels, np.int32), names, transform)

    def __getitem__(self, i: int, rng: Optional[np.random.Generator] = None):
        """(transformed image, label) of one file, decoded natively."""
        from .native import decode_image

        rng = rng or np.random.default_rng()
        return self.transform(decode_image(self.paths[i]), rng), int(self.labels[i])

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)
