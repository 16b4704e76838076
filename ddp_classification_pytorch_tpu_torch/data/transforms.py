"""Host-side image transforms — the port's copy of the JAX package's
`data/transforms.py`, in numpy only (the port imports no PIL).

Presets (the reference's torchvision pipelines):
- baseline train: RandomResizedCrop(256, scale 0.8-1.0) + flip + normalize
  (BASELINE/main.py:58-68); val: Resize(256) + CenterCrop(224)
  (BASELINE/main.py:69-76);
- cdr train: RandomRotation(±15°) + flip + resize + center crop
  (CDR/main.py:112-121);
- cifar train: RandomCrop(32, padding=4) + flip (NESTED/train.py:40-44);
- clothing1m train: RandomResizedCrop(224) + flip (NESTED/train.py:55-59).

What runs where in the port: on image folders the native dataplane
(`data/native.py`) does the baseline and clothing1m crops; the `cifar`
kind runs here on HWC uint8 arrays (CIFAR's pickles hold raw pixels). The
PIL geometric ops (RandomResizedCrop and resize-center-crop in Python, and
cdr's rotation) are not ported: a `Transform` of another kind refuses to
run.

Output wire format (`out_dtype`): "uint8" emits the raw HWC pixels, and
normalization and the train-time flip run on the device
(`train/steps.py::device_input_epilogue`); "float32" normalizes here and
flips here with the transform's rng.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

INPUT_DTYPES = ("uint8", "float32")
TRANSFORM_PRESETS = ("baseline", "cdr", "cifar", "clothing1m")


def preset_for_dataset(dataset: str, transform: str) -> Optional[str]:
    """Transform preset a dataset kind uses, or None when it has no image
    transform (synthetic). Shared by `train/loop.py::build_datasets` and
    the train step's device-flip gate: a preset means the train pipeline
    flips."""
    return {"imagefolder": transform, "plc": "clothing1m",
            "cifar10": "cifar", "cifar100": "cifar"}.get(dataset)


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 HWC → float32 HWC normalized."""
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def random_crop_padded(img: np.ndarray, rng: np.random.Generator, size: int,
                       pad: int) -> np.ndarray:
    """CIFAR RandomCrop(size, padding=pad) on a HWC uint8 array."""
    padded = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="constant")
    y = int(rng.integers(0, 2 * pad + 1))
    x = int(rng.integers(0, 2 * pad + 1))
    return padded[y: y + size, x: x + size]


@dataclasses.dataclass
class Transform:
    """A train or eval transform over a HWC uint8 RGB array.

    The rng draws are the JAX `Transform`'s, in its order: crop y, crop x,
    then the host flip on the float32 wire only, so one
    `np.random.Generator` gives the same pixels on both sides."""

    kind: str
    train: bool
    crop_size: int
    out_size: int
    out_dtype: str = "float32"

    def __call__(self, arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.kind != "cifar":
            raise ValueError(
                f"transform {self.kind!r} on a Python-decoded image is not "
                "yet ported to the torch package (its geometric ops are "
                "PIL's); image folders go through the native dataplane")
        emit_uint8 = self.out_dtype == "uint8"
        arr = np.asarray(arr, np.uint8)
        if self.train:
            arr = random_crop_padded(arr, rng, self.out_size, 4)
            # the uint8 wire flips on the device (device_input_epilogue)
            if not emit_uint8 and rng.uniform() < 0.5:
                arr = arr[:, ::-1]
        arr = np.ascontiguousarray(arr)
        return arr if emit_uint8 else normalize(arr)


def build_transform(preset: str, train: bool, image_size: int = 224,
                    crop_size: int = 256,
                    out_dtype: str = "float32") -> Transform:
    if preset not in TRANSFORM_PRESETS:
        raise ValueError(f"unknown transform preset {preset!r}")
    if out_dtype not in INPUT_DTYPES:
        raise ValueError(
            f"unknown input dtype {out_dtype!r}; one of {INPUT_DTYPES}")
    if preset == "cifar":
        return Transform(preset, train, crop_size=image_size,
                         out_size=image_size, out_dtype=out_dtype)
    # the reference trains at RandomResizedCrop(256) but evaluates at
    # CenterCrop(224) (BASELINE/main.py:61,73-74), a quirk kept on both
    # sides: the train output size is crop_size for baseline
    out = crop_size if (train and preset == "baseline") else image_size
    return Transform(preset, train, crop_size=crop_size, out_size=out,
                     out_dtype=out_dtype)
