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

The JAX package runs the geometric ops through PIL; here they are numpy
on decoded HWC uint8 RGB arrays with PIL's arithmetic:

- `resize` is PIL's `Image.resize(size, BILINEAR, box=...)`: a separable
  triangle filter whose support grows with the downscale factor,
  coefficients normalized and rounded to 22-bit fixed point, the
  horizontal pass first (rounded to uint8) and the vertical pass on it;
- `rotate` is PIL's `Image.rotate(angle, BILINEAR)`: about the centre,
  same size, zero fill, the reverse affine map of each output pixel's
  centre sampled bilinearly and truncated to uint8;
- `random_resized_crop` and `resize_center_crop` draw from the
  `np.random.Generator` in the JAX order, so one generator gives the same
  boxes on both sides.

On image folders the native dataplane (`data/native.py`) runs the
baseline and clothing1m kinds a whole batch at a time; the `cdr` and
`cifar` kinds, and the PLC dataset's items, take `Transform` on arrays
that `data/native.py::decode_image` decodes (the JAX package's PIL item
route).

Output wire format (`out_dtype`): "uint8" emits the raw HWC pixels, and
normalization and the train-time flip run on the device
(`train/steps.py::device_input_epilogue`); "float32" normalizes here and
flips here with the transform's rng.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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


# PIL's fixed point for 8-bit resampling (Resample.c: 32 − 8 − 2 bits)
_PRECISION_BITS = 22


def _resample_coeffs(in_size: int, in0: float, in1: float, out_size: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(first source index (out,), taps in the axis (out,), int64
    fixed-point weights (out, k)) of
    PIL's BILINEAR filter mapping [in0, in1) of an axis of `in_size`
    pixels onto `out_size` pixels: a triangle of support max(scale, 1)
    around each output pixel's centre, clipped to the axis, normalized,
    then rounded half away from zero to 22 bits."""
    scale = (in1 - in0) / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support is 1 at scale 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = in0 + (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero, as astype does
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    w = 1.0 - np.abs(((xmin[:, None] + taps) - center[:, None] + 0.5)
                     / filterscale)
    w = np.where((taps < xmax[:, None]) & (w > 0.0), w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # C's order of the sum, tap by tap
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = (w * (1 << _PRECISION_BITS) + 0.5).astype(np.int64)
    return xmin, xmax, fixed


def _resample_axis(img: np.ndarray, axis: int, xmin: np.ndarray,
                   fixed: np.ndarray) -> np.ndarray:
    """One pass of PIL's 8-bit resampling along `axis` (0 rows, 1 columns)
    of a HWC uint8 image: integer sums from a half-unit start, shifted
    down and clipped to uint8."""
    n = img.shape[axis]
    idx = np.minimum(xmin[:, None] + np.arange(fixed.shape[1]), n - 1)
    src = img.astype(np.int64)
    acc = np.full((*fixed.shape[:1], img.shape[1 - axis], img.shape[2]),
                  1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(fixed.shape[1]):
        taps = np.take(src, idx[:, j], axis=axis)
        if axis == 1:
            taps = taps.transpose(1, 0, 2)
        acc += taps * fixed[:, j, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return out if axis == 0 else out.transpose(1, 0, 2)


def resize(img: np.ndarray, size: Tuple[int, int],
           box: Optional[Tuple[float, float, float, float]] = None
           ) -> np.ndarray:
    """PIL's `Image.resize(size, BILINEAR, box)` of a HWC uint8 image;
    `size` is (width, height) and `box` (x0, y0, x1, y1) in source
    pixels, as PIL takes them."""
    h, w = img.shape[:2]
    out_w, out_h = size
    if box is None:
        box = (0, 0, w, h)
    if (out_w, out_h) == (w, h) and tuple(box) == (0, 0, w, h):
        return img.copy()
    need_h = out_w != w or box[0] != 0 or box[2] != out_w
    need_v = out_h != h or box[1] != 0 or box[3] != out_h
    xmin, _, kx = _resample_coeffs(w, box[0], box[2], out_w)
    ymin, ytaps, ky = _resample_coeffs(h, box[1], box[3], out_h)
    out = img
    if need_h:
        # only the rows the vertical pass reads (PIL's ybox_first/last)
        first, last = int(ymin[0]), int(ymin[-1] + ytaps[-1])
        out = _resample_axis(img[first:last], 1, xmin, kx)
        ymin = ymin - first
    if need_v:
        out = _resample_axis(out, 0, ymin, ky)
    return np.ascontiguousarray(out)


def random_resized_crop(img: np.ndarray, rng: np.random.Generator, size: int,
                        scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)
                        ) -> np.ndarray:
    """torchvision RandomResizedCrop semantics (area-scale and log-ratio
    draws, 10 tries, then the centre square), the JAX function's draws in
    its order, resized with PIL's BILINEAR (`crop_box` gives the box)."""
    return resize(img, (size, size), box=crop_box(img.shape[1], img.shape[0],
                                                  rng, scale, ratio))


def crop_box(w: int, h: int, rng: np.random.Generator,
             scale: Tuple[float, float] = (0.08, 1.0),
             ratio: Tuple[float, float] = (3 / 4, 4 / 3)
             ) -> Tuple[int, int, int, int]:
    """The (x0, y0, x1, y1) box `random_resized_crop` resizes from."""
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = int(rng.integers(0, w - cw + 1))
            y = int(rng.integers(0, h - ch + 1))
            return x, y, x + cw, y + ch
    side = min(w, h)
    x, y = (w - side) // 2, (h - side) // 2
    return x, y, x + side, y + side


def resize_center_crop(img: np.ndarray, resize_to: int, crop: int
                       ) -> np.ndarray:
    """Resize the short side to `resize_to` (the long side by int()),
    then the centre `crop` square (JAX `transforms.py:83-91`)."""
    h, w = img.shape[:2]
    if w < h:
        nw, nh = resize_to, int(h * resize_to / w)
    else:
        nw, nh = int(w * resize_to / h), resize_to
    img = resize(img, (nw, nh))
    x, y = (nw - crop) // 2, (nh - crop) // 2
    return np.ascontiguousarray(img[y: y + crop, x: x + crop])


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """PIL's `Image.rotate(angle, BILINEAR)` of a HWC uint8 image: counter
    clockwise about the centre, same size, zero outside the source."""
    angle = angle % 360.0
    h, w = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    cx, cy = w / 2, h / 2
    a = -math.radians(angle)
    m = [round(math.cos(a), 15), round(math.sin(a), 15), 0.0,
         round(-math.sin(a), 15), round(math.cos(a), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy + m[2] + cx
    m[5] = m[3] * -cx + m[4] * -cy + m[5] + cy
    # the reverse map of each output pixel's centre (Geometry.c)
    xo = np.arange(w) + 0.5
    yo = (np.arange(h) + 0.5)[:, None]
    xin = m[0] * xo + m[1] * yo + m[2]
    yin = m[3] * xo + m[4] * yo + m[5]
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x0, y0 = np.floor(xin).astype(np.int64), np.floor(yin).astype(np.int64)
    dx, dy = (xin - x0)[..., None], (yin - y0)[..., None]
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    src = img.astype(np.int64)
    row = src[np.clip(y0, 0, h - 1)[..., None], np.stack([xa, xb], -1)]
    v1 = row[..., 0, :] + (row[..., 1, :] - row[..., 0, :]) * dx
    y1 = y0 + 1
    row = src[np.clip(y1, 0, h - 1)[..., None], np.stack([xa, xb], -1)]
    v2 = row[..., 0, :] + (row[..., 1, :] - row[..., 0, :]) * dx
    v2 = np.where(((y1 >= 0) & (y1 < h))[..., None], v2, v1)
    v = v1 + (v2 - v1) * dy
    out = np.where(inside[..., None], v.astype(np.uint8), 0)
    return np.ascontiguousarray(out.astype(np.uint8))


@dataclasses.dataclass
class Transform:
    """A train or eval transform over a HWC uint8 RGB array — the JAX
    `Transform` (`transforms.py:115-147` there) with the PIL ops above.

    The rng draws are the JAX `Transform`'s, in its order (the crop box or
    the rotation angle, then the host flip on the float32 wire only), so
    one `np.random.Generator` gives the same pixels on both sides."""

    kind: str
    train: bool
    crop_size: int
    out_size: int
    out_dtype: str = "float32"

    def __call__(self, arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        emit_uint8 = self.out_dtype == "uint8"
        # the uint8 wire flips on the device (device_input_epilogue)
        host_flip = self.train and not emit_uint8
        arr = np.asarray(arr, np.uint8)
        if self.kind == "cifar":
            if self.train:
                arr = random_crop_padded(arr, rng, self.out_size, 4)
                if host_flip and rng.uniform() < 0.5:
                    arr = arr[:, ::-1]
        elif self.train:
            if self.kind == "cdr":
                # CDR/main.py:113-119: rotation ±15°, flip, resize, centre
                arr = rotate(arr, float(rng.uniform(-15, 15)))
                arr = resize_center_crop(arr, self.crop_size, self.out_size)
            elif self.kind == "clothing1m":
                arr = random_resized_crop(arr, rng, self.out_size,
                                          scale=(0.08, 1.0))
            else:  # baseline (BASELINE/main.py:60-63): RRC scale .8-1
                arr = random_resized_crop(arr, rng, self.out_size,
                                          scale=(0.8, 1.0))
            if host_flip and rng.uniform() < 0.5:
                arr = arr[:, ::-1]
        else:
            arr = resize_center_crop(arr, self.crop_size, self.out_size)
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
