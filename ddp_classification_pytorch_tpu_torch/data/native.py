"""The port's ctypes binding of the native C++ dataplane
(`native/dataplane.cpp`, shared with the JAX package and compiled from the
same source): libjpeg/libpng decode (dispatch on magic bytes) →
torchvision-semantics RandomResizedCrop or resize + center crop → flip →
normalize, one C call per batch fanned over native threads. ctypes drops
the GIL for the call, so the loader's threads decode while the step loop
runs Python.

The port imports no PIL, so this is its only decoder:

- The library is built at first use, never at import, with
  `g++ -O3 -std=c++17 -shared -fPIC ... -ljpeg -lpng -lpthread`; if that
  fails, the JPEG-only `-DDP_NO_PNG` build (the JAX binding's order). It
  lands in `data/build/` (git-ignored), named by a hash of the flags and
  the source, written under a name private to the process and then
  `os.replace`d into place (two processes may build at once).
- If neither build succeeds (or loads), `DataplaneUnavailable` carries the
  compiler's stderr and what `probe_toolchain` found missing; the train
  CLI maps it to rc 2. Nothing falls back.
- A slot the C side cannot decode comes back zero-filled, and the C side
  does not say which. Where the JAX binding retries such slots through
  PIL, `NativeBatcher` raises `DataplaneDecodeError` naming the file
  (`dp_probe_image` tells a broken file from a black image).

`decode_image` is the item route's decoder (the JAX package's
`Image.open(...).convert("RGB")`): a second library, built the same way
from `data/csrc/decode.cpp`, which includes `native/dataplane.cpp`
unchanged and exports its decoder alone. A failed build of it is the
same `DataplaneUnavailable`; there is no PIL fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .transforms import IMAGENET_MEAN, IMAGENET_STD, build_transform

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "dataplane.cpp")
_HERE = os.path.dirname(os.path.abspath(__file__))
DECODE_SOURCE = os.path.join(_HERE, "csrc", "decode.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# full build first, then JPEG-only (PNGs then fail their slot, loudly)
LINK_VARIANTS = (("-ljpeg", "-lpng", "-lpthread"),
                 ("-DDP_NO_PNG", "-ljpeg", "-lpthread"))


class DataplaneUnavailable(RuntimeError):
    """g++, libjpeg or its header is missing, or the build failed."""


class DataplaneDecodeError(RuntimeError):
    """A file in a batch could not be decoded by the dataplane."""


def library_path(variant: Sequence[str]) -> str:
    """Where the build of the source with these link flags lives."""
    h = hashlib.sha256(" ".join((*CXX_FLAGS, *variant)).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdataplane-{h.hexdigest()[:16]}.so")


def decoder_path(variant: Sequence[str]) -> str:
    """Where the decoder's build with these link flags lives (named by
    both sources: the decoder includes the dataplane's)."""
    h = hashlib.sha256(" ".join((*CXX_FLAGS, "-I", *variant)).encode())
    for path in (DECODE_SOURCE, SOURCE):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdecode-{h.hexdigest()[:16]}.so")


def _compile(variant: Sequence[str], out: Optional[str] = None,
             source: str = SOURCE, extra: Sequence[str] = ()
             ) -> Tuple[Optional[str], str]:
    """(library path, "") on success, (None, compiler output) on failure."""
    out = out or library_path(variant)
    if os.path.isfile(out):
        return out, ""
    gxx = shutil.which("g++")
    if gxx is None:
        return None, "g++ not found on PATH"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [gxx, *CXX_FLAGS, *extra, "-o", tmp, source, *variant]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None, f"{' '.join(cmd)}\n{proc.stderr}"
    os.replace(tmp, out)
    return out, ""


def probe_toolchain() -> Dict[str, object]:
    """What the dataplane's build needs, as found on this machine: the
    compiler, the two headers and the two libraries (each tried with a
    one-line program)."""
    gxx = shutil.which("g++")
    found: Dict[str, object] = {"g++": gxx}
    checks = (("jpeglib.h", "#include <cstdio>\n#include <jpeglib.h>\n", ()),
              ("png.h", "#include <png.h>\n", ()),
              ("-ljpeg", "", ("-ljpeg",)), ("-lpng", "", ("-lpng",)))
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cpp")
        for name, include, libs in checks:
            if gxx is None:
                found[name] = False
                continue
            with open(src, "w") as f:
                f.write(include + "int main() { return 0; }\n")
            proc = subprocess.run(
                [gxx, src, "-o", os.path.join(tmp, "probe"), *libs],
                capture_output=True, text=True, timeout=120)
            found[name] = proc.returncode == 0
    return found


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_decoder: Optional[ctypes.CDLL] = None


def _build_and_load(what: str, build) -> ctypes.CDLL:
    """The first of `LINK_VARIANTS` that `build(variant)` compiles and that
    loads; `DataplaneUnavailable` naming `what` when none does."""
    errors: List[str] = []
    for variant in LINK_VARIANTS:
        path, err = build(variant)
        if path is not None:
            try:  # a build copied from another machine may not load
                return ctypes.CDLL(path)
            except OSError as e:
                err = f"{path} does not load: {e}"
        errors.append(err)
    missing = ", ".join(k for k, v in probe_toolchain().items() if not v)
    raise DataplaneUnavailable(
        f"{what} does not build on this machine (missing: "
        f"{missing or 'nothing probed'}):\n" + "\n".join(errors))


def get_lib() -> ctypes.CDLL:
    """The loaded dataplane, building it on first use; raises
    `DataplaneUnavailable` when no build succeeds."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _build_and_load("the native dataplane (native/dataplane.cpp)",
                              _compile)
        lib.dp_has_png.restype = ctypes.c_int
        lib.dp_has_png.argtypes = []
        lib.dp_probe_image.restype = ctypes.c_int
        lib.dp_probe_image.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_int)]
        lib.dp_load_batch.restype = ctypes.c_int
        lib.dp_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        _lib = lib
        return lib


def get_decoder() -> ctypes.CDLL:
    """The loaded decoder (`data/csrc/decode.cpp`), building it on first
    use; raises `DataplaneUnavailable` when no build succeeds."""
    global _decoder
    with _lock:
        if _decoder is not None:
            return _decoder
        lib = _build_and_load(
            "the decoder (data/csrc/decode.cpp with native/dataplane.cpp)",
            lambda v: _compile(v, decoder_path(v), DECODE_SOURCE,
                               ("-I", _REPO)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.dpx_decode.restype = ctypes.c_int
        lib.dpx_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(u8p),
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
        lib.dpx_free.restype = None
        lib.dpx_free.argtypes = [u8p]
        _decoder = lib
        return lib


def decode_image(path: str) -> np.ndarray:
    """The file at `path` as (H, W, 3) uint8 RGB (JPEG, or PNG where
    libpng was there to build with); `DataplaneDecodeError` naming the
    file when it does not decode."""
    lib = get_decoder()
    buf = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.dpx_decode(os.fsencode(path), ctypes.byref(buf), ctypes.byref(w),
                      ctypes.byref(h)) != 0:
        raise DataplaneDecodeError(f"the decoder could not decode {path}")
    try:
        return np.ctypeslib.as_array(buf, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.dpx_free(buf)


def probe_image(path: str) -> Optional[Tuple[int, int]]:
    """(width, height) when the dataplane decodes `path`, else None."""
    w, h = ctypes.c_int(), ctypes.c_int()
    if get_lib().dp_probe_image(os.fsencode(path), ctypes.byref(w),
                                ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


_MEAN = (ctypes.c_float * 3)(*IMAGENET_MEAN)
_STD = (ctypes.c_float * 3)(*IMAGENET_STD)
# identity "normalization" for the uint8 wire: (v/255 − 0)/(1/255) = v, so
# the C side hands back raw 0..255 pixel values (float, before rounding)
_MEAN_RAW = (ctypes.c_float * 3)(0.0, 0.0, 0.0)
_STD_RAW = (ctypes.c_float * 3)(1.0 / 255.0, 1.0 / 255.0, 1.0 / 255.0)


def load_batch(paths: Sequence[str], out_size: int, train: bool,
               resize_short: int = 256,
               scale: Tuple[float, float] = (0.8, 1.0), seed: int = 0,
               num_threads: int = 4, raw: bool = False
               ) -> Tuple[np.ndarray, int]:
    """Decode and transform `paths` into (B, S, S, 3) float32; returns the
    batch and the count of slots that failed (zero-filled). `raw` swaps
    the ImageNet constants for the identity pair: 0..255 values."""
    lib = get_lib()
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    errors = lib.dp_load_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_size, out_size, int(train), resize_short,
        float(scale[0]), float(scale[1]), ctypes.c_uint64(seed),
        _MEAN_RAW if raw else _MEAN, _STD_RAW if raw else _STD, num_threads)
    return out, int(errors)


class NativeBatcher:
    """Batch assembler for `Loader(batcher=...)` over a path-based dataset
    (`ImageFolderDataset`): one native call per batch, with the JAX
    `NativeBatcher`'s seed, presets and uint8 rounding, so its batches are
    bitwise the JAX batcher's (`data/native.py:142-207` there)."""

    # RandomResizedCrop + flip / resize + center crop; 'cdr' (rotation) and
    # 'cifar' (pad + crop) are not the dataplane's
    SUPPORTED = ("baseline", "clothing1m")

    def __init__(self, dataset, preset: str, train: bool, image_size: int,
                 crop_size: int, seed: int, num_threads: int = 4,
                 out_dtype: str = "float32"):
        if preset not in self.SUPPORTED:
            raise ValueError(f"the native dataplane does not run transform "
                             f"{preset!r} (it runs {', '.join(self.SUPPORTED)})")
        self.dataset = dataset
        self.train = train
        self.seed = seed
        self.num_threads = max(num_threads, 1)
        self.resize_short = crop_size
        self.out_dtype = out_dtype
        # build_transform's output-size quirk (train at crop_size for
        # baseline) and its out_dtype check
        self.out_size = build_transform(preset, train, image_size, crop_size,
                                        out_dtype=out_dtype).out_size
        self.scale = (0.08, 1.0) if preset == "clothing1m" else (0.8, 1.0)

    def __call__(self, indices: np.ndarray, epoch: int, batch_idx: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        paths = [self.dataset.paths[int(i)] for i in indices]
        labels = np.asarray([self.dataset.labels[int(i)] for i in indices],
                            np.int32)
        seed = (self.seed * 1_000_003 + epoch * 10_007 + batch_idx) & 0xFFFFFFFF
        emit_uint8 = self.out_dtype == "uint8"
        # the C side flips every train sample with its own draw
        # (dataplane.cpp:296-300) whatever the wire: on the uint8 wire the
        # device epilogue then flips again with an independent draw, as in
        # JAX — kept for bitwise parity with the JAX batcher (the composed
        # flip is still a flip with probability 1/2)
        images, errors = load_batch(paths, self.out_size, self.train,
                                    self.resize_short, self.scale, seed,
                                    self.num_threads, raw=emit_uint8)
        if emit_uint8:
            images = np.clip(np.rint(images), 0, 255).astype(np.uint8)
        if errors:
            self._raise_for_failed(paths, images, errors)
        return images, labels

    @staticmethod
    def _raise_for_failed(paths: Sequence[str], images: np.ndarray,
                          errors: int) -> None:
        """A failed slot is all zeros, but so is a black image: the slots
        that sum to zero are probed, and the ones that do not decode are
        named."""
        zero = np.nonzero(images.reshape(len(paths), -1).any(axis=1) == 0)[0]
        bad = [paths[j] for j in zero if probe_image(paths[j]) is None]
        raise DataplaneDecodeError(
            f"the native dataplane could not decode {errors} of "
            f"{len(paths)} files in a batch: "
            + (", ".join(bad) if bad else "(each all-zero slot decodes on a "
               f"second read: {', '.join(paths[j] for j in zero)})"))
