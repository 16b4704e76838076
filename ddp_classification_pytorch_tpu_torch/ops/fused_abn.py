"""K1: fused BatchNorm + LeakyReLU forward, the port of the JAX package's
Pallas kernel `ops/pallas_kernels.py::_fused_kernel` (public entry point
`fused_bn_leaky_relu`), as a CUDA kernel for Hopper
(`ops/csrc/fused_abn.cu`).

    y = leaky_relu(scale * (x - mean) * rsqrt(var + eps) + bias)

over the channel axis; the math is f32 and y has x's dtype.

`fused_bn_leaky_relu` takes a tensor on the CPU to the plain version
`fused_bn_leaky_relu_ref` (the CPU tests' path) and a tensor on the card to
the kernel, or raises: there is no fallback from the card to the plain
version. Each launch adds one to `fused_bn_leaky_relu.launches`, so a run can
show that its main path went through the kernel.

The launch geometry (vector width, rows per thread, block and grid) is
computed here by `geometry`, cached per shape, and checked by the C side,
which refuses one it does not take; the CPU tests hold its arithmetic.

Only the forward exists: training mode (batch statistics and the exact
backward of `pallas_kernels.py:95-123`) comes with the training slice.
"""

from __future__ import annotations

import ctypes
import functools
import operator
import os
from typing import Callable, Dict, NamedTuple, Optional

import torch

from . import _build

SOURCE = os.path.join(_build.CSRC, "fused_abn.cu")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VEC = 4  # channels per vector access, both dtypes (kVec in fused_abn.cu)
ALIGN = 16  # bytes every pointer must be aligned to for the vector path
MAX_THREADS = 256  # per block (kMaxThreads in fused_abn.cu)
RESIDENT_BLOCKS = 4  # blocks per SM the kernel is built to fit (kMinBlocksPerSm)
MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y
ROWS_PER_THREAD = (1, 2, 4, 8)  # the R the kernel is instantiated for
TILES_PER_SM = 2  # R grows only while every SM still gets this many row tiles
_lib: Optional[ctypes.CDLL] = None
_raw_stream: Optional[Callable[[int], int]] = None
_sms: Dict[int, int] = {}


class Geometry(NamedTuple):
    """How one launch covers (M, C) rows: `vec` channels per vector access
    (1 on the scalar path), `rows` (R) rows per thread and row tile, a block
    of `tx` channel groups by `ty` rows, a grid of `gx` channel tiles by
    `gy` row tiles; block (bx, by) takes row tiles by, by + gy, ... of
    ty * R rows."""
    vec: int
    rows: int
    tx: int
    ty: int
    gx: int
    gy: int


@functools.lru_cache(maxsize=4096)
def geometry(m: int, c: int, sms: int, aligned: bool = True,
             rows: Optional[int] = None) -> Geometry:
    """The launch geometry for (m, c) rows on a card of `sms` SMs. A block
    spans the row's channel groups (up to MAX_THREADS of them) and as many
    rows as fill it. R is the largest of ROWS_PER_THREAD that still gives
    every SM TILES_PER_SM row tiles (else 1), so small launches spread over
    the card and large ones amortise each thread's constants over more rows
    (`rows` forces one). The grid holds at most sms * RESIDENT_BLOCKS
    blocks; the kernel's row-stride loop covers the rest. The vector path
    (VEC channels an access) needs C a multiple of VEC and every pointer
    ALIGN-byte aligned; anything else takes the scalar path."""
    vec = VEC if aligned and c % VEC == 0 else 1
    groups = -(-c // vec)
    tx = min(groups, MAX_THREADS)
    gx = -(-groups // tx)
    ty = MAX_THREADS // tx
    if rows is None:
        rows = ROWS_PER_THREAD[0]
        for r in ROWS_PER_THREAD:
            if -(-m // (ty * r)) * gx >= TILES_PER_SM * sms:
                rows = r
    tiles = -(-m // (ty * rows))
    gy = min(tiles, MAX_GRID_Y, max(1, sms * RESIDENT_BLOCKS // gx))
    return Geometry(vec, rows, tx, ty, gx, gy)


@functools.lru_cache(maxsize=4096)
def _packed(g: Geometry) -> ctypes.Array:
    return (ctypes.c_int * len(g))(*g)


def build() -> str:
    """Build (or find) the kernel's library and load it; returns its path."""
    global _lib, _raw_stream
    path = _build.build("fused_abn", [SOURCE])
    if _lib is None:
        lib = ctypes.CDLL(path)
        lib.fused_abn_forward.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        lib.fused_abn_forward.restype = ctypes.c_int
        lib.fused_abn_launch_floor.argtypes = [ctypes.c_void_p] * 2
        lib.fused_abn_launch_floor.restype = ctypes.c_int
        # the current stream's handle without building a Stream object (the
        # accessor torch's own generated code uses)
        from torch._C import _cuda_getCurrentRawStream
        _raw_stream = _cuda_getCurrentRawStream
        _lib = lib
    return path


def _channels(x: torch.Tensor) -> int:
    """C of (N, C, H, W) activations or of (M, C) rows: dim 1 of both."""
    if x.dim() not in (2, 4):
        raise ValueError(f"expected (N, C, H, W) or (M, C), got shape "
                         f"{tuple(x.shape)}")
    return x.shape[1]


def fused_bn_leaky_relu_ref(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, mean: torch.Tensor,
                            var: torch.Tensor, eps: float = 1e-5,
                            negative_slope: float = 0.01) -> torch.Tensor:
    """The plain PyTorch version: same f32 op order as the Pallas kernel
    (x_hat = (x - mean) * inv_std; y = x_hat * scale + bias; gate)."""
    c = _channels(x)
    shape = (1, c) if x.dim() == 2 else (1, c, 1, 1)
    inv_std = torch.rsqrt(var.float() + eps)
    x_hat = (x.float() - mean.float().view(shape)) * inv_std.view(shape)
    y = x_hat * scale.float().view(shape) + bias.float().view(shape)
    return torch.where(y >= 0, y, y * negative_slope).to(x.dtype)


def _check(x: torch.Tensor, vecs) -> int:
    """C of x, after refusing what the kernel does not take."""
    if not x.is_cuda:
        raise ValueError(f"fused_bn_leaky_relu: no kernel for device "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_bn_leaky_relu: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    c = _channels(x)
    if x.dim() == 4:
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("fused_bn_leaky_relu: x must be channels_last "
                             "contiguous (NHWC in memory)")
    elif not x.is_contiguous():
        raise ValueError("fused_bn_leaky_relu: (M, C) x must be contiguous")
    index = x.get_device()
    for name, v in zip(("scale", "bias", "mean", "var"), vecs):
        if (v.get_device() != index or v.dtype != torch.float32
                or v.shape != (c,) or not v.is_contiguous()):
            raise ValueError(
                f"fused_bn_leaky_relu: {name} must be a contiguous float32 "
                f"({c},) tensor on {x.device}, got {v.dtype} "
                f"{tuple(v.shape)} on {v.device}")
    if x.numel() == 0:
        raise ValueError("fused_bn_leaky_relu: empty input")
    return c


def sm_count(index: int) -> int:
    """SMs of card `index` (read once per card)."""
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def launch_geometry(x: torch.Tensor, ptrs) -> Geometry:
    """The geometry `fused_bn_leaky_relu` launches for a checked x, given
    the six pointers it passes (x, y, scale, bias, mean, var)."""
    c = x.shape[1]
    return geometry(x.numel() // c, c, sm_count(x.get_device()),
                    not functools.reduce(operator.or_, ptrs) % ALIGN)


def _launch(x: torch.Tensor, ptrs, eps: float, negative_slope: float,
            g: Geometry) -> None:
    if _lib is None:
        build()
    index = x.get_device()
    c = x.shape[1]
    args = (*ptrs, x.numel() // c, c, eps, negative_slope,
            _DTYPE_CODES[x.dtype], _packed(g))
    if index == torch.cuda.current_device():  # no device switch to pay for
        rc = _lib.fused_abn_forward(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = _lib.fused_abn_forward(*args, _raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"fused_abn_forward launch failed: CUDA error {rc} "
                           f"(x {tuple(x.shape)} {x.dtype}, {g})")


def launch(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
           bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
           eps: float, negative_slope: float, g: Geometry) -> None:
    """K1 into y with geometry g, on x's card and current stream (for
    measuring and testing geometries; the model calls
    `fused_bn_leaky_relu`). The C side refuses a geometry it does not take:
    this raises. Counts nothing."""
    _check(x, (scale, bias, mean, var))
    if (y.device, y.dtype, y.shape, y.stride()) != (x.device, x.dtype,
                                                    x.shape, x.stride()):
        raise ValueError("fused_abn launch: y must match x's device, dtype, "
                         "shape and layout")
    _launch(x, [t.data_ptr() for t in (x, y, scale, bias, mean, var)], eps,
            negative_slope, g)


def launch_floor(x: torch.Tensor, g: Geometry) -> None:
    """An empty kernel with g's block and grid on x's card: the per-launch
    floor K1 sits on (a yardstick for `chip_smoke.py`; no path of the port
    calls it)."""
    if _lib is None:
        build()
    with torch.cuda.device(x.device):
        rc = _lib.fused_abn_launch_floor(_packed(g),
                                         _raw_stream(x.get_device()))
    if rc != 0:
        raise RuntimeError(f"fused_abn_launch_floor failed: CUDA error {rc}")


def fused_bn_leaky_relu(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, mean: torch.Tensor,
                        var: torch.Tensor, eps: float = 1e-5,
                        negative_slope: float = 0.01) -> torch.Tensor:
    """K1 on the card, the plain version on the CPU.

    x: (N, C, H, W) in channels_last memory (NHWC, as the JAX package lays
    it out) or (M, C) row-major, bf16 or f32. scale, bias, mean, var: f32
    (C,) on x's device. Anything else raises; nothing is silently copied
    into another layout."""
    if x.device.type == "cpu":
        return fused_bn_leaky_relu_ref(x, scale, bias, mean, var, eps,
                                       negative_slope)
    _check(x, (scale, bias, mean, var))
    y = torch.empty_like(x)
    ptrs = (x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), var.data_ptr())
    _launch(x, ptrs, eps, negative_slope, launch_geometry(x, ptrs))
    fused_bn_leaky_relu.launches += 1
    return y


fused_bn_leaky_relu.launches = 0
