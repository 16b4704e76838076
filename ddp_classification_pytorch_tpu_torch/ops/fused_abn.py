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

Only the forward exists: training mode (batch statistics and the exact
backward of `pallas_kernels.py:95-123`) comes with the training slice.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from . import _build

SOURCE = os.path.join(_build.CSRC, "fused_abn.cu")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Build (or find) the kernel's library and load it; returns its path."""
    global _lib
    path = _build.build("fused_abn", [SOURCE])
    if _lib is None:
        lib = ctypes.CDLL(path)
        lib.fused_abn_forward.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
               ctypes.c_int, ctypes.c_void_p])
        lib.fused_abn_forward.restype = ctypes.c_int
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
    if x.device.type != "cuda":
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
    for name, v in (("scale", scale), ("bias", bias), ("mean", mean),
                    ("var", var)):
        if (v.device != x.device or v.dtype != torch.float32
                or v.shape != (c,) or not v.is_contiguous()):
            raise ValueError(
                f"fused_bn_leaky_relu: {name} must be a contiguous float32 "
                f"({c},) tensor on {x.device}, got {v.dtype} "
                f"{tuple(v.shape)} on {v.device}")
    if x.numel() == 0:
        raise ValueError("fused_bn_leaky_relu: empty input")
    if _lib is None:
        build()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _lib.fused_abn_forward(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), var.data_ptr(), x.numel() // c, c, eps,
            negative_slope, _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fused_abn_forward launch failed: CUDA error {rc} "
                           f"(x {tuple(x.shape)} {x.dtype})")
    fused_bn_leaky_relu.launches += 1
    return y


fused_bn_leaky_relu.launches = 0
