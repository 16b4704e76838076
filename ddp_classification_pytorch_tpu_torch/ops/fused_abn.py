"""K1: fused BatchNorm + LeakyReLU, the port of the JAX package's Pallas
kernel `ops/pallas_kernels.py::_fused_kernel` (public entry point
`fused_bn_leaky_relu`), as a CUDA kernel for Hopper
(`ops/csrc/fused_abn.cu`), and the training passes around it
(`ops/csrc/fused_abn_train.cu`).

    y = leaky_relu(scale * (x - mean) * rsqrt(var + eps) + bias)

over the channel axis; the math is f32 and y has x's dtype.

Training mode (`batch_norm_leaky_relu`, the autograd Function
`FusedBNLeakyReLU`) is the JAX package's `batch_norm_leaky_relu` with its
custom VJP (`pallas_kernels.py:88-151`), in three more kernels:

- K1s `bn_stats`: the batch statistics mean, var = E[x²] − E[x]² (f32,
  not clamped) and inv_std, which feed K1's forward;
- K1r `abn_grad_sums`: the backward's per-channel sums Σdy·x̂ and Σdy
  (dscale and dbias);
- K1d `abn_grad_input`: the exact batch-statistic dx of `_bwd`.

Every wrapper takes a tensor on the CPU to its plain version (`*_ref`, the
CPU tests' path and the card's oracle) and a tensor on the card to its
kernel, or raises: there is no fallback from the card to the plain
version. Each launch adds one to the wrapper's `launches`, so a run can
show that its main path went through the kernels.

The launch geometry (vector width, rows per thread, block and grid) is
computed here, cached per shape, and checked by the C side, which refuses
one it does not take; the CPU tests hold its arithmetic. K1 and K1d use
`geometry` (K1d through `grad_input_geometry`); the two reductions K1s and
K1r use `sums_geometry`: one launch a call, whose last block per channel
tile adds the tile's partials, with per-card counters and workspace kept
here (`_sums_scratch`).
"""

from __future__ import annotations

import ctypes
import functools
import operator
import os
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from . import _build

SOURCES = [os.path.join(_build.CSRC, name)
           for name in ("fused_abn.cu", "fused_abn_train.cu")]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VEC = 4  # channels per vector access, both dtypes (kVec in fused_abn.cu)
ALIGN = 16  # bytes every pointer must be aligned to for the vector path
MAX_THREADS = 256  # per block (kMaxThreads in fused_abn.cu)
RESIDENT_BLOCKS = 4  # blocks per SM the kernel is built to fit (kMinBlocksPerSm)
MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y
ROWS_PER_THREAD = (1, 2, 4, 8)  # the R the kernel is instantiated for
TILES_PER_SM = 2  # R grows only while every SM still gets this many row tiles
GRAD_INPUT_MAX_ROWS = 4  # the R K1d is built for (kGradInputMaxRows)
SUM_THREADS = 256  # per block of K1s and K1r (kSumThreads in fused_abn_train.cu)
SUM_MIN_ROWS = 16  # rows each lane of K1s/K1r sums at least, where M allows
SUM_TILE = 32  # channels of a K1s/K1r channel tile at most: 64 bytes of bf16
SUM_BLOCKS_PER_SM = 1  # K1s/K1r blocks the grid holds per SM at most
SUM_COUNTERS = 1024  # channel tiles the per-card counters cover at first
_lib: Optional[ctypes.CDLL] = None
_raw_stream: Optional[Callable[[int], int]] = None
_sms: Dict[int, int] = {}
_scratch: Dict[int, List[torch.Tensor]] = {}  # card -> [counters, workspace]


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
def sums_geometry(m: int, c: int, sms: int, aligned: bool = True) -> Geometry:
    """The launch geometry of the reductions K1s and K1r for (m, c) rows on
    a card of `sms` SMs: few, long partials. A block is SUM_THREADS
    threads, `tx` channel groups of a channel tile of at most SUM_TILE
    channels by `ty` = SUM_THREADS // tx row lanes; `gx` channel tiles by
    `gy` row blocks, gy at most SUM_BLOCKS_PER_SM * sms // gx and small
    enough that each lane sums at least SUM_MIN_ROWS rows where M allows
    (a small M narrows nothing further: the tile is already narrow, and
    the rows stay long). Lane ty_i of row block by sums rows by * ty +
    ty_i + k * ty * gy for k < `rows` = ceil(m / (ty * gy)); the last
    block of a channel tile adds its gy partials. The vector path as in
    `geometry`."""
    vec = VEC if aligned and c % VEC == 0 else 1
    groups = -(-c // vec)
    tx = min(groups, SUM_TILE // vec)
    ty = SUM_THREADS // tx
    gx = -(-groups // tx)
    gy = max(1, min(m // (SUM_MIN_ROWS * ty), SUM_BLOCKS_PER_SM * sms // gx))
    rows = -(-m // (ty * gy))
    return Geometry(vec, rows, tx, ty, gx, gy)


@functools.lru_cache(maxsize=4096)
def _packed(g: Geometry) -> ctypes.Array:
    return (ctypes.c_int * len(g))(*g)


def build() -> str:
    """Build (or find) the kernels' library and load it; returns its path."""
    global _lib, _raw_stream
    path = _build.build("fused_abn", SOURCES)
    if _lib is None:
        lib = ctypes.CDLL(path)
        ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_float)
        # each: pointers, m, c, then its scalars, dtype, geometry, stream
        for name, n_ptrs, scalars in (("fused_abn_forward", 6, (f32, f32)),
                                      ("abn_stats", 6, (f32, i32)),
                                      ("abn_grad_sums", 9, (f32, i32)),
                                      ("abn_grad_input", 9, (f32,))):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * n_ptrs + [i64, i32, *scalars, i32, ptr, ptr]
            fn.restype = ctypes.c_int
        lib.fused_abn_launch_floor.argtypes = [ptr] * 2
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


_K1_VECS = ("scale", "bias", "mean", "var")


def _check(x: torch.Tensor, vecs, names=_K1_VECS,
           op: str = "fused_bn_leaky_relu") -> int:
    """C of x, after refusing what the kernel `op` does not take: x on a
    card, f32 or bf16, channels_last (4-D) or row-major (2-D), not empty;
    each of `vecs` (named by `names`) a contiguous f32 (C,) tensor on x's
    card."""
    if not x.is_cuda:
        raise ValueError(f"{op}: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: x must be float32 or bfloat16, got {x.dtype}")
    c = _channels(x)
    if x.dim() == 4:
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{op}: x must be channels_last contiguous (NHWC "
                             "in memory)")
    elif not x.is_contiguous():
        raise ValueError(f"{op}: (M, C) x must be contiguous")
    index = x.get_device()
    for name, v in zip(names, vecs):
        if (v.get_device() != index or v.dtype != torch.float32
                or v.shape != (c,) or not v.is_contiguous()):
            raise ValueError(
                f"{op}: {name} must be a contiguous float32 ({c},) tensor on "
                f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")
    if x.numel() == 0:
        raise ValueError(f"{op}: empty input")
    return c


def _check_like(op: str, x: torch.Tensor, **others: torch.Tensor) -> None:
    """Refuse a tensor that does not share x's device, dtype, shape and
    strides (g and y beside x in the backward: no silent relayout)."""
    want = (x.device, x.dtype, x.shape, x.stride())
    for name, t in others.items():
        if (t.device, t.dtype, t.shape, t.stride()) != want:
            raise ValueError(
                f"{op}: {name} must match x's device, dtype, shape and "
                f"layout {want}, got {(t.device, t.dtype, t.shape, t.stride())}")


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
                    _aligned(ptrs))


def _aligned(ptrs) -> bool:
    """Whether every pointer allows the vector path (ALIGN bytes)."""
    return not functools.reduce(operator.or_, ptrs) % ALIGN


def _invoke(name: str, x: torch.Tensor, args, g: Geometry) -> None:
    """Call the C entry point `name` with `args`, x's dtype code, geometry
    g and the current stream of x's card; raise if it did not launch."""
    if _lib is None:
        build()
    index = x.get_device()
    fn = getattr(_lib, name)
    args = (*args, _DTYPE_CODES[x.dtype], _packed(g))
    if index == torch.cuda.current_device():  # no device switch to pay for
        rc = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
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
    c = x.shape[1]
    _invoke("fused_abn_forward", x,
            ([t.data_ptr() for t in (x, y, scale, bias, mean, var)]
             + [x.numel() // c, c, eps, negative_slope]), g)


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
    c = _check(x, (scale, bias, mean, var))
    y = torch.empty_like(x)
    ptrs = (x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), var.data_ptr())
    _invoke("fused_abn_forward", x,
            (*ptrs, x.numel() // c, c, eps, negative_slope),
            launch_geometry(x, ptrs))
    fused_bn_leaky_relu.launches += 1
    return y


fused_bn_leaky_relu.launches = 0


# ---------------------------------------------------------------- training --
# The batch statistics and K1's exact backward, as the JAX package computes
# them around the Pallas kernel (`pallas_kernels.py:95-151`).

def _rows(t: torch.Tensor) -> torch.Tensor:
    """(M, C) f32 rows of (N, C, H, W) activations (NHWC order) or of (M, C)."""
    if t.dim() == 4:
        t = t.permute(0, 2, 3, 1)
    return t.reshape(-1, t.shape[-1]).float()


def _unrows(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(M, C) rows back to `like`'s shape (channels_last for 4-D) and dtype."""
    if like.dim() == 4:
        n, c, h, w = like.shape
        rows = rows.reshape(n, h, w, c).permute(0, 3, 1, 2)
    return rows.to(like.dtype)


def bn_stats_ref(x: torch.Tensor, eps: float = 1e-5):
    """The plain version of K1s: (mean, var, inv_std), f32 (C,), with
    var = mean(x²) − mean² not clamped (`pallas_kernels.py:140-143`) and
    inv_std = rsqrt(var + eps) (`_fwd`, :90)."""
    _channels(x)
    xf = _rows(x)
    mean = xf.mean(0)
    var = (xf * xf).mean(0) - mean * mean
    return mean, var, torch.rsqrt(var + eps)


def _gated(g2: torch.Tensor, y2: torch.Tensor, negative_slope: float):
    """dy = g · gate, the gate from the output's sign (`_bwd`, :104-106)."""
    return g2 * torch.where(y2 >= 0, 1.0, negative_slope)


def abn_grad_sums_ref(g: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                      mean: torch.Tensor, inv_std: torch.Tensor,
                      negative_slope: float = 0.01):
    """The plain version of K1r: (dscale, dbias) = (Σdy·x̂, Σdy) per
    channel (`_bwd`, :102-109)."""
    x_hat = (_rows(x) - mean) * inv_std
    dy = _gated(_rows(g), _rows(y), negative_slope)
    return (dy * x_hat).sum(0), dy.sum(0)


def abn_grad_input_ref(g: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                       scale: torch.Tensor, mean: torch.Tensor,
                       inv_std: torch.Tensor, dscale: torch.Tensor,
                       dbias: torch.Tensor,
                       negative_slope: float = 0.01) -> torch.Tensor:
    """The plain version of K1d: `_bwd`'s dx (:111-117) with its two sums
    taken from K1r's, as the kernel takes them: Σdx̂ = scale·dbias and
    Σ(dx̂·x̂) = scale·dscale. x's layout and dtype."""
    x2 = _rows(x)
    m = x2.shape[0]
    x_hat = (x2 - mean) * inv_std
    dxhat = _gated(_rows(g), _rows(y), negative_slope) * scale
    dx2 = (inv_std / m) * (m * dxhat - scale * dbias - x_hat * (scale * dscale))
    return _unrows(dx2, x)


def fused_bn_leaky_relu_backward_ref(g: torch.Tensor, x: torch.Tensor,
                                     y: torch.Tensor, scale: torch.Tensor,
                                     mean: torch.Tensor, inv_std: torch.Tensor,
                                     negative_slope: float = 0.01):
    """The JAX package's `_bwd` (`pallas_kernels.py:95-123`), line for
    line: (dx, dscale, dbias) for the cotangent g of y. The oracle the
    K1r + K1d pair is held against."""
    x2, g2, y2 = _rows(x), _rows(g), _rows(y)
    m = x2.shape[0]

    x_hat = (x2 - mean) * inv_std
    gate = torch.where(y2 >= 0, 1.0, negative_slope)
    dy = g2 * gate

    dscale = torch.sum(dy * x_hat, 0)
    dbias = torch.sum(dy, 0)

    dxhat = dy * scale
    dx2 = (inv_std / m) * (
        m * dxhat - torch.sum(dxhat, 0) - x_hat * torch.sum(dxhat * x_hat, 0))
    return _unrows(dx2, x), dscale, dbias


def _sums_scratch(x: torch.Tensor, g: Geometry):
    """(workspace, counters, count of counters) for K1s or K1r on x's card
    with geometry g: pointers to a (gy, 2, C) f32 workspace and to int32
    counters, one a channel tile, all 0 between launches (each launch puts
    back the ones it used). Both live in `_scratch` per card, grown to the
    need, and are shared by every launch there, so those launches must run
    on one stream, in order (as autograd runs a train step); the counters'
    staying 0 also lets a CUDA graph capture the launches."""
    index = x.get_device()
    scratch = _scratch.get(index)
    if scratch is None:
        scratch = _scratch[index] = [
            torch.zeros(SUM_COUNTERS, dtype=torch.int32, device=x.device),
            torch.empty(0, dtype=torch.float32, device=x.device)]
    if scratch[0].numel() < g.gx:
        scratch[0] = torch.zeros(g.gx, dtype=torch.int32, device=x.device)
    need = g.gy * 2 * x.shape[1]
    if scratch[1].numel() < need:
        scratch[1] = torch.empty(need, dtype=torch.float32, device=x.device)
    counters, ws = scratch
    return ws.data_ptr(), counters.data_ptr(), counters.numel()


def bn_stats(x: torch.Tensor, eps: float = 1e-5,
             geometry: Optional[Geometry] = None):
    """K1s on the card, the plain version on the CPU: (mean, var, inv_std)
    of x's channels, f32 (C,) (three rows of one allocation). inv_std is
    1 / sqrt(var + eps) as K1's forward forms it from var. x as
    `fused_bn_leaky_relu` takes it.

    One launch: the kernel's last block per channel tile adds the tile's
    partials, with counters and a workspace kept per card
    (`_sums_scratch`): launches on one card run on one stream, in order.
    `geometry` forces a launch geometry (for tests and measurements; the
    wrapper's own is `sums_geometry`); the C side refuses one it does not
    take, and this raises."""
    if x.device.type == "cpu":
        return bn_stats_ref(x, eps)
    c = _check(x, (), op="bn_stats")
    m = x.numel() // c
    if geometry is None:
        geometry = sums_geometry(m, c, sm_count(x.get_device()),
                                 _aligned([x.data_ptr()]))
    ws, counters, tiles = _sums_scratch(x, geometry)
    out = torch.empty((3, c), dtype=torch.float32, device=x.device)
    base = out.data_ptr()
    _invoke("abn_stats", x, (x.data_ptr(), ws, counters, base, base + 4 * c,
                             base + 8 * c, m, c, eps, tiles), geometry)
    bn_stats.launches += 1
    return out.unbind(0)


bn_stats.launches = 0


def abn_grad_sums(g: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                  mean: torch.Tensor, inv_std: torch.Tensor,
                  negative_slope: float = 0.01,
                  geometry: Optional[Geometry] = None):
    """K1r on the card, the plain version on the CPU: (dscale, dbias), f32
    (C,) (two rows of one allocation). g and y share x's dtype, shape and
    layout. One launch, as `bn_stats`, whose contract and `geometry` it
    shares."""
    if x.device.type == "cpu":
        return abn_grad_sums_ref(g, y, x, mean, inv_std, negative_slope)
    c = _check(x, (mean, inv_std), ("mean", "inv_std"), "abn_grad_sums")
    _check_like("abn_grad_sums", x, g=g, y=y)
    m = x.numel() // c
    ptrs = [t.data_ptr() for t in (g, y, x, mean, inv_std)]
    if geometry is None:
        geometry = sums_geometry(m, c, sm_count(x.get_device()),
                                 _aligned(ptrs))
    ws, counters, tiles = _sums_scratch(x, geometry)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    base = out.data_ptr()
    _invoke("abn_grad_sums", x, (*ptrs, ws, counters, base, base + 4 * c, m,
                                 c, negative_slope, tiles), geometry)
    abn_grad_sums.launches += 1
    return out.unbind(0)


abn_grad_sums.launches = 0


def grad_input_geometry(m: int, c: int, sms: int,
                        aligned: bool = True) -> Geometry:
    """K1d's geometry: K1's rule with R at most GRAD_INPUT_MAX_ROWS (a
    thread holds g, y and x of each of its rows)."""
    g = geometry(m, c, sms, aligned)
    if g.rows <= GRAD_INPUT_MAX_ROWS:
        return g
    return geometry(m, c, sms, aligned, GRAD_INPUT_MAX_ROWS)


def abn_grad_input(g: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                   scale: torch.Tensor, mean: torch.Tensor,
                   inv_std: torch.Tensor, dscale: torch.Tensor,
                   dbias: torch.Tensor,
                   negative_slope: float = 0.01) -> torch.Tensor:
    """K1d on the card, the plain version on the CPU: dx in x's dtype and
    layout, from K1r's (dscale, dbias)."""
    if x.device.type == "cpu":
        return abn_grad_input_ref(g, y, x, scale, mean, inv_std, dscale, dbias,
                                  negative_slope)
    vecs = (scale, mean, inv_std, dscale, dbias)
    c = _check(x, vecs, ("scale", "mean", "inv_std", "dscale", "dbias"),
               "abn_grad_input")
    _check_like("abn_grad_input", x, g=g, y=y)
    m = x.numel() // c
    dx = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (g, y, x, dx, *vecs)]
    geo = grad_input_geometry(m, c, sm_count(x.get_device()), _aligned(ptrs))
    _invoke("abn_grad_input", x, (*ptrs, m, c, negative_slope), geo)
    abn_grad_input.launches += 1
    return dx


abn_grad_input.launches = 0


class FusedBNLeakyReLU(torch.autograd.Function):
    """Training-mode activated ABN with the exact batch-statistic
    backward: the JAX package's `fused_bn_leaky_relu` custom VJP fed by
    `batch_norm_leaky_relu`'s statistics (`pallas_kernels.py:65-151`).

    forward(x, scale, bias, eps, slope) -> (y, mean, var): K1s, then K1 on
    the statistics. It saves `_fwd`'s residuals (x, y, scale, mean,
    inv_std). The statistics are outputs without a gradient: they enter K1
    as stop-gradient values and the dx formula carries their dependence on
    x. backward: K1r, then K1d → (dx, dscale, dbias).

    Autograd may hand the backward a g in another layout than y's; it is
    copied into y's layout and counted in `layout_copies` (the kernels
    refuse a mismatch rather than read it wrongly)."""

    layout_copies = 0

    @staticmethod
    def forward(ctx, x, scale, bias, eps, negative_slope):
        mean, var, inv_std = bn_stats(x, eps)
        y = fused_bn_leaky_relu(x, scale, bias, mean, var, eps, negative_slope)
        ctx.save_for_backward(x, y, scale, mean, inv_std)
        ctx.negative_slope = negative_slope
        ctx.mark_non_differentiable(mean, var)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _mean_grad, _var_grad):
        if g is None:
            return None, None, None, None, None
        x, y, scale, mean, inv_std = ctx.saved_tensors
        if g.stride() != y.stride():
            g = torch.empty_like(y).copy_(g)
            FusedBNLeakyReLU.layout_copies += 1
        slope = ctx.negative_slope
        dscale, dbias = abn_grad_sums(g, y, x, mean, inv_std, slope)
        dx = abn_grad_input(g, y, x, scale, mean, inv_std, dscale, dbias, slope)
        return dx, dscale, dbias, None, None


def batch_norm_leaky_relu(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5,
                          negative_slope: float = 0.01):
    """Training-mode fused ABN (`pallas_kernels.py:129`): batch statistics
    over every axis but C, then K1 on them. Returns (y, mean, var), the
    statistics f32 and without a gradient, for the caller's running
    update. Differentiable in x, scale and bias."""
    return FusedBNLeakyReLU.apply(x, scale, bias, eps, negative_slope)
