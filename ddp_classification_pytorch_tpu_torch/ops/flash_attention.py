"""K2-K4: flash attention forward and backward, the port of the JAX
package's Pallas kernels in `ops/flash_attention.py` — `_flash_kernel`
(K2, forward), `_dq_kernel` (K3) and `_dkv_kernel` (K4) — as CUDA kernels
for Hopper, built into one library:

- `ops/csrc/flash_fwd_sm90.cu`: K2 in bf16 — wgmma products, the online
  softmax in registers, K/V streamed through a TMA ring by a producer warp
  to two consumer warpgroups of 64 q rows each;
- `ops/csrc/flash_bwd_sm90.cu`: K3 and K4 in bf16 — wgmma products, scores
  in registers, double-buffered TMA loads;
- `ops/csrc/flash_sm90.cuh`: the PTX and tensor-map helpers both share;
- `ops/csrc/flash_attention.cu`: the C entry points, and K2-K4 in f32
  (CUDA-core products in full f32).

Three launch wrappers over (BH, T, D) tensors, each with its plain PyTorch
version beside it:

- `flash_forward(q3, k3, v3, scale, causal) -> (out, lse)`: K2;
- `flash_dq(q3, k3, v3, do3, lse, dsum, scale, causal) -> dq`: K3;
- `flash_dkv(q3, k3, v3, do3, lse, dsum, scale, causal) -> (dk, dv)`: K4.

A tensor on the CPU takes the plain version (`*_ref`, the CPU tests'
path); a tensor on the card launches the kernel or raises — there is no
fallback from the card. Each launch adds one to the wrapper's `launches`.

`flash_attention(q, k, v, scale=None, causal=False)` is the public entry
point in the JAX layout (B, T, H, D): a `torch.autograd.Function` whose
forward is K2 and whose backward forms Δ = rowsum(dO ⊙ O) in f32 as plain
torch (as the JAX `_fa_bwd` does) and then runs K3 and K4. Token counts the
Pallas kernels do not tile (`_supported`) take the dense op, so both
packages take the same path for every T. The (B, T, H, D) ↔ (BH, T, D)
transposes are explicit copies. The Function looks the three wrappers up
in this module at call time, so a caller can swap in the plain versions.

`flash_attention_with_lse(q, k, v, scale=None, causal=False)` (JAX
`:439-490`) also returns the rows' logsumexp (B, H, T) f32 — the statistic
that merges attention over KV blocks held elsewhere. Its backward folds the
lse cotangent into Δ (Δ − ḡ_lse: dS = P ⊙ (dP − (Δ − ḡ_lse))) before K3
and K4. It refuses unequal shapes and a T the Pallas kernels do not tile,
as JAX's does. It is the JAX package's API for these kernels: the port's
ring (`ops/attention.py`) calls the three wrappers itself, with the merged
rows' lse and Δ, and does not go through it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from ..utils.debug_nans import check_outputs
from . import _build

SOURCES = [os.path.join(_build.CSRC, name)
           for name in ("flash_attention.cu", "flash_fwd_sm90.cu",
                        "flash_bwd_sm90.cu")]
HEAD_DIM = 64  # the kernels' D: every ViT of models/vit.py has 64-wide heads
_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Build (or find) the kernels' library and load it; returns its path."""
    global _lib
    path = _build.build("flash_attention", SOURCES)
    if _lib is None:
        lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [p] * 5 + [i, i, i, f, i, i, p]
        lib.flash_dq.argtypes = [p] * 7 + [i, i, i, f, i, i, p]
        lib.flash_dkv.argtypes = [p] * 8 + [i, i, i, f, i, i, p]
        lib.flash_sm90_resources.argtypes = [p]
        for fn in (lib.flash_fwd, lib.flash_dq, lib.flash_dkv,
                   lib.flash_sm90_resources):
            fn.restype = ctypes.c_int
        _lib = lib
    return path


def kernel_resources() -> dict:
    """What the bf16 K2, K3 and K4 hold on the current card, as the CUDA
    runtime reports it: registers per thread, dynamic shared memory per
    block (bytes) and resident blocks per SM (the occupancy calculator).
    It exists for `chip_smoke.py`'s record only; no launch path calls it."""
    if _lib is None:
        build()
    out = (ctypes.c_int * 9)()
    rc = _lib.flash_sm90_resources(out)
    if rc != 0:
        raise RuntimeError(f"flash_sm90_resources failed: CUDA error {rc}")
    return {name: {"registers": out[3 * i], "smem_bytes": out[3 * i + 1],
                   "blocks_per_sm": out[3 * i + 2]}
            for i, name in enumerate(("flash_fwd_kernel_sm90",
                                      "flash_dq_kernel_sm90",
                                      "flash_dkv_kernel_sm90"))}


def _supported(t: int) -> bool:
    """The JAX package's routing rule (`flash_attention.py:51-56`): T the
    Pallas kernels tile — one whole-T block or a multiple of 128. Kept so
    both packages send every T down the same path; the CUDA kernels
    themselves mask any ragged T."""
    return t <= 512 or t % 128 == 0


# ------------------------------------------------------- plain versions --

def _scores(q3, k3, scale: float, causal: bool) -> torch.Tensor:
    """(BH, T, T) f32 scaled scores, above-diagonal entries at -1e30."""
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if causal:
        t = s.shape[-1]
        mask = torch.ones(t, t, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def flash_forward_ref(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                      scale: float, causal: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's function in dense f32: the unnormalised P = exp(S − m) rounded
    to V's dtype before P·V, then divided by l; lse = m + log l, (BH, T, 1)
    f32."""
    s = _scores(q3, k3, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v3.dtype).float(), v3.float()) / l
    return out.to(q3.dtype), m + torch.log(l)


def _p_ds(q3, k3, v3, do3, lse, dsum, scale, causal):
    p = torch.exp(_scores(q3, k3, scale, causal) - lse)
    dp = torch.matmul(do3.float(), v3.float().transpose(1, 2))
    return p, p * (dp - dsum)


def flash_dq_ref(q3, k3, v3, do3, lse, dsum, scale: float,
                 causal: bool = False) -> torch.Tensor:
    """K3's function in dense f32: dS rounded to K's dtype, dQ = dS·K·scale
    in q's dtype."""
    _, ds = _p_ds(q3, k3, v3, do3, lse, dsum, scale, causal)
    dq = torch.matmul(ds.to(k3.dtype).float(), k3.float()) * scale
    return dq.to(q3.dtype)


def flash_dkv_ref(q3, k3, v3, do3, lse, dsum, scale: float,
                  causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function in dense f32: dV = Pᵀ·dO with P in dO's dtype,
    dK = dSᵀ·Q·scale with dS in Q's dtype."""
    p, ds = _p_ds(q3, k3, v3, do3, lse, dsum, scale, causal)
    dv = torch.matmul(p.to(do3.dtype).float().transpose(1, 2), do3.float())
    dk = torch.matmul(ds.to(q3.dtype).float().transpose(1, 2),
                      q3.float()) * scale
    return dk.to(k3.dtype), dv.to(v3.dtype)


# ------------------------------------------------------------- wrappers --

def _check(name: str, ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """The kernels take (BH, T, 64) f32/bf16 operands of one shape and
    dtype, contiguous and 16-byte aligned on one CUDA device (the bf16
    kernels read them through TMA tensor maps), and (BH, T, 1) f32 row
    statistics; anything else raises."""
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {ref.device}")
    if ref.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: operands must be float32 or bfloat16, got "
                        f"{ref.dtype}")
    if ref.dim() != 3 or ref.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: operands must be (BH, T, {HEAD_DIM}), got "
                         f"{tuple(ref.shape)}")
    if ref.numel() == 0:
        raise ValueError(f"{name}: empty input")
    stats = ref.shape[:2] + (1,)
    for key, x in tensors.items():
        want = ((stats, torch.float32) if key in ("lse", "dsum")
                else (ref.shape, ref.dtype))
        if (x.device != ref.device or (tuple(x.shape), x.dtype) != want
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(
                f"{name}: {key} must be a contiguous, 16-byte aligned "
                f"{want[1]} {tuple(want[0])} tensor on {ref.device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _launch(fn, name: str, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def flash_forward(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                  scale: float, causal: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on the card, the plain version on the CPU: (out (BH, T, D) in
    q's dtype, lse (BH, T, 1) f32)."""
    if q3.device.type == "cpu":
        return flash_forward_ref(q3, k3, v3, scale, causal)
    _check("flash_forward", q3, q=q3, k=k3, v=v3)
    if _lib is None:
        build()
    bh, t, d = q3.shape
    out = torch.empty_like(q3)
    lse = torch.empty((bh, t, 1), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        _launch(_lib.flash_fwd, "flash_fwd", q3.data_ptr(), k3.data_ptr(),
                v3.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, t, d,
                scale, int(causal), _DTYPE_CODES[q3.dtype],
                torch.cuda.current_stream(q3.device).cuda_stream)
    flash_forward.launches += 1
    check_outputs("K2", out, lse)
    return out, lse


def flash_dq(q3, k3, v3, do3, lse, dsum, scale: float,
             causal: bool = False) -> torch.Tensor:
    """K3 on the card, the plain version on the CPU: dQ in q's dtype."""
    if q3.device.type == "cpu":
        return flash_dq_ref(q3, k3, v3, do3, lse, dsum, scale, causal)
    _check("flash_dq", q3, q=q3, k=k3, v=v3, do=do3, lse=lse, dsum=dsum)
    if _lib is None:
        build()
    bh, t, d = q3.shape
    dq = torch.empty_like(q3)
    with torch.cuda.device(q3.device):
        _launch(_lib.flash_dq, "flash_dq", q3.data_ptr(), k3.data_ptr(),
                v3.data_ptr(), do3.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                dq.data_ptr(), bh, t, d, scale, int(causal),
                _DTYPE_CODES[q3.dtype],
                torch.cuda.current_stream(q3.device).cuda_stream)
    flash_dq.launches += 1
    check_outputs("K3", dq)
    return dq


def flash_dkv(q3, k3, v3, do3, lse, dsum, scale: float,
              causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on the card, the plain version on the CPU: (dK, dV) in k's and
    v's dtype."""
    if q3.device.type == "cpu":
        return flash_dkv_ref(q3, k3, v3, do3, lse, dsum, scale, causal)
    _check("flash_dkv", q3, q=q3, k=k3, v=v3, do=do3, lse=lse, dsum=dsum)
    if _lib is None:
        build()
    bh, t, d = q3.shape
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    with torch.cuda.device(q3.device):
        _launch(_lib.flash_dkv, "flash_dkv", q3.data_ptr(), k3.data_ptr(),
                v3.data_ptr(), do3.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), bh, t, d, scale, int(causal),
                _DTYPE_CODES[q3.dtype],
                torch.cuda.current_stream(q3.device).cuda_stream)
    flash_dkv.launches += 1
    check_outputs("K4", dk, dv)
    return dk, dv


flash_forward.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


# ---------------------------------------------------- public entry point --

def _to3(x: torch.Tensor) -> torch.Tensor:
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def _to4(x3: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, t, d = x3.shape
    return x3.view(b, h, t, d).transpose(1, 2)


class _Flash(torch.autograd.Function):
    """Forward K2; backward Δ in f32 as plain torch, then K3 and K4 — the
    JAX package's `custom_vjp` (`_fa_fwd` / `_fa_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        b, _, h, _ = q.shape
        q3, k3, v3 = _to3(q), _to3(k), _to3(v)
        out3, lse = flash_forward(q3, k3, v3, scale, causal)
        ctx.save_for_backward(q3, k3, v3, out3, lse)
        ctx.scale, ctx.causal, ctx.bh = scale, causal, (b, h)
        return _to4(out3, b, h)

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, out3, lse = ctx.saved_tensors
        b, h = ctx.bh
        do3 = _to3(g.to(q3.dtype))
        dsum = (do3.float() * out3.float()).sum(dim=-1, keepdim=True)
        dq3 = flash_dq(q3, k3, v3, do3, lse, dsum, ctx.scale, ctx.causal)
        dk3, dv3 = flash_dkv(q3, k3, v3, do3, lse, dsum, ctx.scale, ctx.causal)
        return (_to4(dq3, b, h), _to4(dk3, b, h), _to4(dv3, b, h), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    causal: bool = False) -> torch.Tensor:
    """Scaled-dot-product attention, (B, T, H, D) → (B, T, H, D), optionally
    causal (row i attends keys ≤ i). T the Pallas kernels do not tile goes
    to the dense op, as in the JAX package."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention requires q/k/v of equal shape, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not _supported(q.shape[1]):
        from .attention import attention

        return attention(q, k, v, causal=causal, scale=scale)
    return _Flash.apply(q, k, v, float(scale), bool(causal))


class _FlashLse(torch.autograd.Function):
    """Forward K2 returning (out, lse); backward Δ − ḡ_lse, then K3 and K4
    (JAX `_fl_fwd` / `_fl_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        b, _, h, _ = q.shape
        q3, k3, v3 = _to3(q), _to3(k), _to3(v)
        out3, lse = flash_forward(q3, k3, v3, scale, causal)
        ctx.save_for_backward(q3, k3, v3, out3, lse)
        ctx.scale, ctx.causal, ctx.bh = scale, causal, (b, h)
        return _to4(out3, b, h), lse.view(b, h, -1)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q3, k3, v3, out3, lse = ctx.saved_tensors
        b, h = ctx.bh
        do3 = _to3(g_out.to(q3.dtype))
        # autograd hands an unused output's cotangent in as zeros
        dsum = ((do3.float() * out3.float()).sum(dim=-1, keepdim=True)
                - g_lse.float().reshape(b * h, -1, 1))
        dq3 = flash_dq(q3, k3, v3, do3, lse, dsum, ctx.scale, ctx.causal)
        dk3, dv3 = flash_dkv(q3, k3, v3, do3, lse, dsum, ctx.scale, ctx.causal)
        return (_to4(dq3, b, h), _to4(dk3, b, h), _to4(dv3, b, h), None, None)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: Optional[float] = None,
                             causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention` that also returns the per-row logsumexp of the
    scaled scores, (B, H, T) f32; both outputs differentiable. T must be
    one the Pallas kernels tile (`_supported`); callers gate on it."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash_attention_with_lse requires q/k/v of equal shape, got "
            f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    if not _supported(q.shape[1]):
        raise ValueError(
            f"T={q.shape[1]} is not kernel-tileable (need T ≤ 512 or a "
            "multiple of 128)")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashLse.apply(q, k, v, float(scale), bool(causal))
