"""K1 (fused BatchNorm + LeakyReLU forward): the JAX package's Pallas kernel
(interpret mode off the TPU) against the torch port's `fused_bn_leaky_relu`
on CPU tensors, where the port runs its plain version. Same numpy inputs on
both sides.

Tolerances: f32 1e-5 (test_pallas_kernels.py's forward tolerance); bf16
0.05 (test_pallas_kernels.py:79-81 — both sides round the f32 result to
bf16, and an input element can sit on a rounding boundary).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.ops.pallas_kernels import (
    fused_bn_leaky_relu as jax_fused_bn_leaky_relu,
)
from ddp_classification_pytorch_tpu_torch.ops import fused_abn

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}


def _inputs(c: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.5, (2, 4, 6, c)).astype(np.float32)  # NHWC
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0.0, 0.5, c).astype(np.float32)
    mean = rng.normal(0.0, 0.5, c).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return x, scale, bias, mean, var


@pytest.mark.parametrize("slope", [1e-3, 1e-2])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("c", [64, 128, 48])
def test_port_matches_jax_kernel(c, dtype, slope):
    jdt, tdt, tol = _DTYPES[dtype]
    x, scale, bias, mean, var = _inputs(c, seed=c)
    want = jax_fused_bn_leaky_relu(
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(mean), jnp.asarray(var), 1e-5, slope)
    # NHWC numpy → the port's NCHW view, channels_last in memory
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    before = fused_abn.fused_bn_leaky_relu.launches
    got = fused_abn.fused_bn_leaky_relu(
        xt, *(torch.from_numpy(v) for v in (scale, bias, mean, var)),
        1e-5, slope)
    assert got.dtype == tdt
    assert fused_abn.fused_bn_leaky_relu.launches == before  # CPU: no kernel
    np.testing.assert_allclose(
        got.float().permute(0, 2, 3, 1).numpy(),
        np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_rows_layout_matches_nchw_layout():
    """The (M, C) row view and the (N, C, H, W) channels_last view of the
    same NHWC data give the same rows."""
    x, scale, bias, mean, var = _inputs(48, seed=7)
    vecs = [torch.from_numpy(v) for v in (scale, bias, mean, var)]
    four = fused_abn.fused_bn_leaky_relu(
        torch.from_numpy(x).permute(0, 3, 1, 2), *vecs, 1e-5, 1e-3)
    rows = fused_abn.fused_bn_leaky_relu(
        torch.from_numpy(x.reshape(-1, 48)), *vecs, 1e-5, 1e-3)
    np.testing.assert_array_equal(four.permute(0, 2, 3, 1).reshape(-1, 48).numpy(),
                                  rows.numpy())


@pytest.mark.parametrize("shape", [(5,), (2, 3, 48), (1, 2, 3, 4, 48)])
def test_rejects_other_ranks(shape):
    x = torch.zeros(shape)
    c = shape[1] if len(shape) > 1 else 5
    v = torch.ones(c)
    with pytest.raises(ValueError, match="expected"):
        fused_abn.fused_bn_leaky_relu(x, v, v, v, v)


def test_no_kernel_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a card gets no plain
    fallback: the wrapper raises."""
    x = torch.zeros((4, 8), device="meta")
    v = torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_abn.fused_bn_leaky_relu(x, v, v, v, v)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc anywhere: the build raises BuildError, it does not fall back."""
    from ddp_classification_pytorch_tpu_torch.ops import _build

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_path_keys_on_source(tmp_path):
    from ddp_classification_pytorch_tpu_torch.ops import _build

    src = tmp_path / "k.cu"
    src.write_text("// one")
    first = _build.library_path("k", [str(src)])
    assert first == _build.library_path("k", [str(src)])
    src.write_text("// two")
    assert _build.library_path("k", [str(src)]) != first
