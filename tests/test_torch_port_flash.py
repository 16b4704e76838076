"""Flash attention in the torch port (ops/flash_attention.py, ops/attention.py)
against the JAX package's, on the CPU.

On the CPU the port's wrappers take their plain versions, so these tests
hold the plain versions and the autograd Function around them against the
JAX Pallas kernels, run in interpret mode as tests/test_flash_attention.py
runs them. The CUDA kernels are held against the same plain versions on
the card (tests/test_torch_port_cuda.py, chip_smoke.py).

Tolerances: f32 1e-5 (the JAX kernel tests' own); bf16 against the f32
dense op 3e-2 forward and 5e-2 for gradients (tests/test_flash_attention.py
:100,136 — bf16 rounding of P and dS summed over T terms).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.ops.attention import attention as jax_attention
from ddp_classification_pytorch_tpu_torch.ops import attention as port_attention
from ddp_classification_pytorch_tpu_torch.ops import flash_attention as port_fa

from torch_port_threads import one_torch_thread  # noqa: F401

jax_fa = importlib.import_module("ddp_classification_pytorch_tpu.ops.flash_attention")


def _qkv(b=2, t=128, h=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3)]


def _jax_loss_and_grads(fn, arrays, causal):
    q, k, v = (jnp.asarray(a) for a in arrays)
    out = fn(q, k, v, causal=causal)
    grads = jax.grad(lambda q, k, v: (fn(q, k, v, causal=causal) ** 2).mean(),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_loss_and_grads(arrays, causal, dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays)
    out = port_fa.flash_attention(q, k, v, causal=causal)
    (out.float() ** 2).mean().backward()
    return out, [x.grad for x in (q, k, v)]


def _assert_match(port, want, atol):
    out, grads = port
    np.testing.assert_allclose(out.detach().float().numpy(), want[0], atol=atol)
    for g, w in zip(grads, want[1]):
        np.testing.assert_allclose(g.float().numpy(), w, atol=atol)


@pytest.mark.parametrize("t,causal", [(128, False), (196, False), (196, True)],
                         ids=["t128", "t196", "t196-causal"])
def test_flash_forward_and_grads_match_jax(t, causal):
    arrays = _qkv(t=t)
    want = _jax_loss_and_grads(jax_fa.flash_attention, arrays, causal)
    _assert_match(_port_loss_and_grads(arrays, causal), want, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_multiblock_matches_jax(monkeypatch, causal):
    """JAX's block shrunk to 64 so T=256 streams 4 blocks (online-softmax
    rescaling, scratch accumulation, diagonal skipping) in all three
    kernels, as tests/test_flash_attention.py:28-49 does."""
    monkeypatch.setattr(jax_fa, "_block", lambda t, cap=1024: 64)
    arrays = _qkv(t=256, seed=1)
    want = _jax_loss_and_grads(jax_fa.flash_attention, arrays, causal)
    _assert_match(_port_loss_and_grads(arrays, causal), want, atol=1e-5)


def test_flash_bf16_close_to_f32_dense():
    arrays = _qkv(seed=2)
    want = _jax_loss_and_grads(jax_attention, arrays, False)
    out, grads = _port_loss_and_grads(arrays, False, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    np.testing.assert_allclose(out.detach().float().numpy(), want[0], atol=3e-2)
    for g, w in zip(grads, want[1]):
        np.testing.assert_allclose(g.float().numpy(), w, atol=5e-2)


def test_flash_untileable_t_takes_the_dense_op(monkeypatch):
    """T=521 (prime, above 512) is not one the Pallas kernels tile; both
    packages route it to the dense op, and the port runs no flash
    function for it."""
    calls = []
    monkeypatch.setattr(port_fa, "flash_forward",
                        lambda *a: calls.append(a) or port_fa.flash_forward_ref(*a))
    arrays = _qkv(b=1, t=521, h=1, d=16, seed=3)
    want = _jax_loss_and_grads(jax_fa.flash_attention, arrays, False)
    _assert_match(_port_loss_and_grads(arrays, False), want, atol=1e-5)
    assert not calls


@pytest.mark.parametrize(
    "bh,t,d,causal",
    [(4, 196, 32, False), (4, 128, 32, True), (2, 1024, 64, False),
     (2, 320, 64, True)],
    ids=["t196", "t128-causal", "d64-t1024", "d64-t320-causal"])
def test_plain_versions_match_the_jax_kernels(bh, t, d, causal):
    """flash_forward_ref / flash_dq_ref / flash_dkv_ref against the JAX
    kernels K2 (`_flash_forward`) and K3 + K4 (`_flash_backward_impl`) on
    the same (BH, T, D) operands: out, lse, dQ, dK, dV. The D = 64 cases
    are the CUDA kernels' head width: T = 1024 runs the JAX kernels' default
    512-row blocks (two q and two kv blocks per head), T = 320 causal one
    whole-T block."""
    rng = np.random.default_rng(4)
    q3, k3, v3, do3 = (rng.normal(size=(bh, t, d)).astype(np.float32)
                       for _ in range(4))
    scale = d ** -0.5
    out, lse = jax_fa._flash_forward(jnp.asarray(q3), jnp.asarray(k3),
                                     jnp.asarray(v3), scale, causal)
    dsum = (do3 * np.asarray(out)).sum(-1, keepdims=True)
    dq, dk, dv = jax_fa._flash_backward_impl(
        *(jnp.asarray(a) for a in (q3, k3, v3, do3)), lse, jnp.asarray(dsum),
        scale, causal)

    tq3, tk3, tv3, tdo3 = (torch.from_numpy(a) for a in (q3, k3, v3, do3))
    p_out, p_lse = port_fa.flash_forward(tq3, tk3, tv3, scale, causal)
    p_lse_j = torch.from_numpy(np.array(lse))
    p_dsum = torch.from_numpy(dsum)
    p_dq = port_fa.flash_dq(tq3, tk3, tv3, tdo3, p_lse_j, p_dsum, scale, causal)
    p_dk, p_dv = port_fa.flash_dkv(tq3, tk3, tv3, tdo3, p_lse_j, p_dsum, scale,
                                   causal)
    assert p_lse.shape == (bh, t, 1) and p_lse.dtype == torch.float32
    for got, want in ((p_out, out), (p_lse, lse), (p_dq, dq), (p_dk, dk),
                      (p_dv, dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dense_attention_matches_jax(causal):
    arrays = _qkv(t=40, seed=5)
    want = _jax_loss_and_grads(jax_attention, arrays, causal)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = port_attention.attention(q, k, v, causal=causal)
    (out ** 2).mean().backward()
    _assert_match((out, [x.grad for x in (q, k, v)]), want, atol=1e-5)


def test_ring_dispatch_and_refusals():
    """One shard: the flash kernels; two token shards (the ring's bodies
    in one process, the einsum and the flash one): the dense op on the
    whole T (tests/test_torch_port_ring.py holds the ring against JAX's
    over gloo ranks)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=16, seed=6))
    torch.testing.assert_close(
        port_attention.ring_attention(q, k, v, use_flash=True),
        port_attention.attention(q, k, v), atol=1e-5, rtol=1e-5)
    for flash in (False, True):
        outs = port_attention.ring_attention_shards(
            *(list(x.chunk(2, dim=1)) for x in (q, k, v)), use_flash=flash)
        torch.testing.assert_close(torch.cat(outs, 1),
                                   port_attention.attention(q, k, v),
                                   atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="equal shape"):
        port_fa.flash_attention(q, k[:, :8], v[:, :8])


def test_wrappers_refuse_a_device_without_a_kernel():
    """A tensor neither on the CPU nor on CUDA is refused, never computed
    by the plain version."""
    x = torch.zeros(2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        port_fa.flash_forward(x, x, x, 0.125)
