"""Ring attention in the torch port (ops/attention.py) and its flash
building block `flash_attention_with_lse` (ops/flash_attention.py)
against the JAX package's, on the CPU.

- `flash_attention_with_lse` against JAX's (the Pallas kernel in
  interpret mode) at (2, 64, 2, 16) f32: out and lse within 1e-5, and
  the gradients of q, k and v under a loss that reads both outputs (a
  nonzero lse cotangent, JAX's own check `tests/test_ring_attention.py:
  115`) within 1e-5; its refusals (unequal shapes, an untileable T).
- Both ring bodies (einsum and flash), causal and not, over N = 2 and 4
  gloo ranks (tests/torch_port_model_axis_worker.py: data 2 × model 2
  and data 1 × model 4) against JAX's `ring_attention` on the 8-device
  mesh with the same shape: the output and dQ/dK/dV under one output
  cotangent, f32, within 1e-5.
- The same bodies over N shards held by one process
  (`ring_attention_shards`, the seam `chip_smoke.py` drives on the card)
  against JAX's ring, and against the port's `flash_attention` on the
  whole T.
- A token count the ring does not divide: JAX's ValueError text.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.parallel import mesh as meshlib
from ddp_classification_pytorch_tpu_torch.ops import attention as port_attention
from ddp_classification_pytorch_tpu_torch.ops import flash_attention as port_fa

import torch_port_model_axis as MA
from torch_port_threads import one_torch_thread  # noqa: F401

# the module (the package's `ops` exports a function of the same name)
jax_fa = importlib.import_module(
    "ddp_classification_pytorch_tpu.ops.flash_attention")
jax_attention = importlib.import_module("ddp_classification_pytorch_tpu.ops.attention")
ATOL = 1e-5
CASES = [(name, causal, flash) for name in ("m22", "m14")
         for causal in (False, True) for flash in (False, True)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return MA.ranks(tmp_path_factory, "ring")[0]


def _qkv(b=2, t=64, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3)]


def _mix_jax(o, lse):
    return (o ** 2).mean() + jnp.sin(lse).mean()


def _mix_torch(o, lse):
    return (o ** 2).mean() + torch.sin(lse).mean()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_with_lse_and_its_lse_gradient_match_jax(causal):
    arrays = _qkv()
    jo, jl = jax_fa.flash_attention_with_lse(*map(jnp.asarray, arrays),
                                             causal=causal)
    jg = jax.grad(lambda *a: _mix_jax(*jax_fa.flash_attention_with_lse(
        *a, causal=causal)), argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    o, lse = port_fa.flash_attention_with_lse(q, k, v, causal=causal)
    assert lse.shape == (2, 2, 64) and lse.dtype == torch.float32
    _mix_torch(o, lse).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl),
                               atol=ATOL)
    for got, want in zip((q.grad, k.grad, v.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flash_with_lse_refuses_what_jax_refuses():
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=640))
    with pytest.raises(ValueError, match="equal shape"):
        port_fa.flash_attention_with_lse(q, k[:, :128], v[:, :128])
    with pytest.raises(ValueError, match="not kernel-tileable"):
        port_fa.flash_attention_with_lse(q[:, :600], k[:, :600], v[:, :600])
    with pytest.raises(ValueError, match="not kernel-tileable"):
        jax_fa.flash_attention_with_lse(*(jnp.asarray(x[:, :600].numpy())
                                          for x in (q, k, v)))


@functools.lru_cache(maxsize=None)
def _jax_ring(name, causal, flash):
    """JAX's ring on the mesh of `name` (jitted): output and dQ/dK/dV under
    the cotangent `do`."""
    q, k, v, do = (jnp.asarray(a) for a in MA.ring_inputs())
    mesh = MA.jax_mesh(name)

    def f(q, k, v):
        return jax_attention.ring_attention(
            q, k, v, mesh=mesh, axis_name=meshlib.MODEL_AXIS, causal=causal,
            use_flash=flash)

    def out_and_grads(q, k, v, do):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(do))

    with mesh:
        return [np.asarray(a) for a in jax.jit(out_and_grads)(q, k, v, do)]


@pytest.mark.parametrize("name,causal,flash", CASES)
def test_ring_over_gloo_ranks_matches_jax(ranks, name, causal, flash):
    """The shards of model group 0 (ranks 0..N-1) in token order."""
    n = MA.MESHES[name][1]
    want = _jax_ring(name, causal, flash)
    got = [np.concatenate([ranks[r]["ring"][(name, causal, flash)][j].numpy()
                           for r in range(n)], axis=1) for j in range(4)]
    for label, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=label)
    if name == "m22":  # the second model group computed the same
        for j in range(4):
            other = np.concatenate([ranks[r]["ring"][(name, causal, flash)][j]
                                    .numpy() for r in (2, 3)], axis=1)
            np.testing.assert_array_equal(other, got[j])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("flash", [False, True])
def test_ring_in_one_process_matches_jax_and_flash(n, causal, flash):
    q, k, v, do = (torch.from_numpy(a) for a in MA.ring_inputs())
    name = "m22" if n == 2 else "m14"
    want = _jax_ring(name, causal, flash)
    chunks = [list(x.chunk(n, dim=1)) for x in (q, k, v, do)]
    outs, grads = port_attention.ring_attention_shards(
        *chunks, causal=causal, use_flash=flash)
    got = [torch.cat(outs, 1)] + [torch.cat(g, 1) for g in grads]
    for label, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=label)
    whole = port_fa.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got[0], whole, atol=ATOL, rtol=0)


def test_ring_refuses_an_indivisible_token_count(monkeypatch):
    """30 tokens over a ring of 4: the port's `shard_tokens` (what the ViT
    calls on its token axis) raises JAX's `ring_attention` text."""
    monkeypatch.setattr(port_attention, "axis_size", lambda group: 4)
    monkeypatch.setattr(port_attention, "axis_index", lambda group: 0)
    with pytest.raises(ValueError) as port_err:
        port_attention.shard_tokens(torch.zeros(1, 30, 2, 16), "ring")
    mesh = MA.jax_mesh("m14")
    xj = jnp.zeros((1, 30, 2, 16))
    with pytest.raises(ValueError) as jax_err:
        jax_attention.ring_attention(xj, xj, xj, mesh=mesh,
                                     axis_name=meshlib.MODEL_AXIS)
    assert str(port_err.value) == str(jax_err.value)
