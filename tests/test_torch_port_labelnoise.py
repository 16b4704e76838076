"""The port's PLC label-noise toolkit (`ops/labelnoise.py`) against the JAX
package's, on the CPU.

(a) `label_noise` (types 0/1/2, binary and 14-class), `lrt_correction`,
    `cap_flips` and `prob_correction` (top_k 1 and 3) on seeded inputs:
    labels, f_us, counts and δ bitwise.
(b) `eta_approximation` with JAX's `jax.random` initialization passed in
    (`init=`): within 1e-5 of JAX, linear and with a hidden layer, with
    n a multiple of the batch and with leftover rows past it.
(c) Its own initialization: the scales of JAX's (He-normal kernels, zero
    biases) and the same draw for the same seed.
"""

import jax
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.ops import labelnoise as jax_ln
from ddp_classification_pytorch_tpu_torch.ops import labelnoise as ln


def _eta(rng, n, c):
    e = rng.random((n, c))
    return e / e.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("classes", [2, 14])
@pytest.mark.parametrize("noise_type", [0, 1, 2])
def test_label_noise_is_bitwise_jax(noise_type, classes):
    rng = np.random.default_rng(noise_type * 10 + classes)
    n = 500
    eta = _eta(rng, n, classes)
    labels = rng.integers(0, classes, n)
    got = ln.label_noise(labels, eta, noise_type, 1.2, np.random.default_rng(3))
    want = jax_ln.label_noise(labels, eta, noise_type, 1.2,
                              np.random.default_rng(3))
    assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype
    assert got[1].tobytes() == want[1].tobytes()
    assert got[2] == want[2] and got[2] > 0
    with pytest.raises(ValueError, match="noise_type"):
        ln.label_noise(labels, eta, 3)


@pytest.mark.parametrize("delta", [0.3, 1e-5])
def test_lrt_correction_is_bitwise_jax(delta):
    rng = np.random.default_rng(5)
    p = _eta(rng, 2000, 14).astype(np.float32)
    y = rng.integers(0, 14, 2000)
    got, gd = ln.lrt_correction(y, p, delta, 0.1)
    want, wd = jax_ln.lrt_correction(y, p, delta, 0.1)
    assert np.array_equal(got, want) and gd == wd
    moved = int((got != y).sum())
    # fewer than 0.1% moved: δ grows
    assert gd == (delta + 0.1 if moved < 2 else delta) and (moved > 0) == (delta == 0.3)


@pytest.mark.parametrize("frac", [0.29, 0.01, 1.0])
def test_cap_flips_is_bitwise_jax(frac):
    rng = np.random.default_rng(6)
    p = _eta(rng, 100, 5)
    y = rng.integers(0, 5, 100)
    new = np.where(rng.random(100) < 0.5, p.argmax(1), y)
    got, want = ln.cap_flips(y, new, p, frac), jax_ln.cap_flips(y, new, p, frac)
    assert np.array_equal(got, want)
    assert int((got != y).sum()) == min(int(round(frac * 100)),
                                        int((new != y).sum()))


@pytest.mark.parametrize("top_k", [1, 3])
@pytest.mark.parametrize("thd", [0.1, 0.3])
def test_prob_correction_is_bitwise_jax(top_k, thd):
    rng = np.random.default_rng(7)
    f_x = rng.normal(0, 1.5, (1000, 14)).astype(np.float32)
    y = rng.integers(0, 14, 1000)
    got, gd = ln.prob_correction(y, f_x, np.random.default_rng(9), 0.3, 0.1,
                                 thd, top_k)
    want, wd = jax_ln.prob_correction(y, f_x, np.random.default_rng(9), 0.3,
                                      0.1, thd, top_k)
    assert np.array_equal(got, want) and gd == wd


def _jax_init(d, c, hidden, seed):
    """The JAX function's initial parameters (its own draw, replayed)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    if hidden:
        return {"w1": np.asarray(jax.random.normal(k1, (d, hidden)))
                * (2.0 / d) ** 0.5, "b1": np.zeros(hidden, np.float32),
                "w2": np.asarray(jax.random.normal(k2, (hidden, c)))
                * (2.0 / hidden) ** 0.5, "b2": np.zeros(c, np.float32)}
    return {"w": np.asarray(jax.random.normal(k1, (d, c))) * (1.0 / d) ** 0.5,
            "b": np.zeros(c, np.float32)}


@pytest.mark.parametrize("n,hidden", [(96, 0), (100, 16), (50, 0)],
                         ids=["linear", "hidden-leftover", "linear-leftover"])
def test_eta_approximation_matches_jax_from_its_init(n, hidden):
    rng = np.random.default_rng(n)
    d, c, batch = 24, 5, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, c, n)
    want = jax_ln.eta_approximation(x, y, c, n_epochs=3, lr=0.05,
                                    batch_size=batch, hidden=hidden, seed=11)
    got = ln.eta_approximation(x, y, c, n_epochs=3, lr=0.05, batch_size=batch,
                               hidden=hidden, seed=11,
                               init=_jax_init(d, c, hidden, 11))
    assert got.shape == want.shape == (n, c) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("hidden", [0, 64])
def test_probe_init_has_the_jax_scales(hidden):
    d, c = 512, 14
    p = ln.probe_init(d, c, hidden, seed=77)
    q = ln.probe_init(d, c, hidden, seed=77)
    assert all(torch.equal(p[k], q[k]) for k in p)
    if hidden:
        assert p["w1"].shape == (d, hidden) and p["w2"].shape == (hidden, c)
        stds = [(p["w1"], (2.0 / d) ** 0.5), (p["w2"], (2.0 / hidden) ** 0.5)]
        biases = [p["b1"], p["b2"]]
    else:
        assert p["w"].shape == (d, c)
        stds, biases = [(p["w"], (1.0 / d) ** 0.5)], [p["b"]]
    for w, std in stds:
        assert abs(float(w.std()) / std - 1.0) < 0.1
    assert all(not b.any() for b in biases)
