"""PLC's noisy-label toolkit — the port's copy of the JAX package's
`ops/labelnoise.py`: synthetic noise injection, the η approximation, and
label correction (LRT and probabilistic).

- `label_noise` (PLC/utils.py:149-220): instance-dependent synthetic
  noise. Binary: class-1 samples keep their label with probability 1 − f
  (three f shapes, types 0/1/2). Multiclass: every label is redrawn
  between the top-2 classes (u, s) of its η row, u with probability
  noise_level / factor.
- `eta_approximation` (PLC/utils.py:223-288): fit a probe (linear, or one
  hidden ReLU layer) to (feature, noisy label) pairs with SGD (momentum
  0.9, Nesterov, coupled weight decay 5e-4), batches in a fixed order;
  η[i] is the softmax of the probe on x_i, taken in the last epoch with
  the parameters before that batch's update, as the reference collects it.
- `lrt_correction` (PLC/utils.py:291-318): flip a label to the MLE class
  where f(x)[y] / max f(x) < δ; if fewer than 0.1% moved, grow δ by
  `delta_increment` (capped at 0.9).
- `cap_flips`: keep at most `max_flip_frac` of the labels' flips, the
  most confident ones.
- `prob_correction` (PLC/utils.py:321-360): LRT flips where the top-1
  probability reaches `thd`, else a draw from the renormalized top-k.

Everything but the probe fit is numpy on the host, the JAX module's code
line for line, so it is bitwise the JAX package's on equal inputs. The
probe fit is torch on the device the caller names.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _top2(eta: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(η_u, η_s, u, s): top-2 probabilities and class indices per row."""
    order = np.argsort(-eta, axis=1)
    u, s = order[:, 0], order[:, 1]
    rows = np.arange(eta.shape[0])
    return eta[rows, u], eta[rows, s], u, s


def label_noise(
    labels: np.ndarray,
    eta: np.ndarray,
    noise_type: int,
    factor: float = 1.2,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Inject instance-dependent label noise (PLC/utils.py:149-220).

    labels: (n,) int; eta: (n, C) class-posterior estimates.
    Returns (noisy_labels, f_us, corrupted_count).
    """
    rng = rng or np.random.default_rng()
    y = np.asarray(labels).copy()
    n_classes = eta.shape[1]

    if n_classes == 2:
        eta_u = np.asarray(eta[:, 1], np.float64)
        if noise_type == 0:
            f_us = 2 * eta_u * (eta_u - 0.5) ** 2
        elif noise_type == 1:
            f_us = np.where(eta_u >= 0.5, 1 - eta_u, eta_u)
        elif noise_type == 2:
            f_us = -2 * (eta_u - 0.5) ** 2 + 0.5
        else:
            raise ValueError(f"noise_type must be 0/1/2, got {noise_type}")
        ones = y == 1
        # class-1 samples keep label 1 with prob 1-f (reference :163-168)
        draws = rng.binomial(1, np.clip(1 - f_us, 0, 1))
        new_y = np.where(ones, draws, y).astype(y.dtype)
        count = int(np.sum(ones & (new_y == 0)))
        return new_y, f_us, count

    eta_u, eta_s, u, s = _top2(np.asarray(eta, np.float64))
    delta = np.abs(eta_u - eta_s)
    if noise_type == 0:
        f_us = -0.5 * delta**2 + 0.5
        noise_level = np.maximum(1 - f_us, 0.5)
    elif noise_type == 1:
        f_us = 1 - delta**3
        noise_level = 1 - f_us
    elif noise_type == 2:
        f_us = 1 - (delta**3 + delta**2 + delta) / 3.0
        noise_level = 1 - f_us
    else:
        raise ValueError(f"noise_type must be 0/1/2, got {noise_type}")

    noise_ind = rng.binomial(1, np.clip(noise_level / factor, 0, 1))
    new_y = (noise_ind * u + (1 - noise_ind) * s).astype(y.dtype)
    count = int(np.sum(new_y != y))
    return new_y, f_us, count


def lrt_correction(
    y_noise: np.ndarray,
    f_x: np.ndarray,
    current_delta: float = 0.3,
    delta_increment: float = 0.1,
) -> Tuple[np.ndarray, float]:
    """Likelihood-ratio-test label correction (PLC/utils.py:291-318)."""
    y = np.asarray(y_noise).copy()
    f_x = np.asarray(f_x, np.float64)
    rows = np.arange(len(y))
    f_m = f_x.max(axis=1)
    y_mle = f_x.argmax(axis=1)
    lr = f_x[rows, y] / np.maximum(f_m, 1e-300)
    flip = lr < current_delta
    y[flip] = y_mle[flip]
    if int(flip.sum()) < 0.001 * len(y):
        current_delta = min(current_delta + delta_increment, 0.9)
    return y, current_delta


def cap_flips(
    y: np.ndarray,
    new_y: np.ndarray,
    p: np.ndarray,
    max_flip_frac: float,
) -> np.ndarray:
    """Cap one correction pass to `max_flip_frac` of the labels, keeping the
    most-confident flips (largest p[new] − p[old] margin).

    A safety valve over the reference semantics (no counterpart in
    PLC/utils.py): correction on an immature model confirms itself, so one
    early pass can flip a large share of the labels onto a few classes.
    `max_flip_frac=1.0` is the uncapped reference behavior."""
    y, new_y = np.asarray(y), np.asarray(new_y)
    flips = np.nonzero(new_y != y)[0]
    # round, don't truncate: 0.29*100 is 28.999999999999996 in floats
    cap = int(round(max_flip_frac * len(y)))
    if len(flips) <= cap:
        return new_y
    margin = p[flips, new_y[flips]] - p[flips, y[flips]]
    keep = flips[np.argsort(-margin)[:cap]]
    capped = y.copy()
    capped[keep] = new_y[keep]
    return capped


def prob_correction(
    y_noise: np.ndarray,
    f_x: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    current_delta: float = 0.3,
    delta_increment: float = 0.1,
    thd: float = 0.1,
    top_k: int = 1,
) -> Tuple[np.ndarray, float]:
    """Probabilistic label correction (PLC/utils.py:321-360).

    top_k=1 reproduces the reference exactly (its low-confidence branch
    renormalizes a single top-1 prob, i.e. deterministically flips to the
    argmax); top_k>1 samples over the top-k classes.
    """
    rng = rng or np.random.default_rng(0)
    y = np.asarray(y_noise).copy()
    logits = np.asarray(f_x, np.float64)
    z = logits - logits.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)

    rows = np.arange(len(y))
    order = np.argsort(p, axis=1)[:, ::-1]
    top_idx = order[:, 0]
    top_prob = p[rows, top_idx]

    confident = top_prob >= thd
    # confident branch: LRT flip to argmax (counted)
    lrt_flip = confident & (p[rows, y] / np.maximum(top_prob, 1e-300) < current_delta)
    y[lrt_flip] = top_idx[lrt_flip]
    correction_count = int(lrt_flip.sum())

    # low-confidence branch: sample from renormalized top-k (k=1 → argmax)
    low = ~confident
    if low.any():
        if top_k == 1:
            y[low] = top_idx[low]
        else:
            idx_k = order[low, :top_k]                    # (m, k)
            probs_k = p[np.nonzero(low)[0][:, None], idx_k]
            probs_k /= probs_k.sum(axis=1, keepdims=True)
            cum = probs_k.cumsum(axis=1)
            draws = rng.random(size=(idx_k.shape[0], 1))
            # clamp: float cumsum can end at 1-ε, letting a draw "pass" all bins
            choice = np.minimum((draws > cum).sum(axis=1), top_k - 1)
            y[low] = idx_k[np.arange(idx_k.shape[0]), choice]

    if not correction_count:
        current_delta += delta_increment
    return y, current_delta


def probe_init(d: int, num_classes: int, hidden: int = 0,
               seed: int = 77) -> Dict[str, torch.Tensor]:
    """The probe's f32 parameters on the CPU, He-normal kernels (std
    √(2/d) and √(2/hidden) with a hidden layer, √(1/d) without) and zero
    biases, drawn from a `torch.Generator` seeded with `seed` — the JAX
    function's shapes and scales (it draws from `jax.random`, whose bits
    torch cannot reproduce: tests pass JAX's draw as `init`)."""
    g = torch.Generator().manual_seed(seed)
    if hidden:
        return {"w1": torch.randn(d, hidden, generator=g) * (2.0 / d) ** 0.5,
                "b1": torch.zeros(hidden),
                "w2": torch.randn(hidden, num_classes, generator=g)
                * (2.0 / hidden) ** 0.5,
                "b2": torch.zeros(num_classes)}
    return {"w": torch.randn(d, num_classes, generator=g) * (1.0 / d) ** 0.5,
            "b": torch.zeros(num_classes)}


def _probe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if "w1" in p:
        return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return x @ p["w"] + p["b"]


def eta_approximation(
    features: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    n_epochs: int = 5,
    lr: float = 0.01,
    batch_size: int = 128,
    hidden: int = 0,
    seed: int = 77,
    device: torch.device = torch.device("cpu"),
    init: Optional[Dict[str, np.ndarray]] = None,
) -> np.ndarray:
    """Estimate η(x) = P(Y|X=x) with a probe classifier (PLC/utils.py:223-288).

    Fits the probe (`probe_init`, or the parameters `init` gives) on
    (features, labels) on `device` in f32: n_epochs passes over the
    n // batch_size whole batches in order, mean softmax-CE, SGD with
    momentum 0.9, Nesterov and weight decay 5e-4 added to the gradient
    (optax's `add_decayed_weights` before `sgd`). Returns the (n, C) f32
    softmax collected in the last epoch, each batch's with the parameters
    before its update, and the leftover rows past the whole batches
    through the final parameters."""
    n, d = features.shape
    n_batches = max(n // batch_size, 1)
    usable = min(n_batches * batch_size, n)
    device = torch.device(device)
    start = (probe_init(d, num_classes, hidden, seed) if init is None
             else {k: torch.from_numpy(np.asarray(v, np.float32))
                   for k, v in init.items()})
    params = [start[k].to(device).requires_grad_() for k in sorted(start)]
    named = dict(zip(sorted(start), params))
    opt = torch.optim.SGD(params, lr=lr, momentum=0.9, nesterov=True,
                          weight_decay=5e-4)
    xs = torch.from_numpy(np.asarray(features[:usable], np.float32)).to(device)
    ys = torch.from_numpy(np.asarray(labels[:usable], np.int64)).to(device)
    xs = xs.reshape(n_batches, -1, d)
    ys = ys.reshape(n_batches, -1)
    probs = []
    for epoch in range(max(n_epochs, 1)):
        last = epoch == max(n_epochs, 1) - 1
        for b in range(n_batches):
            logits = _probe_apply(named, xs[b])
            if last:
                probs.append(torch.softmax(logits.detach(), dim=-1))
            loss = torch.nn.functional.cross_entropy(logits, ys[b])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    eta = np.zeros((n, num_classes), np.float32)
    eta[:usable] = torch.cat(probs).cpu().numpy()
    if usable < n:
        with torch.no_grad():
            tail = torch.from_numpy(np.asarray(features[usable:], np.float32))
            eta[usable:] = torch.softmax(
                _probe_apply(named, tail.to(device)), dim=-1).cpu().numpy()
    return eta
