"""Attention ops of the port — the JAX package's `ops/attention.py`: the
dense `attention` and exact ring attention over a token axis sharded
across a model group (`ring_attention`).

The ring (JAX `:72-245`): each rank holds (B, T/N, H, D) shards of q, k
and v; N visits pass the KV shards around the group (shard i → i + 1,
`parallel/collectives.py::ppermute`) and fold each visiting block into
the rows' running softmax in f32, so the result is dense attention. Two
bodies, as in JAX:

- the einsum body (`_block_update`): the visiting block's scores, the
  online (m, l, o) rescaling, the causal mask by the block's source rank;
- the flash body: K2 (`flash_forward`) consumes each visiting block and
  its (out, lse) pairs merge in f32; the resident block runs the causal
  kernel under `causal`, and blocks wholly in the queries' future
  contribute nothing (skipped: JAX's zeros at lse −1e30 leave the merge
  unchanged, with no NaN).

torch's point-to-point ops have no gradient, so the ring is one
`autograd.Function` whose backward runs a second ring carrying K, V, dK
and dV (what JAX gets from `ppermute`'s transpose): per visit, with the
merged rows' lse and Δ = rowsum(dO ⊙ O), K3 and K4 (their plain
versions under the einsum body) give dQ and the visiting block's dK and
dV, which travel on with it and reach their owner after one more hop.

The bodies are generators that yield what they hand to the next rank and
receive what the previous one handed on, so one body runs two ways: over
the group's point-to-point exchange (`ring_attention`) and in lockstep
over N shards held by one process (`ring_attention_shards`, the seam
that `chip_smoke.py` and the tests reach; no CLI path does, and nothing
falls back to it).
"""

from __future__ import annotations

from typing import Any, Generator, List, Optional, Sequence, Tuple

import torch

from ..parallel.collectives import Group, axis_index, axis_size, ppermute
from . import flash_attention as fa
from .flash_attention import _supported, _to3, _to4

_NEG_INF = -1e30  # finite stand-in for -inf, as in the JAX package


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, scale: Optional[float] = None
              ) -> torch.Tensor:
    """Dense scaled-dot-product attention, (B, T, H, D) → (B, T, H, D) in
    q's dtype: scores and softmax in f32, P cast to v's dtype before P·V
    (f32 accumulation), as `attention.py:47-69`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(tk, device=s.device)[None, :]
                <= torch.arange(tq, device=s.device)[:, None])
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _block_update(q3, kb, vb, m, l, o, scale: float, mask=None):
    """One online-softmax step against a KV block (JAX `_block_update`),
    in the (BH, T, D) layout: q3 (BH, Tq, D); kb, vb (BH, Tk, D); m, l
    (BH, Tq, 1) f32; o (BH, Tq, D) f32; mask (Tq, Tk) bool, True =
    attend."""
    s = torch.matmul(q3.float(), kb.float().transpose(1, 2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(vb.dtype).float(), vb.float())
    return m_new, l_new, o * corr + pv


def _causal_mask(index: int, src: int, t: int, device) -> torch.Tensor:
    """(t, t) bool: the keys of shard `src` each query of shard `index`
    may see, by global token position."""
    q_pos = index * t + torch.arange(t, device=device)
    k_pos = src * t + torch.arange(t, device=device)
    return k_pos[None, :] <= q_pos[:, None]


Body = Generator[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...], Any]


def _ring_forward(q3, k3, v3, index: int, size: int, causal: bool,
                  scale: float, use_flash: bool) -> Body:
    """The forward ring of shard `index`; returns (out3 in q's dtype, the
    merged rows' lse (BH, Tl, 1) f32)."""
    bh, t, d = q3.shape
    kb, vb = k3, v3
    if use_flash:
        o, m = fa.flash_forward(q3, k3, v3, scale, causal)
        l, o = torch.ones_like(m), o.float()
        for step in range(1, size):
            kb, vb = yield kb, vb
            if causal and (index - step) % size > index:
                continue  # wholly in the queries' future
            o_i, lse_i = fa.flash_forward(q3, kb, vb, scale, False)
            m_new = torch.maximum(m, lse_i)
            c_run, c_vis = torch.exp(m - m_new), torch.exp(lse_i - m_new)
            l = l * c_run + c_vis
            o = o * c_run + o_i.float() * c_vis
            m = m_new
    else:
        m = torch.full((bh, t, 1), _NEG_INF, device=q3.device)
        l = torch.zeros((bh, t, 1), device=q3.device)
        o = torch.zeros((bh, t, d), device=q3.device)
        for step in range(size):
            if step:
                kb, vb = yield kb, vb
            src = (index - step) % size
            mask = _causal_mask(index, src, t, q3.device) if causal else None
            m, l, o = _block_update(q3, kb, vb, m, l, o, scale, mask)
    return (o / l).to(q3.dtype), m + torch.log(l)


def _ring_backward(q3, k3, v3, out3, lse, do3, index: int, size: int,
                   causal: bool, scale: float, use_flash: bool) -> Body:
    """The backward ring of shard `index`; returns (dq3, dk3, dv3) in the
    operands' dtypes, accumulated in f32."""
    dq_fn, dkv_fn = ((fa.flash_dq, fa.flash_dkv) if use_flash
                     else (fa.flash_dq_ref, fa.flash_dkv_ref))
    dsum = (do3.float() * out3.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros(q3.shape, device=q3.device)
    kb, vb = k3, v3
    dkb = torch.zeros(k3.shape, device=k3.device)
    dvb = torch.zeros(v3.shape, device=v3.device)
    for step in range(size):
        if step:
            kb, vb, dkb, dvb = yield kb, vb, dkb, dvb
        src = (index - step) % size
        if causal and src > index:
            continue
        diag = causal and step == 0
        dq = dq + dq_fn(q3, kb, vb, do3, lse, dsum, scale, diag).float()
        dk_i, dv_i = dkv_fn(q3, kb, vb, do3, lse, dsum, scale, diag)
        dkb, dvb = dkb + dk_i.float(), dvb + dv_i.float()
    dkb, dvb = yield dkb, dvb  # one more hop: home to the owner
    return dq.to(q3.dtype), dkb.to(k3.dtype), dvb.to(v3.dtype)


def _drive(body: Body, exchange) -> Any:
    """Run one shard's body, handing what it yields to `exchange` and
    sending back what that returns."""
    try:
        msg = next(body)
        while True:
            msg = body.send(exchange(msg))
    except StopIteration as stop:
        return stop.value


def _drive_lockstep(bodies: Sequence[Body]) -> List[Any]:
    """Run N shards' bodies in one process, step by step: shard i receives
    what shard i − 1 yielded (the ring's exchange, by list index)."""
    n = len(bodies)
    results: List[Any] = [None] * n
    msgs: List[Any] = []
    for i, body in enumerate(bodies):
        try:
            msgs.append(next(body))
        except StopIteration as stop:
            results[i] = stop.value
            msgs.append(None)
    while any(m is not None for m in msgs):
        incoming = [msgs[(i - 1) % n] for i in range(n)]
        for i, body in enumerate(bodies):
            try:
                msgs[i] = body.send(incoming[i])
            except StopIteration as stop:
                results[i], msgs[i] = stop.value, None
    return results


class _Ring(torch.autograd.Function):
    """Ring attention over a model group: forward ring, backward ring."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, scale: float,
                use_flash: bool):
        b, _, h, _ = q.shape
        q3, k3, v3 = _to3(q), _to3(k), _to3(v)
        index, size = axis_index(group), axis_size(group)
        out3, lse = _drive(
            _ring_forward(q3, k3, v3, index, size, causal, scale, use_flash),
            lambda ts: ppermute(ts, group))
        ctx.save_for_backward(q3, k3, v3, out3, lse)
        ctx.args = (group, causal, scale, use_flash, b, h)
        return _to4(out3, b, h)

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, out3, lse = ctx.saved_tensors
        group, causal, scale, use_flash, b, h = ctx.args
        dq3, dk3, dv3 = _drive(
            _ring_backward(q3, k3, v3, out3, lse, _to3(g.to(q3.dtype)),
                           axis_index(group), axis_size(group), causal,
                           scale, use_flash),
            lambda ts: ppermute(ts, group))
        return (_to4(dq3, b, h), _to4(dk3, b, h), _to4(dv3, b, h), None,
                None, None, None)


def shard_tokens(x: torch.Tensor, group: Group, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous slice of `x`'s token axis; ValueError (JAX's
    text) when the group's size does not divide it."""
    n = axis_size(group)
    t = x.shape[dim]
    if t % n:
        raise ValueError(f"sequence length {t} not divisible by ring size "
                         f"{n} (mesh axis 'model')")
    return x.narrow(dim, axis_index(group) * (t // n), t // n)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Group = None, causal: bool = False,
                   scale: Optional[float] = None,
                   use_flash: bool = False) -> torch.Tensor:
    """Exact attention over (B, T, H, D). With a model `group` of N > 1
    ranks, q, k and v are this rank's (B, T/N, H, D) token shards and the
    result is its shard of the output: the ring, through the flash body
    where `use_flash` and the kernels tile T/N, else the einsum body. On
    one shard `use_flash` goes to the flash kernels (which route
    untileable T to the dense op) and anything else to the dense op
    (`attention.py:211-220`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if axis_size(group) > 1:
        return _Ring.apply(q, k, v, group, bool(causal), float(scale),
                           use_flash and _supported(q.shape[1]))
    if use_flash:
        return fa.flash_attention(q, k, v, scale=scale, causal=causal)
    return attention(q, k, v, causal=causal, scale=scale)


def ring_attention_shards(qs: Sequence[torch.Tensor],
                          ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor],
                          dos: Optional[Sequence[torch.Tensor]] = None,
                          causal: bool = False, scale: Optional[float] = None,
                          use_flash: bool = False):
    """The ring over N token shards held by this one process, the bodies
    in lockstep: the outputs' shards, and with the output cotangents
    `dos` also (dqs, dks, dvs). Same bodies, kernels and merges as
    `ring_attention` over a group of N ranks."""
    n = len(qs)
    b, t, h, d = qs[0].shape
    if scale is None:
        scale = d ** -0.5
    flash = use_flash and _supported(t)
    q3s, k3s, v3s = ([_to3(x) for x in xs] for xs in (qs, ks, vs))
    fwd = _drive_lockstep([
        _ring_forward(q3s[i], k3s[i], v3s[i], i, n, causal, scale, flash)
        for i in range(n)])
    outs = [_to4(o, b, h) for o, _ in fwd]
    if dos is None:
        return outs
    bwd = _drive_lockstep([
        _ring_backward(q3s[i], k3s[i], v3s[i], fwd[i][0], fwd[i][1],
                       _to3(dos[i].to(qs[i].dtype)), i, n, causal, scale,
                       flash)
        for i in range(n)])
    return outs, tuple([_to4(g[j], b, h) for g in bwd] for j in range(3))
