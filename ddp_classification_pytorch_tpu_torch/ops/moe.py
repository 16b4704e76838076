"""Mixture-of-experts FFN — the port of the JAX package's `ops/moe.py` on
one device: dropless split-FFN experts with dense dispatch and sparse
top-k gates.

- `router_logits` (JAX `moe.py:39-43`): (B, T, C) × (C, E) → (B, T, E) in
  f32, computed once a block; the gates and the balance penalty both read
  it.
- `topk_gates` (`:46-55`): softmax over each token's top-k logits,
  scattered into zeros (B, T, E); the gradient reaches the chosen logits
  only, as JAX's one-hot einsum gives. `top_k` outside [1, E] is a
  ValueError.
- `load_balance_loss` (`:58-74`): E·Σ_e f_e·p_e, f_e the share of tokens
  whose top-k holds e (a detached count, JAX's stop-gradient) and p_e the
  mean full-softmax probability of e.
- `moe_mlp` (`:93-143`; one expert shard first): every expert runs every
  token, h = gelu(x·W_in + b_in) and y = h·W_out + b_out per expert, then
  the gate-weighted sum over the experts, returned in x's dtype. A gates
  width other than E is a ValueError.

The numerics are the JAX module's: the expert products take the compute
dtype's operands and give f32 (`preferred_element_type=f32`), so h stays
f32 through its bias and the tanh GELU and is cast to the compute dtype
only as the second product's operand; y's bias and the gate combine are
f32. `_MatmulF32` gives that product: on the card cuBLAS's bf16 product
with an f32 result (`torch.mm` / `torch.bmm` with `out_dtype`), on the
CPU (which has no such kernel) the f32 product of the same bf16-rounded
operands; the route follows the tensors' device. Its backward gives each
operand's gradient in the operand's dtype, as JAX's transpose does; on
the card the f32 cotangent is rounded to bf16 for the product (the bf16
products of a TPU's default precision), on the CPU it is not (JAX's f32
product on the CPU).

Expert parallelism (`moe.py:121-143`): with a model `group` of N ranks
each rank holds E/N experts (its contiguous slice of the banks), slices
its E/N gate columns, mixes its experts over every token, and one `psum`
over the group completes the combine. The tokens and the gates enter
through `copy_to`, so their gradients are the sum of every shard's
(JAX's transpose of a replicated shard_map input); the combine's `psum`
passes the replicated output's cotangent to each shard's partial. An E
the group does not divide is JAX's ValueError. `moe_mlp_shards` runs the
N shards' mixes in one process and sums them (the in-process seam that
`chip_smoke.py` and the tests reach; no CLI path does).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import Group, axis_index, axis_size, copy_to, psum


def router_logits(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """(B, T, C) tokens × (C, E) router → (B, T, E) f32 logits."""
    return torch.matmul(x.float(), router_w.float())


def topk_gates(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """(B, T, E) router logits → (B, T, E) gate weights: softmax over the
    top-k logits of each token, zero elsewhere."""
    e = logits.shape[-1]
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k={top_k} must be in [1, num_experts={e}]")
    vals, idx = torch.topk(logits, top_k, dim=-1)
    return torch.zeros_like(logits).scatter(-1, idx,
                                            torch.softmax(vals, dim=-1))


def load_balance_loss(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Switch-Transformer-style balance penalty E·Σ_e f_e·p_e: top_k
    under a uniform router, larger as routing collapses; differentiable
    through p_e only."""
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    idx = torch.topk(logits, top_k, dim=-1).indices
    chosen = torch.zeros_like(logits).scatter_(-1, idx, 1.0)
    f = chosen.detach().reshape(-1, e).mean(dim=0)
    p = probs.reshape(-1, e).mean(dim=0)
    return e * torch.sum(f * p)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D, or 3-D batched) with an f32 result: f32 operands take
    the f32 product; otherwise the card's bf16 product with f32 output, or
    on the CPU the f32 product of the operands as they are."""
    if a.dtype == b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _MatmulF32(torch.autograd.Function):
    """a @ b with an f32 result (`_product`); the gradients in the
    operands' dtypes."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return _product(a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _product(g, b.mT).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _product(a.mT, g).to(b.dtype)
        return ga, gb


def _expert_mix(x: torch.Tensor, gates: torch.Tensor, w_in: torch.Tensor,
                b_in: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Σ over the e experts of `w_in` (e, C, H) … of gate × FFN output, for
    every token: (B, T, C) f32 (JAX `_expert_mix`)."""
    e, c, h = w_in.shape
    b, t = x.shape[:2]
    xc = x.to(dtype).reshape(b * t, c)
    # every expert's first product as one (BT, C) × (C, e·H) product
    w1 = w_in.to(dtype).permute(1, 0, 2).reshape(c, e * h)
    hid = _MatmulF32.apply(xc, w1).view(b * t, e, h) + b_in
    hid = F.gelu(hid, approximate="tanh")
    # (e, BT, H) × (e, H, C) → (e, BT, C), f32
    y = _MatmulF32.apply(hid.to(dtype).transpose(0, 1), w_out.to(dtype))
    y = y + b_out[:, None, :]
    # Σ_e gate[bt, e]·y[e, bt, :] as (BT, 1, e) × (BT, e, C), in f32
    out = torch.bmm(gates.reshape(b * t, 1, e).float(), y.transpose(0, 1))
    return out.view(b, t, c)


def _check_experts(gates: torch.Tensor, e_local: int, n: int) -> None:
    e = gates.shape[-1]
    if n > 1 and e % n:
        raise ValueError(f"num experts {e} not divisible by axis size {n}")
    if e != e_local * n:
        raise ValueError(f"gates width {e} != num experts {e_local * n}")


def moe_mlp(x: torch.Tensor, gates: torch.Tensor, w_in: torch.Tensor,
            b_in: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
            dtype: torch.dtype = torch.bfloat16,
            group: Group = None) -> torch.Tensor:
    """Mixture-of-experts FFN over (B, T, C) tokens: `gates` (B, T, E) from
    `topk_gates`; the banks w_in (E/N, C, H), b_in (E/N, H), w_out
    (E/N, H, C), b_out (E/N, C), f32, this rank's experts of the model
    `group` (N = 1 without one). Returns (B, T, C) in x's dtype."""
    n = axis_size(group)
    _check_experts(gates, w_in.shape[0], n)
    if n == 1:
        return _expert_mix(x, gates, w_in, b_in, w_out, b_out,
                           dtype).to(x.dtype)
    e_local = w_in.shape[0]
    lo = axis_index(group) * e_local
    g_local = copy_to(gates, group)[..., lo:lo + e_local]
    part = _expert_mix(copy_to(x, group), g_local, w_in, b_in, w_out, b_out,
                       dtype)
    return psum(part, group).to(x.dtype)  # the EP combine


def moe_mlp_shards(x: torch.Tensor, gates: torch.Tensor,
                   banks: Sequence[Tuple[torch.Tensor, ...]],
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """`moe_mlp` over N expert shards held by this one process: each
    shard's (w_in, b_in, w_out, b_out) mixes its gate columns over every
    token, and the partial combines are summed in shard order."""
    n = len(banks)
    e_local = banks[0][0].shape[0]
    _check_experts(gates, e_local, n)
    total: Optional[torch.Tensor] = None
    for i, bank in enumerate(banks):
        part = _expert_mix(x, gates[..., i * e_local:(i + 1) * e_local],
                           *bank, dtype)
        total = part if total is None else total + part
    return total.to(x.dtype)
