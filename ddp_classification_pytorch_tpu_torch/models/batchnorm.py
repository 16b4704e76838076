"""flax's `nn.BatchNorm` in PyTorch, with global batch statistics across
ranks — the BatchNorm of the JAX package's `models/resnet.py:136-141`
(flax 0.12.3, momentum 0.9, epsilon 1e-5, `axis_name` for the data axis)
and of TResNet's identity ABNs (`models/tresnet.py:63-67` there).

Training mode computes f32 batch statistics as flax does (f64 ones in an
f64 net, as flax's promotion gives):
mean = E[x], var = max(E[x²] − E[x]², 0), and y = (x − mean)·(rsqrt(var +
eps)·γ) + β in f32, written in x's dtype. The running statistics take
ra = 0.9·ra + 0.1·batch with the *biased* batch variance (torch's
`nn.SyncBatchNorm` and `nn.BatchNorm2d` take the unbiased one, a result
that differs from the JAX package's).

With a process group of more than one rank (`process_group`), the
per-channel means of x and x² are averaged across the ranks by an
autograd-aware all-reduce (`torch.distributed.nn.functional.all_reduce`)
before the variance is formed: flax's `lax.pmean` over `axis_name`
(`parallel/collectives.py:11` on the JAX side). Every rank holds the same
number of rows (the loader pads each rank's shard to whole batches), so the
mean of the ranks' means is the global mean. The backward of that
all-reduce sums the statistics' gradients across the ranks, so each
rank's input gradient is the global batch's. Without a group (or with one
rank) nothing is exchanged and the forward is the plain one.

Under `--remat` (`models/remat.py`) a block's backward recomputes its
forward: the recompute normalizes with the same batch statistics (and
exchanges them again under a group) but skips the running update, which
the forward made, so the statistics are a plain step's, bitwise.

`frozen` (the NESTED workload's freeze-BN): training mode normalizes with
the running statistics as eval mode does, updates none of them and
exchanges nothing, while the gradients still flow to x, γ and β — flax's
`use_running_average=True` with `axis_name=None` (JAX
`models/resnet.py:136-141`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .remat import recomputing

MOMENTUM = 0.9  # flax BatchNorm's: ra = MOMENTUM·ra + (1 − MOMENTUM)·batch


def _global_means(mean: torch.Tensor, mean2: torch.Tensor,
                  group) -> tuple:
    """The ranks' average of the (C,) means of x and x², as one all-reduce
    of a (2, C) tensor that autograd differentiates through."""
    from torch.distributed.nn.functional import all_reduce

    both = all_reduce(torch.stack([mean, mean2]), group=group)
    both = both / dist.get_world_size(group)
    return both[0], both[1]


class BatchNorm(nn.Module):
    """BatchNorm over (N, C, H, W) with flax's statistics and running
    update. Eval mode: `F.batch_norm` on the f32 running statistics, output
    in x's dtype. Holds `weight`, `bias`, `running_mean` and `running_var`
    as `BatchNorm2d` does (no `num_batches_tracked`).

    `process_group`: the group whose ranks share the batch statistics in
    training (None: this process's batch only). `frozen`: training mode
    takes eval mode's forward."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 process_group: Optional[dist.ProcessGroup] = None,
                 frozen: bool = False):
        super().__init__()
        self.eps = eps
        self.process_group = process_group
        self.frozen = frozen
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """ra = MOMENTUM·ra + (1 − MOMENTUM)·batch for mean and var."""
        with torch.no_grad():
            stats = [self.running_mean, self.running_var]
            torch._foreach_mul_(stats, MOMENTUM)
            torch._foreach_add_(stats, [mean.detach(), var.detach()],
                                alpha=1 - MOMENTUM)

    def synced(self) -> bool:
        """Whether training mode averages the statistics across ranks."""
        g = self.process_group
        return g is not None and dist.get_world_size(g) > 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.frozen or not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # f32 math for the 16- and 32-bit dtypes; an f64 net keeps f64
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
        if self.synced():
            mean, mean2 = _global_means(mean, mean2, self.process_group)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        if not recomputing():  # a remat block's recompute: made already
            self.update_running(mean, var)
        return y.to(x.dtype)
