"""Step functions of the port — the JAX package's `train/steps.py` for
serving (the uint8 input epilogue, the top-k predict) and for training
(`make_train_step`, `make_eval_step`, `make_nested_eval_step`), for the
heads fc, arcface and nested and the CDR gradient transform, and PLC's
ordered f(x) pass (`make_predict_step`).

PyTorch runs eagerly, so a "step" here is a plain function over the state
and device tensors; there is nothing to trace or compile.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import Config
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD, preset_for_dataset
from ..ops.cdr import cdr_clip, cdr_mask_
from ..ops.nested import nested_all_k_counts, nested_k, prefix_mask
from ..parallel import ddp
from ..utils.metrics import topk_correct, topk_hits

if TYPE_CHECKING:
    from .state import TrainState

# the JAX step derives its flip stream as fold_in(step_key, _FLIP_FOLD)
_FLIP_FOLD = 0x464C4950  # "FLIP"


def device_input_epilogue(images: torch.Tensor, mean: torch.Tensor,
                          std: torch.Tensor,
                          flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 wire → normalized float32, on the device.

    `images` is (B, 3, H, W), the NCHW view of NHWC pixels (channels_last in
    memory); `mean`/`std` are the ImageNet constants as (1, 3, 1, 1) f32 on
    the same device. `(x/255 − μ)/σ` in f32 in the op order of the JAX
    epilogue (`steps.py:86-87`), then, where `flip` (a (B,) bool mask on
    the same device) is set, the sample mirrored along W (dim 3): the
    train-time flip that the uint8 wire moves off the host, after
    normalization as in JAX (`steps.py:88-93`). float32 inputs pass
    through untouched (the host-normalized wire flipped on the host).
    Serving and evaluation never flip."""
    if images.dtype != torch.uint8:
        return images
    x = images.float() / 255.0
    x = (x - mean) / std
    if flip is not None:
        x = torch.where(flip.view(-1, 1, 1, 1), x.flip(3), x)
    return x


def _train_flip_enabled(cfg: Config) -> bool:
    """The device flip applies exactly where the float32 wire would have
    flipped on the host: the uint8 wire and a dataset with an image preset
    (synthetic data has none, so never flips) — the JAX
    `_train_flip_enabled` (`steps.py:96-102`)."""
    return (cfg.data.input_dtype == "uint8"
            and preset_for_dataset(cfg.data.dataset, cfg.data.transform)
            is not None)


def flip_mask(seed: int, step: int, n: int) -> np.ndarray:
    """(n,) bool: which samples the train step at `step` flips. Drawn from a
    generator keyed on (seed + 1, step, _FLIP_FOLD), the key the JAX step
    folds (`fold_in(fold_in(PRNGKey(seed + 1), step), FLIP)`), so a resumed
    run draws the masks the uninterrupted run drew. torch cannot reproduce
    `jax.random`'s bits: parity tests pass the JAX mask to the step."""
    return np.random.default_rng((seed + 1, step, _FLIP_FOLD)).random(n) < 0.5


def make_topk_predict_step(
    cfg: Config, k: int
) -> Callable[[nn.Module, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """`(model, images (B, H, W, 3)) -> (probs (B, k) f32, indices (B, k)
    int32)` — the serving engine's predict (serve/engine.py).

    `images` lies on the model's device in the wire dtype; the NCHW view
    `permute(0, 3, 1, 2)` of the NHWC batch is already channels_last, so no
    copy is made. The forward runs in eval mode on the running statistics
    under `torch.inference_mode()`; softmax runs on the f32 logits, then
    top-k, so only (B, k) values leave the device. Eval mode has no
    cross-sample op, so bucket padding cannot perturb real rows. The
    arcface head scores s·cosθ and the nested head its unmasked logits
    (`labels` / `mask` None; JAX `steps.py:807-845`)."""
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def step(model: nn.Module, images: torch.Tensor):
        mean, std = _cached_consts(consts, images.device)
        with torch.inference_mode():
            x = device_input_epilogue(images.permute(0, 3, 1, 2), mean, std)
            logits = model(x)  # the heads' labels / mask default to None
            probs = torch.softmax(logits.float(), dim=-1)
            vals, idx = torch.topk(probs, min(k, probs.shape[-1]), dim=-1)
        return vals, idx.to(torch.int32)

    return step


def _consts(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(a).view(1, 3, 1, 1).to(device)
                 for a in (IMAGENET_MEAN, IMAGENET_STD))


def _cached_consts(consts: Dict, device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std on `device`, made once per device."""
    if device not in consts:
        consts[device] = _consts(device)
    return consts[device]


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax-CE on f32 logits (the reference's LogSoftmax + NLLLoss
    pair, BASELINE/main.py:139,152)."""
    return F.cross_entropy(logits.float(), labels.long())


def _global_metrics(loss: torch.Tensor, logits: torch.Tensor,
                    labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The global batch's mean loss and top-1/top-3 shares: this rank's
    loss and counts summed across the ranks in one all-reduce (the JAX
    `pmean(loss)` and `psum` of the counts, `collectives.py:79,86-88`);
    this rank's own without a group."""
    world = ddp.world_size()
    n = labels.shape[0] * world
    packed = ddp.sum_across(torch.stack([
        loss.detach().float(), topk_correct(logits, labels, 1).float(),
        topk_correct(logits, labels, 3).float()]))
    return {"loss": packed[0] / world, "top1": packed[1] / n,
            "top3": packed[2] / n}


def _forward(cfg: Config, net: nn.Module, x: torch.Tensor,
             labels: torch.Tensor, k: Optional[int]) -> torch.Tensor:
    """The training forward of the head (JAX `_dense_loss_fn`,
    `steps.py:261-295`): arcface feeds the labels to the margin head;
    nested masks the features to the first k + 1 dims; fc is the plain
    forward. DDP passes the extra argument on."""
    head = cfg.model.head
    if head == "arcface":
        return net(x, labels.long())
    if head == "nested":
        d = getattr(net, "module", net).feat_dim  # DDP wraps the model
        return net(x, prefix_mask(k, d, device=x.device))
    return net(x)


def make_train_step(cfg: Config) -> Callable[..., Dict[str, torch.Tensor]]:
    """`(state, images (B, H, W, 3), labels (B,)) -> metrics`, updating
    `state` in place — the JAX `_build_step` for every ported head.

    uint8 epilogue with the train-time flip where `_train_flip_enabled`
    (the mask `flip_mask(run.seed, state.step, B)`, or the `flip` (B,) bool
    array the caller passes: parity tests pass the JAX step's), forward
    in train mode (through `state.ddp`, the DistributedDataParallel
    wrapper, when there is one) by head (`_forward`; the nested head's k
    is `nested_k(run.seed, state.step, D, model.nested_std)`, or the `k`
    the caller passes: parity tests pass the JAX step's), f32 CE, backward
    (DDP averages the gradients across the ranks in it), global grad norm
    over every parameter (freeze-BN's too, as JAX's), then the skip-step
    gate: `step_ok = isfinite(loss) & isfinite(grad_norm)`. The gate is
    global: the loss is the global batch's mean (summed across the ranks
    before it is read, the JAX loss over the global batch) and the grad
    norm is that of the averaged gradients, so one rank's non-finite
    sample makes every rank skip and the replicas stay equal. A passing
    step applies CDR's mask to the averaged gradients where
    `optim.grad_transform` is "cdr" (`ops/cdr.py`; every rank holds the
    same gradients and weights, so every rank masks alike), sets each
    group's lr from its schedule at the count of updates applied so far
    and steps the optimizer; a failing one leaves the parameters, the
    optimizer state, that count and the model's buffers (the BN running
    statistics, which the forward updates) as they were. The step counter
    always advances. The gate reads `step_ok` on the host once per step
    (the JAX step selects on the device instead). Metrics are 0-d tensors
    of the global batch: loss, top1, top3 (of the logits the CE read: the
    margin logits for arcface, the masked ones for nested), step_ok,
    grad_norm."""
    if cfg.optim.grad_transform not in ("none", "cdr"):
        raise ValueError(f"unknown optim.grad_transform "
                         f"{cfg.optim.grad_transform!r}; one of none, cdr")
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
    flips = _train_flip_enabled(cfg)
    seed, o = cfg.run.seed, cfg.optim
    cdr = o.grad_transform == "cdr"

    def step(state: "TrainState", images: torch.Tensor, labels: torch.Tensor,
             flip: Optional[np.ndarray] = None,
             k: Optional[int] = None) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        net = model if state.ddp is None else state.ddp
        mask = None
        if flips:
            if flip is None:
                flip = flip_mask(seed, state.step, images.shape[0])
            mask = torch.from_numpy(flip).to(images.device, non_blocking=True)
        x = device_input_epilogue(images.permute(0, 3, 1, 2),
                                  *_cached_consts(consts, images.device), mask)
        if cfg.model.head == "nested" and k is None:
            k = nested_k(seed, state.step, model.feat_dim,
                         cfg.model.nested_std)
        model.train()
        # every parameter's, not only the optimizer's: freeze-BN's params
        # are in no group but still get (and must not accumulate) gradients
        model.zero_grad(set_to_none=True)
        # the buffers as they were, for a skipped step (x·1 is a bitwise
        # copy; one multi-tensor launch per dtype, not one per buffer)
        buffers = list(model.buffers())
        kept = torch._foreach_mul(buffers, 1.0) if buffers else []
        logits = _forward(cfg, net, x, labels, k)
        loss = _cross_entropy(logits, labels)
        loss.backward()
        metrics = _global_metrics(loss, logits.detach(), labels)
        params = [p for p in model.parameters() if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad.float())
                         for p in params]))
        ok = torch.isfinite(metrics["loss"]) & torch.isfinite(grad_norm)
        if bool(ok):  # the one host read of the step
            if cdr:
                cdr_mask_([(p, p.grad) for p in params], 1.0 - o.noise_rate,
                          cdr_clip(o.noise_rate, o.num_gradual,
                                   o.cdr_dead_schedule, state.opt_count,
                                   state.steps_per_epoch))
            state.set_lrs()
            opt.step()
            state.opt_count += 1
        elif buffers:
            with torch.no_grad():
                torch._foreach_copy_(buffers, kept)
        state.step += 1
        metrics["step_ok"] = ok.float()
        metrics["grad_norm"] = grad_norm
        return metrics

    return step


def make_eval_step(cfg: Config) -> Callable[..., Dict[str, torch.Tensor]]:
    """`(state, images, labels, valid) -> {loss_sum, top1, top3, n}`:
    per-batch counts over this rank's rows where `valid` is 1 (the
    loader's wrap-padding is 0), summed across batches and then across the
    ranks by `train/loop.py::eval_totals`. The arcface head is scored on
    s·cosθ and the nested head on its unmasked logits (`labels` / `mask`
    None; JAX `steps.py:727-745`)."""
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def step(state: "TrainState", images: torch.Tensor, labels: torch.Tensor,
             valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        state.model.eval()
        with torch.no_grad():
            x = device_input_epilogue(images.permute(0, 3, 1, 2),
                                      *_cached_consts(consts, images.device))
            logits = state.model(x)
            ce = F.cross_entropy(logits.float(), labels.long(),
                                 reduction="none")
            return {"loss_sum": (ce * valid).sum(),
                    "top1": (topk_hits(logits, labels, 1) * valid).sum(),
                    "top3": (topk_hits(logits, labels, 3) * valid).sum(),
                    "n": valid.sum()}

    return step


def make_predict_step(cfg: Config, batch_stat_mode: bool = False
                      ) -> Callable[["TrainState", torch.Tensor], torch.Tensor]:
    """`(state, images (B, H, W, 3)) -> (B, C) logits`: the PLC correction
    pass's f(x) over the train set (JAX `make_predict_step`,
    `steps.py:774-804`).

    The uint8 epilogue without a flip, then the model's forward with no
    labels and no mask (the heads' scores, as in eval). By default eval
    mode, on the running statistics. `batch_stat_mode` normalizes with
    the prediction batch's own statistics, as the reference harvests its
    softmax during training (PLC/utils.py:269-271): training mode, under
    a process group the global batch's statistics (`models/batchnorm.py`,
    flax's mutable batch_stats under the mesh), and the running buffers
    are put back afterwards (JAX discards the mutation). It is safe only
    on shuffled batches: the ordered scan is class-sorted, so each batch
    is nearly single-class."""
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def step(state: "TrainState", images: torch.Tensor) -> torch.Tensor:
        model = state.model
        with torch.no_grad():
            x = device_input_epilogue(images.permute(0, 3, 1, 2),
                                      *_cached_consts(consts, images.device))
            if not batch_stat_mode:
                return model.eval()(x)
            buffers = list(model.buffers())
            kept = torch._foreach_mul(buffers, 1.0) if buffers else []
            try:
                return model.train()(x)
            finally:
                if buffers:
                    torch._foreach_copy_(buffers, kept)

    return step


def make_nested_eval_step(cfg: Config) -> Callable[..., Dict[str, torch.Tensor]]:
    """`(state, images, labels, valid) -> {top1_k, top3_k, n}`: the all-K
    truncation sweep of one batch (JAX `make_nested_eval_step`,
    `steps.py:847-869`): the eval-mode features and the classifier's
    (C, D) weight through `ops/nested.py::nested_all_k_counts` in blocks of
    128 dims (D when 128 does not divide it), the per-K correct counts (D,)
    over this rank's valid rows. `train/loop.py` sums them across batches
    and ranks and applies `best_k`."""
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def step(state: "TrainState", images: torch.Tensor, labels: torch.Tensor,
             valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        model = state.model.eval()
        weight = model.classifier_weight
        d = weight.shape[1]
        with torch.no_grad():
            x = device_input_epilogue(images.permute(0, 3, 1, 2),
                                      *_cached_consts(consts, images.device))
            t1, t3 = nested_all_k_counts(model.features(x), weight, labels,
                                         block=128 if d % 128 == 0 else d,
                                         mask=valid)
        return {"top1_k": t1, "top3_k": t3, "n": valid.sum()}

    return step
