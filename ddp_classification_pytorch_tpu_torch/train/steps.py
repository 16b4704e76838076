"""Step functions of the port — the JAX package's `train/steps.py` for
serving (the uint8 input epilogue, the top-k predict) and for training
(`make_train_step`, `make_eval_step`, `make_nested_eval_step`), for the
heads fc, arcface and nested and the CDR gradient transform, PLC's
ordered f(x) pass (`make_predict_step`), and the phase probes of a
host-timed step breakdown (`make_phase_probes`). While a profiler is
active the train step opens `fwd`, `bwd` and `optimizer` ranges
(`obs/trace.py` reads them).

The train loss is the f32 CE plus, on a MoE ViT, `moe_aux_weight` × the
summed balance penalties of its blocks (`_loss`), in every step JAX adds
it to: the dense step, each microbatch and the phase probes. Every
active Dropout draws its masks from one generator a step, seeded from
the run seed, the step and the rank (`seed_dropout`).

Under a model axis (`state.mesh` with mp > 1, `parallel/mesh.py`) every
model rank of a data shard reads the same batch and holds the same loss:
the metrics and the eval sums go over the data group, each replicated
parameter whose shards saw different tokens has its gradient summed over
the model group (`parallel/ddp.py::sum_model_partials`), and the grad
norm and CDR's threshold cover the whole of each class-sharded gradient,
as JAX's global arrays do. `parallel.arcface_sharded_ce` (`--sharded_ce`)
trains and evaluates ArcFace through the partial-FC CE
(`ops/sharded_head.py`: JAX `_arcface_sharded_loss` and
`_make_arcface_sharded_eval`); it needs a model axis
(`require_sharded_ce_mesh`, JAX's text).

A pipelined ViT (`parallel.pipeline_microbatches`, `models/pipeline_vit.py`)
trains and evaluates through the same steps: its forward runs the GPipe
ticks over its stage group and every stage holds the whole loss. After
the backward the patch embedding's and the position table's gradients,
which arise on stage 0 alone, are summed over the stage group
(`parallel/ddp.py::sum_stage_partials`); the grad norm sums every
stage's blocks' squares over the stage group, and CDR ranks the whole
gradient with the blocks stacked (L, ...) as JAX's tree holds them
(`_cdr_mask`). `check_scaling` refuses what JAX refuses with it:
`grad_accum` above 1, the bf16 wire over more than one data rank, and a
batch the microbatches × the mesh's other axes do not divide
(`check_pipeline`, refused when the step is built).

PyTorch runs eagerly, so a "step" here is a plain function over the state
and device tensors; there is nothing to trace or compile.
"""

from __future__ import annotations

import contextlib
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import Config
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD, preset_for_dataset
from ..models.dropout import Dropout
from ..models.pipeline_vit import gpipe_vit
from ..models.vit import pop_moe_aux
from ..ops.cdr import cdr_clip, cdr_mask_
from ..ops.nested import nested_all_k_counts, nested_k, prefix_mask
from ..ops.pipeline import check_batch
from ..ops.sharded_head import arc_margin_ce_sharded
from ..parallel import ddp
from ..parallel.collectives import all_gather, axis_index, psum
from ..utils.metrics import topk_correct, topk_hits
from .schedule import zero_enabled

if TYPE_CHECKING:
    from .state import TrainState

# the JAX step derives its flip stream as fold_in(step_key, _FLIP_FOLD)
_FLIP_FOLD = 0x464C4950  # "FLIP"
_DROPOUT_FOLD = 0x44524F50  # "DROP"


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


def dropout_seed(seed: int, step: int, rank: int = 0) -> int:
    """The seed of the dropout generator of the train step at `step` on
    `rank`: keyed on (seed + 1, step, _DROPOUT_FOLD, rank), as JAX folds
    the step into its key and the data-axis index into the dropout key
    (`steps.py:385-389`), so a resumed run draws the masks the
    uninterrupted run drew and the ranks draw their own."""
    ss = np.random.SeedSequence([seed + 1, step, _DROPOUT_FOLD, rank])
    return int(ss.generate_state(1, np.uint64)[0])


def seed_dropout(model: nn.Module, seed: int, step: int,
                 device: torch.device, rank: Optional[int] = None) -> None:
    """Give every active Dropout of `model` one generator on `device`,
    seeded with `dropout_seed(seed, step, rank)`: the step's masks, drawn
    in the order the forward reaches them (microbatch after microbatch
    under accumulation). `rank` is the data index (default the process's
    rank): the model ranks of a data shard draw the same masks."""
    drops = [m for m in model.modules() if isinstance(m, Dropout) and m.p > 0]
    if not drops:
        return
    gen = torch.Generator(device=device)
    gen.manual_seed(dropout_seed(seed, step,
                                 ddp.rank() if rank is None else rank))
    for m in drops:
        m.generator = gen


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


def _loss(cfg: Config, model: nn.Module, logits: torch.Tensor,
          labels: torch.Tensor) -> torch.Tensor:
    """The train loss of one forward (JAX `_dense_loss_fn`,
    `steps.py:261-295`): the f32 CE plus, on a MoE ViT, `moe_aux_weight`
    × the summed balance penalties of its blocks (`models/vit.py::
    pop_moe_aux`, taken after every forward so its graph is not kept;
    left out at weight 0)."""
    loss = _cross_entropy(logits, labels)
    if cfg.model.moe_experts:
        aux = pop_moe_aux(model)
        if aux is not None and cfg.model.moe_aux_weight:
            loss = loss + cfg.model.moe_aux_weight * aux
    return loss


def data_axis(state: "TrainState") -> Tuple[Any, int]:
    """(group, size) of the data axis: the mesh's data group under a model
    or pipe axis, else the world."""
    mesh = state.mesh
    if mesh is not None and mesh.sharded:
        return mesh.data_group, mesh.dp
    return ddp.group(), ddp.world_size()


def sum_over_data(state: "TrainState", t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the data axis, in place (itself on one data
    shard)."""
    group, size = data_axis(state)
    return ddp.sum_across(t, group) if size > 1 else t


def _global_metrics(state: "TrainState", loss: torch.Tensor,
                    logits: torch.Tensor,
                    labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The global batch's mean loss and top-1/top-3 shares: this rank's
    loss and counts summed across the data axis in one all-reduce (the
    JAX `pmean(loss)` and `psum` of the counts, `collectives.py:79,86-88`);
    this rank's own without a group."""
    world = data_axis(state)[1]
    n = labels.shape[0] * world
    packed = sum_over_data(state, torch.stack([
        loss.detach().float(), topk_correct(logits, labels, 1).float(),
        topk_correct(logits, labels, 3).float()]))
    return {"loss": packed[0] / world, "top1": packed[1] / n,
            "top3": packed[2] / n}


def require_sharded_ce_mesh(mesh) -> None:
    """The partial-FC CE exists to avoid (B, C) logits: without a model
    axis above 1 it is refused, never run densely (JAX
    `_require_sharded_ce_mesh`, its text)."""
    if mesh is None or mesh.mp <= 1:
        raise ValueError(
            "arcface_sharded_ce requires a mesh with a model axis > 1 "
            "(--mp N); got "
            + ("no mesh" if mesh is None else f"mesh {mesh.shape}"))


def _sharded_ce(cfg: Config, state: "TrainState", net: nn.Module,
                x: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The partial-FC train loss (JAX `_arcface_sharded_loss`): the
    embeddings through the (DDP) forward, then `arc_margin_ce_sharded`
    with this rank's margin shard over the global batch; the MoE penalty
    as in `_loss`. Returns (loss, metrics)."""
    mc, mesh = cfg.model, state.mesh
    emb = net(x, features_only=True)
    loss, t1, t3 = arc_margin_ce_sharded(
        emb, state.model.margin.weight, labels, mesh.model_group,
        mesh.data_group, s=mc.arc_s, m=mc.arc_m, easy_margin=mc.arc_easy_margin)
    if mc.moe_experts:
        aux = pop_moe_aux(state.model)
        if aux is not None and mc.moe_aux_weight:
            loss = loss + mc.moe_aux_weight * aux
    n = labels.shape[0] * mesh.dp
    return loss, {"loss": loss.detach(), "top1": t1 / n, "top3": t3 / n}


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


def _grad_norm(params, state: Optional["TrainState"] = None) -> torch.Tensor:
    """The global norm of the params' gradients, in f32; a class-sharded
    gradient counts whole (its shards' squares summed over the model
    group), and so do a pipelined ViT's blocks (every stage's squares
    summed over the stage group)."""
    pipe = (gpipe_vit(state.model)
            if state is not None and state.stage_sharded else None)
    if state is None or not (state.model_sharded or pipe is not None):
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad.float()) for p in params]))
    ids = {id(p) for name, p in state.model.named_parameters()
           if name in state.shard_dims}
    staged = ({id(p) for p in pipe.blocks.parameters()} if pipe is not None
              else set())
    sq = [torch.linalg.vector_norm(p.grad.float()) ** 2 for p in params]
    dev = sq[0].device

    def total(keep) -> torch.Tensor:
        return torch.as_tensor(sum(x for p, x in zip(params, sq) if keep(p)),
                               dtype=torch.float32, device=dev)

    out = total(lambda p: id(p) not in ids and id(p) not in staged)
    if state.model_sharded:
        out = out + psum(total(lambda p: id(p) in ids),
                         state.mesh.model_group)
    if pipe is not None:
        out = out + psum(total(lambda p: id(p) in staged), pipe.group)
    return torch.sqrt(out)


def _stacked_blocks(pipe, params):
    """A pipelined ViT's block params as JAX's tree holds them: for each
    of a block's params, the (L, ...) stack of every block's (gathered
    over the stage group), with its gradient; and for each stack, this
    stage's rows and the grads they go back to."""
    own = sorted(pipe.blocks, key=int)
    keep = {id(p) for p in params}
    stacks, back = [], []
    for rest, _ in pipe.blocks[own[0]].named_parameters():
        ps = [pipe.blocks[k].get_parameter(rest) for k in own]
        if not all(id(p) in keep for p in ps):
            continue
        w = all_gather(torch.stack([p.detach() for p in ps]), pipe.group, 0)
        g = all_gather(torch.stack([p.grad for p in ps]), pipe.group, 0)
        stacks.append((w, g))
        back.append((g, [p.grad for p in ps],
                     axis_index(pipe.group) * len(own)))
    return stacks, back


def _cdr_mask(state: "TrainState", params, nonzero_ratio: float,
              clip: float) -> None:
    """CDR's mask over every gradient entry: a class-sharded parameter and
    its gradient take part whole (gathered over the model group), and
    this rank keeps its slice of the masked gradient. A pipelined ViT's
    blocks take part as JAX's stacked (L, ...) leaves (gathered over the
    stage group): JAX selects a leaf by its rank, so a block's
    LayerNorm affines and biases ((L, C), 2-D) are ranked and its Dense
    kernels ((L, I, O), 3-D) are not."""
    pipe = gpipe_vit(state.model)
    if not state.model_sharded and pipe is None:
        cdr_mask_([(p, p.grad) for p in params], nonzero_ratio, clip)
        return
    dims = {id(p): state.shard_dims[n]
            for n, p in state.model.named_parameters()
            if n in state.shard_dims}
    staged = ({id(p) for p in pipe.blocks.parameters()} if pipe is not None
              else set())
    pairs, back = [], []
    for p in params:
        if id(p) in staged:
            continue
        if id(p) not in dims:
            pairs.append((p, p.grad))
            continue
        d = dims[id(p)]
        group = state.mesh.model_group
        g = all_gather(p.grad, group, d)
        pairs.append((all_gather(p.detach(), group, d), g))
        back.append((p.grad, g, d))
    stacks, stacked_back = (_stacked_blocks(pipe, params) if pipe is not None
                            else ([], []))
    cdr_mask_(pairs + stacks, nonzero_ratio, clip)
    for local, whole, d in back:
        n = local.shape[d]
        local.copy_(whole.narrow(d, state.mesh.model_index * n, n))
    for whole, grads, start in stacked_back:
        for j, local in enumerate(grads):
            local.copy_(whole[start + j])


def pipelined(cfg: Config) -> bool:
    """Whether the config asks for the GPipe schedule (JAX's test:
    `pipeline_stages` above 1 or `pipeline_microbatches` above 0)."""
    p = cfg.parallel
    return max(p.pipeline_stages, 1) > 1 or p.pipeline_microbatches > 0


def check_pipeline(cfg: Config, mesh: Optional[Any]) -> None:
    """JAX's executor's batch check (`ops/pipeline.py:75-80`), made when
    the step is built: the global batch (`--batchsize` × the data axis)
    over the microbatches × the product of the mesh's other axes above 1
    (data, and model on a (data, model, pipe) mesh). A single stage runs
    the blocks in order and checks nothing."""
    if (cfg.parallel.pipeline_microbatches <= 0 or mesh is None
            or mesh.stage_axis()[1] <= 1):
        return
    check_batch(cfg.data.batch_size * mesh.dp,
                cfg.parallel.pipeline_microbatches, mesh.batch_shards())


def check_scaling(cfg: Config, world: int = 1, mp: int = 1) -> None:
    """The scaling levers' rejections (ValueError: rc 2), the JAX
    package's (`steps.py:174-212,230-258`, `mesh.py:292-300`): a wire dtype
    or ZeRO setting outside its choices; `grad-accum-indivisible`, a
    per-process batch that K does not split into K equal microbatches (a
    ragged one would re-weight its samples); the bf16 wire under the
    nested head over more than one rank (JAX draws that head's k per
    shard in its bf16 section; the check there does not look at K); the
    bf16 wire over more than one data rank with the partial-FC CE, a
    model axis above 1 or the pipeline; `grad_accum` above 1 with the
    pipeline (its microbatch loop is GPipe's). `world` is the data
    axis's size, `mp` the product of the other axes."""
    p = cfg.parallel
    if p.grad_reduce_dtype not in ("float32", "bfloat16"):
        raise ValueError("parallel.grad_reduce_dtype must be "
                         f"float32|bfloat16, got {p.grad_reduce_dtype!r}")
    want_bf16 = p.grad_reduce_dtype == "bfloat16" and world > 1
    if want_bf16 and p.arcface_sharded_ce and cfg.model.head == "arcface":
        raise ValueError(
            "grad_reduce_dtype=bfloat16 does not compose with "
            "arcface_sharded_ce (the partial-FC loss is its own "
            "shard_map program) — drop one of the two")
    zero_enabled(p.zero_opt, world)
    k = grad_accum(cfg)
    if k > 1 and pipelined(cfg):
        raise ValueError(
            "grad-accum-indivisible: grad_accum > 1 does not compose with "
            "the pipeline schedule (pipeline_microbatches already owns the "
            "microbatch loop) — pick one microbatching scheme")
    if k > 1 and cfg.data.batch_size % k:
        raise ValueError(
            f"grad-accum-indivisible: per-process batch "
            f"{cfg.data.batch_size} does not split into grad_accum={k} "
            "equal microbatches — pick K dividing --batchsize (equal "
            "microbatches keep the accumulated mean exact)")
    if (p.grad_reduce_dtype == "bfloat16" and world > 1
            and cfg.model.head == "nested"):
        raise ValueError(
            "grad_reduce_dtype=bfloat16 does not support the nested "
            "workload (per-batch mask k must be sampled globally)")
    if want_bf16 and (mp > 1 or pipelined(cfg)):
        raise ValueError(
            "grad_reduce_dtype=bfloat16 is the pure-DP fast path; it "
            "does not compose with a model/pipe axis — use float32 "
            "reduction there")


def grad_accum(cfg: Config) -> int:
    """K, the microbatches a step (0 and 1 both mean the plain step)."""
    return max(int(cfg.parallel.grad_accum), 1)


def _step_inputs(cfg: Config) -> Callable[..., Tuple]:
    """`(state, images, flip, k) -> (x, k, buffers, kept)`: the train
    step's start, shared by `make_train_step` and `make_phase_probes`: the
    uint8 epilogue with the train-time flip (the `flip` given, else
    `flip_mask(run.seed, state.step, B)`) over the whole batch, the nested
    head's k (the `k` given, else `nested_k`; under accumulation a list of
    one k a microbatch, None each for the other heads), train mode, every gradient cleared, and the
    buffers as they were (`kept`) for a skipped step, taken once, before
    any microbatch."""
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
    flips = _train_flip_enabled(cfg)
    seed = cfg.run.seed
    accum = grad_accum(cfg)

    def prepare(state: "TrainState", images: torch.Tensor,
                flip: Optional[np.ndarray], k: Optional[int]) -> Tuple:
        model = state.model
        mask = None
        if flips:
            if flip is None:
                flip = flip_mask(seed, state.step, images.shape[0])
            mask = torch.from_numpy(flip).to(images.device, non_blocking=True)
        x = device_input_epilogue(images.permute(0, 3, 1, 2),
                                  *_cached_consts(consts, images.device), mask)
        if cfg.model.head == "nested" and k is None:
            k = (nested_k(seed, state.step, model.feat_dim,
                          cfg.model.nested_std) if accum == 1 else
                 [nested_k(seed, state.step, model.feat_dim,
                           cfg.model.nested_std, i) for i in range(accum)])
        elif k is None and accum > 1:
            k = [None] * accum
        model.train()
        seed_dropout(model, seed, state.step, x.device,
                     state.mesh.data_index if state.mesh is not None else None)
        # every parameter's, not only the optimizer's: freeze-BN's params
        # are in no group but still get (and must not accumulate) gradients
        model.zero_grad(set_to_none=True)
        # the buffers as they were, for a skipped step (x·1 is a bitwise
        # copy; one multi-tensor launch per dtype, not one per buffer)
        buffers = list(model.buffers())
        kept = torch._foreach_mul(buffers, 1.0) if buffers else []
        return x, k, buffers, kept

    return prepare


_NO_RANGE = contextlib.nullcontext()


def _phase(name: str):
    """A `record_function` range named `name` (fwd, bwd, optimizer) while
    a profiler is active (`obs/trace.py` attributes the device's work to
    it); otherwise a shared no-op: no cost and no host sync."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_RANGE


def _microbatches(cfg: Config, state: "TrainState", x: torch.Tensor,
                  labels: torch.Tensor, ks: List[Optional[int]],
                  backward: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K = len(ks) equal microbatches of an accumulated step (JAX
    `_scan_microbatches`, `steps.py:420-466`): each one's head forward and
    f32 CE, in order, the BN statistics moving from one to the next, and
    with `backward` its backward on its own mean loss, the gradients
    summing into `.grad`; under DDP the first K − 1 run in `no_sync()`,
    so the gradients cross the ranks once, summed, in the last one's
    backward (the BN statistics' all-reduce still runs in every
    microbatch's forward). Returns the mean of the K losses (summed in
    order, then ÷K, as JAX's carry) and the K × mb logits. The caller
    divides the summed gradients by K once: JAX's mean of means."""
    k = len(ks)
    mb = labels.shape[0] // k
    net = state.model if state.ddp is None else state.ddp
    total, logits = None, []
    for i in range(k):
        sl = slice(i * mb, (i + 1) * mb)
        defer = backward and state.ddp is not None and i < k - 1
        with state.ddp.no_sync() if defer else _NO_RANGE:
            with _phase("fwd"):
                out = _forward(cfg, net, x[sl], labels[sl], ks[i])
                loss = _loss(cfg, state.model, out, labels[sl])
            if backward:
                with _phase("bwd"):
                    loss.backward()
        loss = loss.detach()
        total = loss if total is None else total + loss
        logits.append(out.detach())
    return total / k, torch.cat(logits)


def _mean_of_sums(model: nn.Module, k: int) -> None:
    """Every summed gradient ÷ K (freeze-BN's too: the grad norm reads
    them)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if grads:
        torch._foreach_div_(grads, float(k))


def make_train_step(cfg: Config, chaos: Optional[Any] = None,
                    mesh: Optional[Any] = None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """`(state, images (B, H, W, 3), labels (B,)) -> metrics`, updating
    `state` in place — the JAX `_build_step` for every ported head.

    uint8 epilogue with the train-time flip where `_train_flip_enabled`
    (the mask `flip_mask(run.seed, state.step, B)`, or the `flip` (B,) bool
    array the caller passes: parity tests pass the JAX step's), forward
    in train mode (through `state.ddp`, the DistributedDataParallel
    wrapper, when there is one) by head (`_forward`; the nested head's k
    is `nested_k(run.seed, state.step, D, model.nested_std)`, or the `k`
    the caller passes: parity tests pass the JAX step's), f32 CE, backward
    (DDP averages the gradients across the ranks in it; the loss adds
    the MoE penalty, `_loss`), global grad norm
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
    grad_norm.

    `chaos` (a `utils/chaos.py::FaultPlan`) nan_loss windows poison this
    rank's loss to NaN AFTER the backward pass on the steps inside them
    (JAX `steps.py:591-640`): the gradients stay untouched, the global
    loss and so the gate see the NaN, and the step is skipped on every
    rank. Outside its windows the step is the step without chaos.

    Under `parallel.grad_accum` K > 1 (JAX `_scan_microbatches` and its
    deferred reduction, `steps.py:420-544,614-669`) the epilogue and the
    flip run once on the whole batch, the buffers are kept once, then
    `_microbatches` runs K equal slices forward and backward (the nested
    head's k one a microbatch: `k` is then a list of K), the gradients
    summed and divided by K once — JAX's mean of the microbatch means,
    which equals the mean over the batch for equal microbatches — and one
    all-reduce carries them across the ranks. The loss metric is the mean
    of the K losses, top1 and top3 count all K × mb logits, and the gate,
    CDR and the update run once, at this optimizer boundary: one
    `step_ok` a step, one sentinel observation. A skipped step puts the
    buffers back as they were before microbatch 0. K = 1 is the plain
    step above, call for call. `check_scaling` rejects what JAX does.

    `mesh` (`parallel/mesh.py::Mesh`) is the state's; with
    `parallel.arcface_sharded_ce` under the arcface head the loss and its
    metrics are the partial-FC CE's (`_sharded_ce`)."""
    if cfg.optim.grad_transform not in ("none", "cdr"):
        raise ValueError(f"unknown optim.grad_transform "
                         f"{cfg.optim.grad_transform!r}; one of none, cdr")
    split = mesh is not None and mesh.sharded
    check_scaling(cfg, mesh.dp if split else ddp.world_size(),
                  mesh.mp * mesh.pp if split else 1)
    check_pipeline(cfg, mesh)
    sharded_ce = _sharded_ce_on(cfg, mesh)
    o = cfg.optim
    cdr = o.grad_transform == "cdr"
    nan_windows = list(chaos.windows("nan_loss", "step")) if chaos else []
    prepare = _step_inputs(cfg)
    accum = grad_accum(cfg)

    def step(state: "TrainState", images: torch.Tensor, labels: torch.Tensor,
             flip: Optional[np.ndarray] = None,
             k: Optional[Any] = None) -> Dict[str, torch.Tensor]:
        model = state.model
        if accum > 1:
            with _phase("fwd"):
                x, k, buffers, kept = prepare(state, images, flip, k)
            loss, logits = _microbatches(cfg, state, x, labels, k,
                                         backward=True)
            _mean_of_sums(model, accum)
            return finish(state, loss, logits, labels, buffers, kept)
        net = model if state.ddp is None else state.ddp
        with _phase("fwd"):
            x, k, buffers, kept = prepare(state, images, flip, k)
            if sharded_ce:
                loss, metrics = _sharded_ce(cfg, state, net, x, labels)
            else:
                logits = _forward(cfg, net, x, labels, k)
                loss = _loss(cfg, model, logits, labels)
        with _phase("bwd"):
            loss.backward()
        if sharded_ce:
            return finish(state, loss, None, labels, buffers, kept, metrics)
        return finish(state, loss, logits.detach(), labels, buffers, kept)

    def finish(state: "TrainState", loss: torch.Tensor,
               logits: Optional[torch.Tensor], labels: torch.Tensor, buffers,
               kept, metrics: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
        """The optimizer boundary, once a step however many microbatches
        fed it: chaos, the global gate, CDR, the update or the skip.
        `metrics` are the partial-FC CE's, already global."""
        model, opt = state.model, state.optimizer
        with _phase("optimizer"):
            ddp.sum_model_partials(model, state.mesh)
            ddp.sum_stage_partials(model)
            if any(state.step >= lo and (hi is None or state.step <= hi)
                   for lo, hi in nan_windows):
                loss = torch.full_like(loss, float("nan"))
                if metrics is not None:
                    metrics["loss"] = loss.detach()
            if metrics is None:
                metrics = _global_metrics(state, loss, logits, labels)
            params = [p for p in model.parameters() if p.grad is not None]
            grad_norm = _grad_norm(params, state)
            ok = torch.isfinite(metrics["loss"]) & torch.isfinite(grad_norm)
            if bool(ok):  # the one host read of the step
                if cdr:
                    _cdr_mask(state, params, 1.0 - o.noise_rate,
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


def _sharded_ce_on(cfg: Config, mesh: Optional[Any]) -> bool:
    """Whether the arcface head runs the partial-FC CE (refused without a
    model axis)."""
    if not (cfg.parallel.arcface_sharded_ce and cfg.model.head == "arcface"):
        return False
    require_sharded_ce_mesh(mesh)
    return True


def make_phase_probes(cfg: Config, mesh: Optional[Any] = None
                      ) -> Dict[str, Callable]:
    """Sub-steps of the train step for a host-timed step breakdown (JAX
    `make_phase_probes`, `steps.py:298-340`):
    `{"fwd": (state, images, labels) -> loss,
      "fwd_bwd": (state, images, labels) -> (loss, grad_norm)}`.

    Both run the production step's own start (`_step_inputs`: epilogue,
    flip, nested k), head forward and CE; `fwd` under `no_grad` (the
    forward alone, as JAX's forward-only program), `fwd_bwd` with its
    backward and the grad norm. Neither updates the state: the buffers the
    forward moved are put back and the gradients cleared, so the same
    state times every call. With the full step's time they feed
    `obs/trace.py::SpanRecorder`: fwd = t(fwd), bwd = t(fwd_bwd) − t(fwd),
    optimizer = t(step) − t(fwd_bwd). The caller synchronizes the device
    before reading a clock. Under accumulation both run the step's K
    microbatches (`_microbatches`), `fwd_bwd` with the summed gradients
    ÷K before their norm."""
    prepare = _step_inputs(cfg)
    accum = grad_accum(cfg)
    sharded_ce = _sharded_ce_on(cfg, mesh)

    def norm(state: "TrainState") -> torch.Tensor:
        ddp.sum_model_partials(state.model, state.mesh)
        ddp.sum_stage_partials(state.model)
        return _grad_norm([p for p in state.model.parameters()
                           if p.grad is not None], state)

    def run(state: "TrainState", images: torch.Tensor, labels: torch.Tensor,
            backward: bool):
        x, k, buffers, kept = prepare(state, images, None, None)
        net = state.model if state.ddp is None else state.ddp
        try:
            if sharded_ce:
                with torch.set_grad_enabled(backward):
                    loss = _sharded_ce(cfg, state, net, x, labels)[0]
                if not backward:
                    return loss.detach()
                loss.backward()
                return loss.detach(), norm(state)
            if accum > 1:
                with torch.set_grad_enabled(backward):
                    loss, _ = _microbatches(cfg, state, x, labels, k,
                                            backward)
                if not backward:
                    return loss
                _mean_of_sums(state.model, accum)
                return loss, norm(state)
            if not backward:
                with torch.no_grad():
                    return _loss(cfg, state.model,
                                 _forward(cfg, net, x, labels, k), labels)
            loss = _loss(cfg, state.model, _forward(cfg, net, x, labels, k),
                         labels)
            loss.backward()
            return loss.detach(), norm(state)
        finally:
            state.model.zero_grad(set_to_none=True)
            if buffers:
                with torch.no_grad():
                    torch._foreach_copy_(buffers, kept)

    return {"fwd": lambda state, images, labels: run(state, images, labels,
                                                     False),
            "fwd_bwd": lambda state, images, labels: run(state, images,
                                                         labels, True)}


def make_eval_step(cfg: Config, mesh: Optional[Any] = None
                   ) -> Callable[..., Dict[str, torch.Tensor]]:
    """`(state, images, labels, valid) -> {loss_sum, top1, top3, n}`:
    per-batch counts over this rank's rows where `valid` is 1 (the
    loader's wrap-padding is 0), summed across batches and then across the
    data axis by `train/loop.py::eval_totals`. The arcface head is scored
    on s·cosθ and the nested head on its unmasked logits (`labels` /
    `mask` None; JAX `steps.py:727-745`); with the partial-FC CE the
    arcface scores go through `arc_margin_ce_sharded` with m 0 and the
    valid mask, no (B, C) logits (JAX `_make_arcface_sharded_eval`)."""
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
    sharded_ce = _sharded_ce_on(cfg, mesh)

    def step(state: "TrainState", images: torch.Tensor, labels: torch.Tensor,
             valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        state.model.eval()
        with torch.no_grad():
            x = device_input_epilogue(images.permute(0, 3, 1, 2),
                                      *_cached_consts(consts, images.device))
            if sharded_ce:
                loss, t1, t3 = arc_margin_ce_sharded(
                    state.model.features(x), state.model.margin.weight,
                    labels, state.mesh.model_group, s=cfg.model.arc_s, m=0.0,
                    valid=valid)
                n = valid.sum()
                return {"loss_sum": loss * n, "top1": t1, "top3": t3, "n": n}
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
