"""Config tree for the port: the part of the JAX package's `config.py` that
serving and training read, as the port's own copy (the port imports
nothing of the JAX package).

Field names, defaults and the five workload presets are the JAX package's
(`config.py:467-510` there), field for field wherever the port has the
field, so a command line means the same on both sides: the scaling
levers too (`parallel.grad_accum`, `zero_opt`, `grad_reduce_dtype`,
`data.h2d_overlap`, `run.async_checkpoint`, on by default as in JAX).
Fields for the parts not ported yet (model and pipeline parallelism, the
partial-FC ArcFace CE, the AOT sidecar) are left out until their slice
lands.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass
class DataConfig:
    """Where the images come from and what a batch looks like on the wire.

    Per-class caps (500 for the baseline, BASELINE/main.py:98), the class
    cap (CDR keeps 100 class dirs, CDR/main.py:73) and the epoch-seeded
    reshuffle are the reference's."""

    train_dir: str = ""
    val_dir: str = ""
    dataset: str = "imagefolder"  # imagefolder | synthetic | cifar10 | cifar100 | plc
    image_size: int = 224
    train_crop_size: int = 256  # RandomResizedCrop(256), BASELINE/main.py:61
    num_classes: int = 2173  # BASELINE/main.py:85
    imgs_per_class: int = 500  # BASELINE/main.py:98
    max_classes: int = 0  # 0 = all; CDR uses 100 (CDR/main.py:73)
    # the batch of one process (one process drives one card); the global
    # batch is batch_size × world size, the JAX `batch_size * num_hosts`
    batch_size: int = 16
    num_workers: int = 4  # loader threads (BASELINE/main.py:130-131)
    prefetch: int = 2  # host batches the loader keeps ready
    # batches staged on the card ahead of the step loop by a stager thread
    # (data/device_prefetch.py: pinned buffers, a side stream); each holds
    # device memory. 0 = copy each batch inside the step loop
    device_prefetch: int = 2
    # double-buffered H2D (data/device_prefetch.py): a fetcher thread pulls
    # host batch N+1 while the stager fills the pinned buffers and copies
    # batch N (a one-slot handoff between them); ignored at device_prefetch 0
    h2d_overlap: bool = False
    synthetic_size: int = 0  # train-set size for dataset == "synthetic" (0 = 512)
    # request wire format: "uint8" raw HWC pixels, normalized (and, for
    # training on image data, flipped) on the device by
    # train/steps.py::device_input_epilogue; "float32" host-normalized
    input_dtype: str = "uint8"
    # transform preset: baseline | cdr | cifar | clothing1m
    transform: str = "baseline"


@dataclass
class ModelConfig:
    """Backbone + head selection (resnet18/34/50/101/152, vgg19_bn,
    tresnet_m / timm and vit_t16/s16/b16, each under the heads fc, arcface
    and nested; models/factory.py refuses the rest)."""

    arch: str = "resnet50"
    variant: str = "imagenet"  # ResNet stem: imagenet (7×7/2 + pool) | cifar (3×3/1)
    pretrained: bool = False  # load a torchvision/timm state dict at init
    # the .pth/.pt to load (a torchvision state dict, a {'state_dict': ...}
    # wrapper or the reference's NESTED {'feat', 'cls'} file); nothing is
    # downloaded
    pretrained_path: str = ""
    head: str = "fc"  # fc | arcface | nested
    # ArcFace (ARCFACE/arc_main.py:234: s=30, m=0.5, easy_margin=True)
    arc_s: float = 30.0
    arc_m: float = 0.5
    arc_easy_margin: bool = True
    arc_embed_dim: int = 256  # arc_main.py:223-231: 2048->512->256 embedding
    # the reference's LogSoftmax on the EMBEDDING (arc_main.py:230); off
    # by default, as in the JAX package
    arc_log_softmax_quirk: bool = False
    # Nested dropout (NESTED/train.py:512-530): σ of the Gaussian over the
    # feature dims; freeze-BN (BN on running statistics, γ/β not updated)
    nested_std: float = 100.0
    freeze_bn: bool = False
    dtype: str = "bfloat16"  # compute dtype; ABN math, pool and fc stay f32
    # ViT: after the MLP's GELU; VGG19-BN: `dropout or 0.5`; the others
    # ignore it
    dropout: float = 0.0
    # per-block rematerialization on the ResNets (whole) and the ViTs
    # (checkpoint_dots), the activation-memory lever (models/remat.py)
    remat: bool = False
    # ViT: dropless split-FFN mixture of experts in every block (ops/moe.py)
    # when > 0; the router's top-k; the weight of the summed balance
    # penalty in the training loss (0 leaves it out)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_aux_weight: float = 0.01
    # ViT: the flash kernels (ops/flash_attention.py) for attention when
    # the token count reaches flash_min_tokens (0 = always)
    flash_attention: bool = False
    flash_min_tokens: int = 1024
    # ViT: LayerNorms "in bf16" — bitwise the f32 ones under flax's
    # promotion, so accepted and computed as those (models/vit.py)
    ln_bf16: bool = False


@dataclass
class OptimConfig:
    """Optimizer + LR schedule (the JAX package's names and defaults)."""

    optimizer: str = "sgd"  # sgd | adam
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 0.0
    # the ArcFace margin head's param group (arc_main.py:248-253); None =
    # inherit lr / weight_decay (one group)
    head_lr: Optional[float] = None
    head_weight_decay: Optional[float] = None
    schedule: str = "step"  # step | multistep | constant
    step_size: int = 10
    gamma: float = 0.1
    milestones: Sequence[int] = field(default_factory=lambda: (10, 20))
    warmup_iters: int = 0
    warmup_start_lr: float = 1e-6  # BASELINE/main.py:175
    grad_transform: str = "none"  # none | cdr
    # CDR (CDR/main.py:37,54): keep the top (1 - noise_rate) of |g·v|
    noise_rate: float = 0.2
    num_gradual: int = 10
    # the reference's quirk (CDR/main.py:222-227): the gradual clip
    # schedule is dead code, overwritten by the constant; True reproduces it
    cdr_dead_schedule: bool = True


@dataclass
class ParallelConfig:
    """Data, model and pipeline parallelism over torch.distributed: one
    process per card, launched by torchrun (the JAX package's `data`,
    `model` and `pipe` mesh axes, `--dp`, `--mp` and `--pp_stages`)."""

    data_parallel: int = 0  # × model_axis = the world; 0 = the rest
    # K equal microbatches a step, their gradients summed and averaged
    # once, one gradient all-reduce and one optimizer update per K
    # (train/steps.py); 1 = the plain step
    grad_accum: int = 1
    # ZeRO-1 (ZeroRedundancyOptimizer: each rank keeps and updates 1/N of
    # the optimizer state); auto and on mean on when the world is above 1
    zero_opt: str = "auto"  # auto | on | off
    # the gradient all-reduce's wire dtype: bfloat16 is the port's DDP comm
    # hook (parallel/ddp.py), a no-op at world 1; master weights stay f32
    grad_reduce_dtype: str = "float32"  # float32 | bfloat16
    # the model axis (parallel/mesh.py): ranks = data_parallel ×
    # model_axis; ring attention's token axis on a ViT, its experts
    # with MoE, and the class-dim heads on every arch
    model_axis: int = 1
    # nodes the data axis spans, each model group inside one (the JAX
    # package's DCN slices); 0 = the world over LOCAL_WORLD_SIZE
    dcn_slices: int = 0
    # ArcFace's partial-FC CE over the model axis (ops/sharded_head.py):
    # needs model_axis > 1 and the class count divisible by it
    arcface_sharded_ce: bool = False
    # > 0: GPipe over the ViT's block stack (ops/pipeline.py,
    # models/pipeline_vit.py) with this many microbatches; the stages ride
    # the model axis unless pipeline_stages gives them their own
    pipeline_microbatches: int = 0
    # > 1: the pipe axis of a (data, model, pipe) mesh with this many
    # stages; ranks = data_parallel × model_axis × pipeline_stages
    pipeline_stages: int = 0


@dataclass
class PLCConfig:
    """Progressive label correction (the PLC workload, `train/plc_loop.py`;
    the JAX `PLCConfig`, field for field): `ops/labelnoise.py`'s
    corrections applied to the train labels after `warmup_epochs`."""

    correction: str = "lrt"  # lrt | prob
    current_delta: float = 0.3  # PLC/utils.py:291 θ
    delta_increment: float = 0.1  # β
    thd: float = 0.1  # prob_correction confidence threshold (:321)
    warmup_epochs: int = 2  # epochs of plain training before correction starts
    # collect f(x) with the prediction batch's own BN statistics (as the
    # reference harvests softmax during training, utils.py:269-271) rather
    # than the running averages. Off by default: the ordered correction
    # scan is class-sorted, so each prediction batch is nearly single-class
    # and its batch statistics skew the normalization
    batch_stat_predictions: bool = False
    # synthetic-noise injection for experiments (utils.py:149-220); -1 = off
    noise_type: int = -1
    noise_factor: float = 1.2
    # cap the fraction of labels one correction pass may flip, keeping the
    # most confident flips (correction on an immature model confirms
    # itself); 1.0 = the uncapped reference semantics
    max_flip_frac: float = 1.0


@dataclass
class RunConfig:
    epochs: int = 100  # NUM_EPOCH, BASELINE/main.py:87
    seed: int = 999  # set_seed(999), BASELINE/main.py:43-50
    log_every: int = 20  # BASELINE/main.py:284
    eval_every: int = 1
    eval_first: bool = False
    out_dir: str = "./runs/default"
    save_every_epoch: bool = True  # BASELINE/main.py:308-310
    save_best_only: bool = False  # NESTED netBest.pth policy, train.py:154-161
    # serialize and write checkpoints on a background thread, one write in
    # flight (train/checkpoint.py); the host copy is taken synchronously
    async_checkpoint: bool = True
    keep_checkpoints: int = 0  # prune epoch checkpoints beyond N (0 = keep all)
    resume: str = ""  # NESTED --resumePth, train.py:372-378
    # preemption recovery: resume from the newest verified checkpoint in
    # out_dir, so the restart command is the start command
    auto_resume: bool = False
    write_records: bool = True  # output.txt / history.json
    tensorboard: bool = False  # event files at <out_dir>/tb (utils/tensorboard.py)
    # consecutive non-finite (skipped) steps before the run exits rc 8;
    # 0 = skip forever
    max_bad_steps: int = 25
    # the hang watchdog (utils/backend_probe.py::StepHeartbeat): exit rc 7
    # when no host-observed progress lands for this many seconds; set it
    # above the slowest silent stretch (a cold kernel build included);
    # 0 = off
    hang_timeout_s: float = 0.0
    # deterministic fault injection (utils/chaos.py), e.g.
    # "nan_loss@step=7,ckpt_io@epoch=1,loader_io@batch=3,sigterm@step=20";
    # CHAOS_FAULT_SPEC overrides; empty = every hook inert
    fault_spec: str = ""
    # >0: a torch.profiler capture of steps [min(10, spe − N), +N) of epoch 0
    profile_steps: int = 0
    profile_dir: str = ""  # default: <out_dir>/profile
    # the --debug_nans check (utils/debug_nans.py): raise at the first op
    # with a NaN output, as jax_debug_nans does
    debug_nans: bool = False
    # the compile sentinel (analysis/compile_sentinel.py), armed at the top
    # of the epoch after the first evaluated one: a kernel library build
    # after that is logged and counted; True = rc 2 at the epoch boundary
    # (a steady-state build replays on restart, so supervisors must not
    # retry it)
    strict_compile: bool = False


def dp_round_up_buckets(buckets: Sequence[int], dp: int) -> tuple:
    """Round each bucket UP to the next dp multiple and dedup (ascending):
    at most len(buckets) padded shapes, each evenly split over dp serve
    devices (the JAX package's `config.py::dp_round_up_buckets`)."""
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    return tuple(sorted({((int(b) + dp - 1) // dp) * dp for b in buckets}))


@dataclass
class ServeConfig:
    """Inference serving (serve/engine.py, cli/serve.py).

    The engine assembles micro-batches from a bounded request queue under a
    deadline and pads them to a small fixed set of bucket sizes:
    `batch_timeout_ms` bounds the latency a lone request pays waiting for
    company, `max_batch` bounds how much throughput a full queue can
    amortize into one device dispatch.
    """

    max_batch: int = 8  # largest micro-batch the batcher assembles
    # deadline from the FIRST queued request until a partial batch flushes;
    # 0 = never wait (every collect takes whatever is queued right now)
    batch_timeout_ms: float = 5.0
    queue_depth: int = 64  # bounded intake; submits beyond it are rejected
    # padded batch shapes (ascending). () = powers of two up to max_batch.
    # Each bucket is one CUDA graph per serve device; requests pad to the
    # smallest bucket that fits the collected batch. Over more than one
    # serve device every bucket must be divisible by their count (each
    # padded batch splits evenly); auto-buckets round up.
    buckets: Sequence[int] = ()
    # cards the engine serves over, data-parallel (0 = all visible): a
    # padded bucket splits into equal row blocks, one a card
    serve_devices: int = 0
    # the AOT sidecar (serve/aot.py): "auto" = <checkpoint dir>/aot (or
    # <watch dir>/aot), "off" = disable, else an explicit dir. A joining
    # replica loads the banked kernel libraries instead of building them
    aot_cache: str = "auto"
    topk: int = 5  # classes returned per request
    checkpoint: str = ""  # explicit checkpoint to serve (verified; rc 2 if corrupt)
    watch_dir: str = ""  # run dir to poll for checkpoint hot-reload
    reload_poll_s: float = 5.0  # hot-reload poll cadence
    port: int = 0  # >0: stdlib http front-end on this port (serve/http.py)
    log_every_s: float = 10.0  # metrics console line cadence
    # the compile sentinel: warmup() arms it after its one capture per
    # bucket and serve device; a steady-state capture or kernel build is
    # counted + logged. True = the engine stops intake and cli.serve exits
    # rc 2 (deterministic)
    strict_compile: bool = False
    # --- serve-fleet control plane (serve/fleet.py) ---
    # shared fleet run dir ("" = fleet off, lone-replica mode). Replicas
    # sharing it heartbeat via $FLEET_DIR/serve_fleet/lease.r<id> and
    # serialize hot reloads through the single drain token (rolling wave).
    fleet_dir: str = ""
    fleet_replica: int = 0  # this replica's id in the shared fleet dir
    fleet_ttl_s: float = 15.0  # lease/token freshness horizon (mtime vs now)
    # admission control above the engine queue: 0 = off (engine bound only);
    # >0 = shed when measured wait (depth / observed service rate) exceeds
    # this deadline (fair-share shed at 1x, any-tenant shed at 2x)
    admission_deadline_ms: float = 0.0
    # per-tenant weighted fair shares, "name:weight,name:weight"
    # ("" = single 'default' tenant at weight 1)
    admission_tenants: str = ""

    def validate_fleet(self) -> None:
        """Config-shaped fleet/admission validation (ValueError = rc 2)."""
        if self.fleet_replica < 0:
            raise ValueError(
                f"serve.fleet_replica must be >= 0, got {self.fleet_replica}")
        if self.fleet_ttl_s <= 0:
            raise ValueError(
                f"serve.fleet_ttl_s must be > 0, got {self.fleet_ttl_s}")
        if self.admission_deadline_ms < 0:
            raise ValueError(
                f"serve.admission_deadline_ms must be >= 0, "
                f"got {self.admission_deadline_ms}")
        from .serve.fleet import parse_tenants

        parse_tenants(self.admission_tenants)

    def resolve_buckets(self, dp: int = 1) -> tuple:
        """Validated ascending bucket tuple (ValueError = config-shaped, the
        serve CLI maps it to rc 2).

        `dp` is the number of serve devices: every padded batch splits its
        leading axis into dp equal row blocks, so each bucket must be a dp
        multiple. Explicit buckets that violate this are rejected (the
        operator asked for shapes that cannot run); auto-buckets round UP
        to the next dp multiple — padding overhead, never a dropped
        request (the JAX package's rule and error text)."""
        if self.max_batch < 1:
            raise ValueError(f"serve.max_batch must be >= 1, got {self.max_batch}")
        if self.batch_timeout_ms < 0:
            raise ValueError(
                f"serve.batch_timeout_ms must be >= 0, got {self.batch_timeout_ms}")
        if self.queue_depth < 1:
            raise ValueError(f"serve.queue_depth must be >= 1, got {self.queue_depth}")
        if self.topk < 1:
            raise ValueError(f"serve.topk must be >= 1, got {self.topk}")
        if dp < 1:
            raise ValueError(f"serve data-parallel width must be >= 1, got {dp}")
        if self.buckets:
            buckets = tuple(int(b) for b in self.buckets)
            bad = [b for b in buckets if b % dp]
            if bad:
                raise ValueError(
                    f"serve.buckets {bad} not divisible by the serve mesh's "
                    f"data-parallel width dp={dp} — every padded batch shards "
                    "its leading axis over 'data', so each bucket must be a "
                    f"multiple of {dp} (error: serve-bucket-dp-indivisible)")
        else:
            buckets, b = [], 1
            while b < self.max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_batch)
            buckets = dp_round_up_buckets(buckets, dp)
        if any(b < 1 for b in buckets) or list(buckets) != sorted(set(buckets)):
            raise ValueError(
                f"serve.buckets must be positive and strictly ascending, "
                f"got {buckets}")
        if self.max_batch > buckets[-1]:
            raise ValueError(
                f"serve.max_batch={self.max_batch} exceeds the largest bucket "
                f"{buckets[-1]} — a full batch would have no padded shape to "
                "run at")
        return buckets


@dataclass
class Config:
    workload: str = "baseline"  # baseline | arcface | cdr | nested | plc
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    run: RunConfig = field(default_factory=RunConfig)
    plc: PLCConfig = field(default_factory=PLCConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)


def baseline_preset() -> Config:
    """BASELINE/main.py defaults: ResNet-50, CE, 2173 classes."""
    return Config(workload="baseline")


def arcface_preset() -> Config:
    """ARCFACE/arc_main.py: ResNet-50 → 256-d embedding + ArcMarginProduct,
    batch 32, Adam."""
    cfg = Config(workload="arcface")
    cfg.data.batch_size = 32
    cfg.data.imgs_per_class = 400  # arc_main.py:190
    cfg.model.head = "arcface"
    cfg.optim.optimizer = "adam"
    return cfg


def cdr_preset() -> Config:
    """CDR/main.py: ResNet-50, first 100 classes, batch 128, SGD 0.1,
    MultiStepLR([10, 20]), the selective-gradient step, 30 epochs."""
    cfg = Config(workload="cdr")
    cfg.data.batch_size = 128
    cfg.data.max_classes = 100
    cfg.data.num_classes = 100
    cfg.data.transform = "cdr"
    cfg.optim.lr = 0.1
    cfg.optim.schedule = "multistep"
    cfg.optim.milestones = (10, 20)
    cfg.optim.grad_transform = "cdr"
    cfg.run.epochs = 30
    return cfg


def nested_preset() -> Config:
    """NESTED/train.py: ResNet-50 feat + bias-free linear cls (nested head),
    batch 128, 10k-iter warmup → lr 1e-2, MultiStepLR([20, 30, 40, 120]),
    nested σ=100, freeze-BN, best-only checkpoints (train.py:527,529)."""
    cfg = Config(workload="nested")
    cfg.data.batch_size = 128
    cfg.model.head = "nested"
    cfg.model.nested_std = 100.0
    cfg.model.freeze_bn = True
    cfg.optim.lr = 1e-2
    cfg.optim.schedule = "multistep"
    cfg.optim.milestones = (20, 30, 40, 120)
    cfg.optim.warmup_iters = 10000
    cfg.run.epochs = 50
    cfg.run.save_best_only = True
    cfg.run.eval_first = True
    return cfg


def plc_preset() -> Config:
    """PLC correction training on Clothing1M-scale data: ResNet-50, batch
    128, 14 classes, LRT correction after 2 warmup epochs, SGD 0.01,
    MultiStepLR([10, 20]), 30 epochs."""
    cfg = Config(workload="plc")
    cfg.data.batch_size = 128
    cfg.data.num_classes = 14  # Clothing1M
    cfg.optim.lr = 0.01
    cfg.optim.schedule = "multistep"
    cfg.optim.milestones = (10, 20)
    cfg.run.epochs = 30
    return cfg


PRESETS = {
    "baseline": baseline_preset,
    "arcface": arcface_preset,
    "cdr": cdr_preset,
    "nested": nested_preset,
    "plc": plc_preset,
}


def get_preset(name: str) -> Config:
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown workload {name!r}; one of {sorted(PRESETS)}")
