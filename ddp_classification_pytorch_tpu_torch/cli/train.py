"""`train` entry point of the port — the JAX train CLI's flags for the
paths ported so far (the five reference workloads — baseline, arcface,
cdr, nested and plc — on the ResNets and VGG19-BN over any number of
cards, on TResNet-M and the ViT family on one; on synthetic data, image
folders, CIFAR pickles and PLC's annotation datasets, with resume; the
profiler window and `--debug_nans`), on the card.

    torchrun --nproc_per_node 4 -m ddp_classification_pytorch_tpu_torch.cli.train \
        baseline --dataset imagefolder --train_dir T --val_dir V \
        --model resnet50 --batchsize 128 --epochs 90 --out runs/r50
    python -m ddp_classification_pytorch_tpu_torch.cli.train baseline \
        --dataset synthetic --model resnet50 --out runs/r50_1card
    python -m ddp_classification_pytorch_tpu_torch.cli.train baseline \
        --dataset imagefolder --train_dir T --val_dir V --model tresnet_m \
        --image_size 224 --batchsize 32 --epochs 2 --out runs/tresnet
    python -m ddp_classification_pytorch_tpu_torch.cli.train baseline \
        --dataset imagefolder --train_dir T --val_dir V --model tresnet_m \
        --image_size 224 --batchsize 32 --epochs 4 --out runs/tresnet \
        --auto_resume                  # or --resume runs/x/ckpt_e1.pt
    python -m ddp_classification_pytorch_tpu_torch.cli.train baseline \
        --dataset synthetic --model vit_b16 --image_size 512 \
        --flash_attention --batchsize 32 --epochs 1 --out runs/vit
    python -m ddp_classification_pytorch_tpu_torch.cli.train arcface \
        --dataset synthetic --model resnet50 --out runs/arc   # or cdr, nested
    python -m ddp_classification_pytorch_tpu_torch.cli.train nested \
        --dataset synthetic --model vgg19_bn --out runs/vgg   # or tresnet_m
    python -m ddp_classification_pytorch_tpu_torch.cli.train baseline \
        --dataset synthetic --model resnet50 --batchsize 128 --epochs 1 \
        --profile_steps 4 --out runs/prof  # → runs/prof/profile/<host>.trace.json.gz
    python -m ddp_classification_pytorch_tpu_torch.cli.train cdr \
        --folder D --out runs/cdr        # the cdr transform, item route
    python -m ddp_classification_pytorch_tpu_torch.cli.train plc \
        --dataset plc --train_dir C1M --out runs/plc  # Clothing1M layout

Under torchrun each process drives the card `LOCAL_RANK` names and joins
the process group over NCCL (gloo with `--device cpu`); `--batchsize` is
one process's batch, so the global batch is `--batchsize` × the world
size; the ResNets' BNs take the global batch's statistics; rank 0 prints
and writes the records and checkpoints. A plain `python -m` run is the
same path with no process group. A ResNet or TResNet-M checkpoint it
writes (`<out>/ckpt_e<N>.pt`, the whole train state) is what
`cli/serve.py --ckpt` serves (`cli/serve.py arcface` / `nested` for those
heads; a cdr or plc checkpoint is a plain fc model). A plc run also
writes `plc_labels.npy` and δ (`meta.json`'s `plc_delta`), which resume
restores.

An explicit pod (`--multihost`) rendezvouses from the ``FLEET_*``
variables instead of torchrun's (`parallel/fleet.py::initialize_with_retry`:
bounded retries, elastic membership from lease files under
``FLEET_ELASTIC=1``); `cli/supervise.py` restarts a run with
`--auto_resume` by its exit code. `--fault_spec` (or ``CHAOS_FAULT_SPEC``)
stages faults (`utils/chaos.py`) and `--hang_timeout_s` arms the hang
watchdog:

    FLEET_COORDINATOR=10.0.0.1:29500 FLEET_NUM_PROCESSES=2 FLEET_PROCESS_ID=0 \
    python -m ddp_classification_pytorch_tpu_torch.cli.supervise baseline \
        --dataset synthetic --model resnet50 --out runs/pod --multihost \
        --hang_timeout_s 600 --fault_spec "sigterm@step=20"

The reference's `--world_size`, `--local_rank` / `--local-rank` (which
`torch.distributed.launch` adds) and `--gpu` are accepted and ignored.

Exit codes, as the JAX CLI's:

- **rc 1**: an unhandled exception (a loader IO error, an OOM): transient,
  the supervisor restarts it after a backoff;
- **rc 2**: config errors — an unported dataset, preset, arch or option (`--sharded_ce`, `--head_lr` on a model
  without a margin head, `--pretrained` on a ViT), a flag this CLI does not take (argparse), bad values, a
  missing data directory, a `--resume` file that fails its sha256, a
  native dataplane (or its decoder) that does not build on this machine, `--dp` other
  than the world size, TResNet-M over more than one rank, a malformed
  `--fault_spec`, malformed ``FLEET_*`` variables (`FleetConfigError`);
- **rc 3**: no CUDA device and `--device cpu` not asked for (it never
  carries on on the CPU);
- **rc 6**: the `--multihost` rendezvous never completed within its
  retries (`RendezvousFailed`);
- **rc 7**: the hang watchdog fired (no progress for `--hang_timeout_s`);
- **rc 8**: `run.max_bad_steps` consecutive non-finite steps (diverged;
  deterministic, a supervisor must not restart it);
- **rc 9**: the ranks restored different checkpoints, or joined different
  worlds (`PodInconsistent`);
- **rc 10**: the surviving world cannot train (`PodUnviable`: below
  ``FLEET_MIN_PROCESSES`` or off `--dp`);
- **rc 11**: the pod's membership changed (`PodReform`): every rank exits
  at the epoch boundary to re-form;
- **`PodAbort.code`**: a rank's abort intent exchanged at the epoch
  boundary, the same on every rank (143 for a deferred SIGTERM, 8 for a
  divergence on a pod).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from ..config import Config, get_preset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ddp_classification_pytorch_tpu_torch.cli.train",
        description="classification training on the card (ported: "
                    "ResNet, TResNet-M and ViT on synthetic data, image "
                    "folders and CIFAR; torchrun for data parallelism)")
    p.add_argument("workload", choices=["baseline", "arcface", "cdr", "nested", "plc"],
                   help="which reference silo's recipe to run")

    d = p.add_argument_group("data")
    d.add_argument("--folder", "-f", default="", help="dataset root holding "
                   "train/ and val/ (reference --folder, BASELINE/main.py:27)")
    d.add_argument("--train_dir", default="",
                   help="explicit train dir (overrides --folder)")
    d.add_argument("--val_dir", default="",
                   help="explicit val dir (overrides --folder)")
    d.add_argument("--dataset", default="",
                   help="imagefolder | synthetic | plc | cifar10 | cifar100")
    d.add_argument("--synthetic_size", type=int, default=0,
                   help="train-set size for --dataset synthetic (default 512)")
    d.add_argument("--batchsize", "-b", type=int, default=0)
    d.add_argument("--num_classes", type=int, default=0)
    d.add_argument("--imgs_per_class", type=int, default=0,
                   help="per-class cap (500 baseline / 400 arcface)")
    d.add_argument("--num_workers", type=int, default=0,
                   help="loader threads (default 4)")
    d.add_argument("--device_prefetch", type=int, default=-1,
                   help="batches staged on the card ahead of the step loop "
                        "(default 2; 0 = copy inside the step loop)")
    d.add_argument("--image_size", type=int, default=0)
    d.add_argument("--crop_size", type=int, default=0,
                   help="train crop / resize-short side (default 256, the "
                        "reference's RandomResizedCrop(256))")
    d.add_argument("--transform", default="",
                   help="transform preset for image folders: baseline | "
                        "clothing1m (the native dataplane) | cdr | cifar "
                        "(decode and numpy transform per item)")
    d.add_argument("--input_dtype", default="", choices=["", "uint8", "float32"],
                   help="H2D wire format (default uint8: raw pixels, "
                        "normalized on the device)")

    m = p.add_argument_group("model")
    m.add_argument("--model", "--arch", dest="model", default="",
                   help="resnet18 | resnet34 | resnet50 (default) | "
                        "resnet101 | resnet152 | vgg19_bn | tresnet_m | "
                        "timm (TResNet-M) | vit_t16 | vit_s16 | vit_b16")
    m.add_argument("--variant", default="", help="ResNet stem: imagenet | "
                   "cifar (default imagenet; cifar for --dataset cifar*)")
    m.add_argument("--pretrained", action="store_true",
                   help="start from --pretrained_path's weights (the "
                        "ResNets, vgg19_bn, tresnet_m)")
    m.add_argument("--pretrained_path", default="",
                   help="a local torchvision / timm .pth (or {'state_dict'} "
                        "/ NESTED {'feat','cls'} file); implies --pretrained")
    m.add_argument("--flash_attention", action="store_true",
                   help="ViT: the flash kernels for attention")
    m.add_argument("--flash_min_tokens", type=int, default=-1,
                   help="below this token count --flash_attention takes the "
                        "dense op (default 1024; 0 = kernel always)")
    m.add_argument("--dtype", default="", help="bfloat16 | float32 compute dtype")

    o = p.add_argument_group("optimization")
    o.add_argument("--optimizer", default="", help="sgd | adam")
    o.add_argument("--lr", type=float, default=0.0)
    o.add_argument("--momentum", type=float, default=-1.0)
    o.add_argument("--weight_decay", type=float, default=-1.0)
    o.add_argument("--epochs", type=int, default=0)
    o.add_argument("--lrSchedule", type=int, nargs="*", default=None,
                   help="multistep milestones (epochs)")
    o.add_argument("--warmUpIter", type=int, default=-1,
                   help="linear warmup iterations")

    a = p.add_argument_group("arcface")
    a.add_argument("--arc_s", type=float, default=-1.0)
    a.add_argument("--arc_m", type=float, default=-1.0)
    a.add_argument("--head_lr", type=float, default=-1.0,
                   help="lr for the margin-head param group (reference's "
                        "optimizer group 2, arc_main.py:248-253); unset = "
                        "inherit --lr")
    a.add_argument("--head_weight_decay", type=float, default=-1.0,
                   help="weight decay for the margin-head param group; "
                        "unset = inherit --weight_decay")
    a.add_argument("--easy_margin", dest="easy_margin", default=None,
                   action="store_true")

    c = p.add_argument_group("cdr")
    c.add_argument("--noise_rate", type=float, default=-1.0, help="CDR/main.py:37")
    c.add_argument("--num_gradual", type=int, default=-1, help="CDR/main.py:41")
    c.add_argument("--live_clip_schedule", action="store_true",
                   help="use the reference's INTENDED gradual clip schedule "
                   "instead of its actual dead-code constant (CDR/main.py:222-227)")

    n = p.add_argument_group("nested")
    n.add_argument("--nested", type=float, default=-1.0,
                   help="Gaussian σ over feature dims (NESTED/train.py:512-530)")
    n.add_argument("--freeze-bn", dest="freeze_bn", default=None,
                   action="store_true")
    n.add_argument("--no-freeze-bn", dest="freeze_bn", action="store_false",
                   help="train BN normally (the preset's freeze-BN mirrors "
                        "NESTED/train.py:529, which assumes a pretrained "
                        "backbone; from-scratch runs want live BN)")
    n.add_argument("--resumePth", default="",
                   help="alias of --resume (NESTED/train.py:481)")

    pl = p.add_argument_group("plc")
    pl.add_argument("--correction", default="", choices=["", "lrt", "prob"],
                    help="label-correction method (PLC/utils.py:291,321)")
    pl.add_argument("--delta", type=float, default=-1.0, help="initial θ threshold")
    pl.add_argument("--delta_increment", type=float, default=-1.0, help="β step")
    pl.add_argument("--thd", type=float, default=-1.0, help="prob-correction confidence")
    pl.add_argument("--plc_warmup_epochs", type=int, default=-1)
    pl.add_argument("--plc_max_flip_frac", type=float, default=-1.0,
                    help="cap the label fraction one correction pass may "
                         "flip, keeping the most-confident flips (1.0 = "
                         "uncapped reference semantics)")
    pl.add_argument("--plc_batch_stat_predictions", action="store_true",
                    help="harvest correction f(x) with each batch's own BN "
                         "statistics (the reference's during-training "
                         "flavor, PLC/utils.py:269-271); unsafe on the "
                         "class-sorted ordered scan")

    par = p.add_argument_group("parallelism")
    par.add_argument("--dp", type=int, default=0,
                     help="data-parallel width; must equal the world size "
                          "torchrun gives (0 = the world size)")
    par.add_argument("--sharded_ce", action="store_true",
                     help="the partial-FC ArcFace CE over a model axis: not "
                          "ported (rc 2)")
    par.add_argument("--multihost", action="store_true",
                     help="join an explicit pod from FLEET_COORDINATOR / "
                          "FLEET_NUM_PROCESSES / FLEET_PROCESS_ID with "
                          "bounded retries (parallel/fleet.py); torchrun's "
                          "processes need no flag")

    r = p.add_argument_group("run")
    r.add_argument("--seed", type=int, default=-1)
    r.add_argument("--out", default="", help="output dir (records + checkpoints)")
    r.add_argument("--resume", default="", help="checkpoint to resume from")
    r.add_argument("--auto_resume", action="store_true",
                   help="resume from the newest verified checkpoint in --out "
                        "if there is one (preemption recovery)")
    r.add_argument("--tensorboard", action="store_true",
                   help="write TensorBoard event files to <out>/tb")
    r.add_argument("--log_every", type=int, default=0)
    r.add_argument("--save_best_only", action="store_true")
    r.add_argument("--keep_checkpoints", type=int, default=0,
                   help="prune epoch checkpoints beyond the newest N (0 = keep "
                        "all; ckpt_best is always kept)")
    r.add_argument("--device", default="", choices=["", "cuda", "cpu"],
                   help="default cuda; cpu only when asked (rc 3 when cuda "
                        "is missing and cpu was not asked for)")
    r.add_argument("--hang_timeout_s", type=float, default=0.0,
                   help="mid-run hang watchdog: exit 7 when no host-observed "
                        "progress lands for this many seconds, so "
                        "cli/supervise.py + --auto_resume can recover (0 = "
                        "off; set WELL above the slowest silent stretch — "
                        "on a cold build cache the kernels' first nvcc "
                        "build happens inside it)")
    r.add_argument("--max_bad_steps", type=int, default=-1,
                   help="non-finite step sentinel: after N CONSECUTIVE "
                        "skipped steps exit 8 ('diverged' — deterministic, "
                        "the supervisor does not restart it). Default 25; "
                        "0 = skip forever, never exit")
    r.add_argument("--profile_steps", type=int, default=0,
                   help="capture a torch.profiler trace of N train steps of "
                        "epoch 0 into <out>/profile (obs/trace.py reads it)")
    r.add_argument("--profile_dir", default="",
                   help="where --profile_steps writes (default <out>/profile)")
    r.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first op with a "
                        "NaN output (jax_debug_nans; a host sync per op)")
    r.add_argument("--fault_spec", default="",
                   help="deterministic fault injection (utils/chaos.py), "
                        "e.g. 'nan_loss@step=7..9,ckpt_io@epoch=1,"
                        "loader_io@batch=3,sigterm@step=20'; "
                        "CHAOS_FAULT_SPEC overrides")

    compat = p.add_argument_group("reference-CLI compatibility (ignored)")
    compat.add_argument("--world_size", type=int, default=None,
                        help="ignored: the world is torchrun's (or "
                             "--multihost's FLEET_NUM_PROCESSES)")
    compat.add_argument("--local_rank", "--local-rank", dest="local_rank",
                        type=int, default=None,
                        help="ignored: the card is LOCAL_RANK's, which "
                             "torchrun sets (torch.distributed.launch also "
                             "passes --local-rank=N)")
    compat.add_argument("--gpu", default=None,
                        help="ignored: device selection is --device and "
                             "LOCAL_RANK's (CDR/main.py:51, "
                             "NESTED/train.py:473 pass it)")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    if args.sharded_ce:
        raise ValueError("--sharded_ce (the partial-FC ArcFace CE over a "
                         "model axis) is not ported: the port has no model "
                         "axis (ROADMAP.md)")
    cfg = get_preset(args.workload)
    if args.folder:
        cfg.data.train_dir = f"{args.folder}/train"
        cfg.data.val_dir = f"{args.folder}/val"
    if args.train_dir:
        cfg.data.train_dir = args.train_dir
    if args.val_dir:
        cfg.data.val_dir = args.val_dir
    if args.dataset:
        cfg.data.dataset = args.dataset
        if args.dataset in ("cifar10", "cifar100"):
            # CIFAR's facts over the preset's ImageNet defaults, unless given
            if not args.num_classes:
                cfg.data.num_classes = 10 if args.dataset == "cifar10" else 100
            if not args.image_size:
                cfg.data.image_size = 32
            if not args.variant:
                cfg.model.variant = "cifar"
    if args.synthetic_size:
        cfg.data.synthetic_size = args.synthetic_size
    if args.batchsize:
        cfg.data.batch_size = args.batchsize
    if args.num_classes:
        cfg.data.num_classes = args.num_classes
    if args.imgs_per_class:
        cfg.data.imgs_per_class = args.imgs_per_class
    if args.num_workers:
        cfg.data.num_workers = args.num_workers
    if args.device_prefetch >= 0:
        cfg.data.device_prefetch = args.device_prefetch
    if args.image_size:
        cfg.data.image_size = args.image_size
    if args.crop_size:
        cfg.data.train_crop_size = args.crop_size
    if args.transform:
        cfg.data.transform = args.transform
    if args.input_dtype:
        cfg.data.input_dtype = args.input_dtype

    if args.model:
        cfg.model.arch = args.model
    if args.flash_attention:
        cfg.model.flash_attention = True
    if args.flash_min_tokens >= 0:
        cfg.model.flash_min_tokens = args.flash_min_tokens
    if args.dtype:
        cfg.model.dtype = args.dtype
    if args.variant:
        cfg.model.variant = args.variant
    if args.pretrained:
        cfg.model.pretrained = True
    if args.pretrained_path:
        cfg.model.pretrained = True
        cfg.model.pretrained_path = args.pretrained_path
    if args.arc_s >= 0:
        cfg.model.arc_s = args.arc_s
    if args.arc_m >= 0:
        cfg.model.arc_m = args.arc_m
    if args.easy_margin is not None:
        cfg.model.arc_easy_margin = args.easy_margin
    if args.nested >= 0:
        cfg.model.nested_std = args.nested
    if args.freeze_bn is not None:
        cfg.model.freeze_bn = args.freeze_bn
    cfg.parallel.data_parallel = args.dp

    if args.optimizer:
        cfg.optim.optimizer = args.optimizer
    if args.lr:
        cfg.optim.lr = args.lr
    if args.momentum >= 0:
        cfg.optim.momentum = args.momentum
    if args.weight_decay >= 0:
        cfg.optim.weight_decay = args.weight_decay
    if args.head_lr >= 0:
        cfg.optim.head_lr = args.head_lr
    if args.head_weight_decay >= 0:
        cfg.optim.head_weight_decay = args.head_weight_decay
    if args.lrSchedule is not None:
        cfg.optim.schedule = "multistep"
        cfg.optim.milestones = tuple(args.lrSchedule)
    if args.warmUpIter >= 0:
        cfg.optim.warmup_iters = args.warmUpIter
    if args.noise_rate >= 0:
        cfg.optim.noise_rate = args.noise_rate
    if args.num_gradual >= 0:
        cfg.optim.num_gradual = args.num_gradual
    if args.live_clip_schedule:
        cfg.optim.cdr_dead_schedule = False

    if args.correction:
        cfg.plc.correction = args.correction
    if args.delta >= 0:
        cfg.plc.current_delta = args.delta
    if args.delta_increment >= 0:
        cfg.plc.delta_increment = args.delta_increment
    if args.thd >= 0:
        cfg.plc.thd = args.thd
    if args.plc_warmup_epochs >= 0:
        cfg.plc.warmup_epochs = args.plc_warmup_epochs
    if args.plc_max_flip_frac >= 0:
        cfg.plc.max_flip_frac = args.plc_max_flip_frac
    if args.plc_batch_stat_predictions:
        cfg.plc.batch_stat_predictions = True

    if args.epochs:
        cfg.run.epochs = args.epochs
    if args.seed >= 0:
        cfg.run.seed = args.seed
    if args.out:
        cfg.run.out_dir = args.out
    if args.log_every:
        cfg.run.log_every = args.log_every
    if args.resume or args.resumePth:
        cfg.run.resume = args.resume or args.resumePth
    if args.auto_resume:
        cfg.run.auto_resume = True
    if args.tensorboard:
        cfg.run.tensorboard = True
    if args.save_best_only:
        cfg.run.save_best_only = True
    if args.keep_checkpoints:
        cfg.run.keep_checkpoints = args.keep_checkpoints
    if args.hang_timeout_s:
        cfg.run.hang_timeout_s = args.hang_timeout_s
    if args.max_bad_steps >= 0:
        cfg.run.max_bad_steps = args.max_bad_steps
    if args.fault_spec:
        cfg.run.fault_spec = args.fault_spec
    if args.profile_steps:
        cfg.run.profile_steps = args.profile_steps
    if args.profile_dir:
        cfg.run.profile_dir = args.profile_dir
    if args.debug_nans:
        cfg.run.debug_nans = True
    if cfg.data.batch_size < 1 or cfg.run.log_every < 1:
        raise ValueError("--batchsize and --log_every must be >= 1")
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..parallel import ddp
    from ..parallel.fleet import (FleetConfigError, PodAbort,
                                  PodInconsistent, PodReform, PodUnviable,
                                  RendezvousFailed, initialize_with_retry)
    from ..train.sentinel import SentinelDiverged
    from ..utils.backend_probe import BackendUnavailable, resolve_device

    args = build_parser().parse_args(argv)
    try:
        cfg = config_from_args(args)
    except ValueError as e:
        print(f"[trainer] config error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    if (args.world_size is not None or args.local_rank is not None
            or args.gpu is not None):
        print("[compat] --world_size/--local_rank/--gpu are ignored: the "
              "world and the card come from torchrun's variables "
              "(or --multihost's FLEET_*)")
    try:
        device = resolve_device(args.device)
    except BackendUnavailable as e:
        print(f"[trainer] backend unreachable: {e}", file=sys.stderr)
        raise SystemExit(3) from None
    rendezvous = None
    if args.multihost:
        # the retrying rendezvous from FLEET_*, paced by the shared
        # $OUT/generation file; --dp gates an elastic world's viability
        def rendezvous(dev):
            initialize_with_retry(out_dir=cfg.run.out_dir, device=dev,
                                  data_parallel=cfg.parallel.data_parallel)
    try:
        # the process group (torchrun's or the pod's), torn down on every
        # way out; the rc 2 and rc 8 exits included
        with ddp.process_group(device, rendezvous) as device:
            _train(cfg, device)
    except (FleetConfigError, PodInconsistent, PodUnviable,
            RendezvousFailed) as e:
        # FleetConfigError (malformed FLEET_*) is rc 2, deterministic;
        # PodInconsistent rc 9 (split-brain resume or membership),
        # PodUnviable rc 10 and RendezvousFailed rc 6 are outage-shaped
        print(f"[trainer] {type(e).__name__}: {e}", file=sys.stderr)
        raise SystemExit(e.exit_code) from None
    except SentinelDiverged as e:
        print(f"[trainer] diverged: {e}", file=sys.stderr)
        raise SystemExit(SentinelDiverged.exit_code) from None
    except PodAbort as e:
        # a rank's abort intent (a deferred SIGTERM 143, a divergence 8)
        # exchanged at the epoch boundary: every rank exits with it
        print(f"[trainer] {e}", file=sys.stderr)
        raise SystemExit(e.code) from None
    except PodReform as e:
        print(f"[trainer] pod-reform: {e}", file=sys.stderr)
        raise SystemExit(PodReform.exit_code) from None


def _train(cfg: Config, device) -> None:
    """Build the workload's trainer (its config-shaped failures rc 2) and
    run it."""
    from ..data.native import DataplaneUnavailable
    from ..train.loop import Trainer
    from ..train.plc_loop import PLCTrainer

    try:
        trainer = (PLCTrainer if cfg.workload == "plc" else Trainer)(
            cfg, device)
    except (ValueError, FileNotFoundError) as e:  # an unported arch,
        # head, dataset or option, a missing data dir, a bad --resume,
        # --dp off the world size, a malformed --fault_spec: deterministic
        print(f"[trainer] config error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    except DataplaneUnavailable as e:
        print(f"[trainer] native dataplane unavailable: {e}",
              file=sys.stderr)
        raise SystemExit(2) from None
    if cfg.run.debug_nans:
        from ..utils.debug_nans import NanCheck

        with NanCheck():
            trainer.run()
        return
    trainer.run()


if __name__ == "__main__":
    main()
