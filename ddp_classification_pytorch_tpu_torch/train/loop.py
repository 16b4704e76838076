"""The trainer — the port of the JAX package's `train/loop.py::Trainer`, one
process per device: datasets → this rank's loaders (worker threads, the
native dataplane on image folders) → device prefetch → state (wrapped
once in DistributedDataParallel under a process group, parallel/ddp.py)
→ steps → `train_epoch` / `evaluate` (sums reduced across the ranks) →
records, tensorboard scalars and verified checkpoints of the whole train
state, written by rank 0, which `--resume` and `--auto_resume` pick up on
every rank. Trains the ResNets (over any number of ranks, with global
batch statistics; heads fc, arcface and nested, CDR's gradient
transform), TResNet-M (one rank) and the ViT family, on synthetic data,
image folders and CIFAR pickles; `cli/serve.py --ckpt` serves the conv
nets' checkpoints. The nested head's eval is the all-K sweep
(`nested_eval`: `val_top1` at the best K, `val_top3` there, `best_k`).

Image folders of the `cdr` and `cifar` kinds, and PLC's annotation
datasets, take the item route (`data/native.py::decode_image` and the
numpy `Transform` on the loader's threads), the JAX package's PIL route.
The PLC workload's trainer is `train/plc_loop.py::PLCTrainer`.

Not ported yet (ROADMAP.md): async checkpoints, `h2d_overlap`, the
profiler window, the pod fleet, chaos hooks and the compile sentinel.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import Config
from ..data import native
from ..data.device_prefetch import DevicePrefetcher
from ..data.imagefolder import ImageFolderDataset
from ..data.loader import Loader
from ..data.synthetic import SyntheticDataset
from ..data.transforms import INPUT_DTYPES, build_transform, preset_for_dataset
from ..obs.registry import Registry
from ..parallel import ddp
from ..utils.logging import EtaLogger, RecordWriter, host0_print
from ..ops.nested import best_k
from .checkpoint import CheckpointManager
from .sentinel import StepSentinel
from .state import TRESNET_ARCHS, create_train_state, param_count
from .steps import make_eval_step, make_nested_eval_step, make_train_step


def build_datasets(cfg: Config) -> Tuple[Any, Any]:
    """(train_ds, val_ds): the JAX package's (`loop.py:88-147`) for
    synthetic data, image folders, CIFAR pickles and PLC's annotation
    datasets. A dataset kind it does not know is a ValueError (rc 2)."""
    d = cfg.data
    if d.input_dtype not in INPUT_DTYPES:
        raise ValueError(
            f"unknown data.input_dtype {d.input_dtype!r}; one of {INPUT_DTYPES}")
    if d.dataset == "synthetic":
        size = d.synthetic_size or 512
        train = SyntheticDataset(size, d.image_size, d.num_classes,
                                 seed=cfg.run.seed, out_dtype=d.input_dtype)
        val = SyntheticDataset(max(size // 4, d.batch_size), d.image_size,
                               d.num_classes, seed=cfg.run.seed,
                               item_offset=size, out_dtype=d.input_dtype)
        return train, val
    preset = preset_for_dataset(d.dataset, d.transform)
    if preset is None:
        raise ValueError(f"unknown dataset {d.dataset!r}")
    if not d.train_dir:
        raise ValueError(f"dataset {d.dataset!r} needs --train_dir (or "
                         "--folder)")
    t_train, t_val = (build_transform(preset, train, d.image_size,
                                      d.train_crop_size, d.input_dtype)
                      for train in (True, False))
    if d.dataset == "imagefolder":
        train = ImageFolderDataset.from_root(d.train_dir, d.imgs_per_class,
                                             d.max_classes, t_train)
        val = ImageFolderDataset.from_root(d.val_dir or d.train_dir,
                                           d.imgs_per_class, d.max_classes,
                                           t_val)
        return train, val
    if d.dataset == "plc":
        # Clothing1M's annotation layout (PLC/FolderDataset.py:9-75): the
        # dirs are data roots holding annotations/ with the key lists
        from ..data.plc import PLCDataset

        train = PLCDataset.from_annotations(d.train_dir, "train", t_train,
                                            cls_size=d.imgs_per_class or 0)
        val = PLCDataset.from_annotations(d.val_dir or d.train_dir, "val",
                                          t_val)
        return train, val
    from ..data.cifar import CIFARDataset

    train = CIFARDataset(d.train_dir, True, t_train, kind=d.dataset)
    val = CIFARDataset(d.val_dir or d.train_dir, False, t_val, kind=d.dataset)
    if d.num_classes != train.num_classes:
        raise ValueError(
            f"data.num_classes={d.num_classes} but {d.dataset} has "
            f"{train.num_classes} classes — the CLI sets both defaults when "
            "--dataset cifar10/cifar100 is passed")
    return train, val


def make_native_batcher(ds, cfg: Config, train: bool
                        ) -> Optional[native.NativeBatcher]:
    """The dataplane's batcher for an image folder whose transform it runs
    (baseline, clothing1m); None for other data, which takes the item
    route (JAX `make_native_batcher`)."""
    d = cfg.data
    if (not isinstance(ds, ImageFolderDataset)
            or d.transform not in native.NativeBatcher.SUPPORTED):
        return None
    return native.NativeBatcher(ds, d.transform, train, d.image_size,
                                d.train_crop_size, cfg.run.seed,
                                d.num_workers, out_dtype=d.input_dtype)


def decodes_items(ds) -> bool:
    """Whether the dataset's items decode files (`decode_image`)."""
    from ..data.plc import PLCDataset

    return isinstance(ds, (ImageFolderDataset, PLCDataset))


def _sum_into(totals: Optional[Dict[str, torch.Tensor]],
              out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device-side running sums (one host read at the end)."""
    if totals is None:
        return {k: v.detach().clone() for k, v in out.items()}
    for k, v in out.items():
        totals[k] += v
    return totals


def check_world(cfg: Config, world: int) -> None:
    """ValueError (rc 2) unless `parallel.data_parallel` fits the world
    size and the arch trains over it: TResNet-M's fused ABNs do not share
    their statistics across ranks yet (ROADMAP.md)."""
    dp = cfg.parallel.data_parallel
    if dp and dp != world:
        raise ValueError(f"--dp {dp} but the process group has {world} "
                         "rank(s): one process drives one card, so --dp "
                         "must equal torchrun's --nproc_per_node × nodes "
                         "(or be 0)")
    if world > 1 and cfg.model.arch in TRESNET_ARCHS:
        raise ValueError(f"{cfg.model.arch} trains on one rank only: its "
                         "fused ABNs do not share batch statistics across "
                         f"ranks yet, and the world has {world} "
                         "(ROADMAP.md)")


def eval_totals(state, eval_step, batches) -> Dict[str, float]:
    """{loss_sum, top1, top3, n} of `eval_step` over this rank's `batches`
    (tuples of device tensors ending in the valid mask), summed on the
    device, then across the ranks in one all-reduce: the exact global
    sums, wrap padding masked on every rank (JAX `make_eval_step`)."""
    totals = None
    for batch in batches:
        totals = _sum_into(totals, eval_step(state, *batch))
    keys = ("loss_sum", "top1", "top3", "n")
    if totals is None:  # every rank holds as many batches: none has one
        return dict.fromkeys(keys, 0.0)
    packed = ddp.sum_across(torch.stack([totals[k].float() for k in keys]))
    return dict(zip(keys, packed.tolist()))


def nested_eval(state, eval_step, batches) -> Dict[str, float]:
    """The nested head's eval (JAX `loop.py:501-522`): `eval_step`'s
    per-K counts over this rank's `batches` summed on the device, then
    across the ranks in one all-reduce; `best_k` picks the K. Returns
    `val_top1` (at the best K), `val_top3` at that K and `best_k`."""
    totals = None
    for batch in batches:
        totals = _sum_into(totals, eval_step(state, *batch))
    if totals is None:  # every rank holds as many batches: none has one
        return {"val_top1": 0.0, "val_top3": 0.0, "best_k": 0}
    d = totals["top1_k"].shape[0]
    packed = ddp.sum_across(torch.cat([
        totals["top1_k"], totals["top3_k"], totals["n"].float()[None]])).cpu()
    n = max(float(packed[-1]), 1.0)
    acc, k = best_k(packed[:d], n)
    return {"val_top1": acc, "val_top3": float(packed[d + k] / n),
            "best_k": k}


class Trainer:
    """`train_ds` / `val_ds` replace `build_datasets(cfg)` (as the JAX
    Trainer takes them)."""

    def __init__(self, cfg: Config, device: torch.device,
                 train_ds: Any = None, val_ds: Any = None):
        device = ddp.local_device(device)
        self.cfg, self.device = cfg, device
        world, primary = ddp.world_size(), ddp.is_primary()
        check_world(cfg, world)
        self.obs = Registry()
        self.sentinel = StepSentinel(cfg.run.max_bad_steps, registry=self.obs)
        if train_ds is None:
            train_ds, val_ds = build_datasets(cfg)
        self.train_ds, self.val_ds = train_ds, val_ds
        train_batcher = make_native_batcher(self.train_ds, cfg, train=True)
        val_batcher = make_native_batcher(self.val_ds, cfg, train=False)
        self.native_dataplane = train_batcher is not None
        # build now: DataplaneUnavailable is rc 2, never a fallback
        if self.native_dataplane:
            native.get_lib()
            host0_print("[trainer] native C++ dataplane active")
        elif decodes_items(self.train_ds):
            native.get_decoder()
            preset = preset_for_dataset(cfg.data.dataset, cfg.data.transform)
            host0_print(f"[trainer] native decoder active (item route, "
                        f"transform {preset})")
        d = cfg.data
        shard = dict(host_id=ddp.rank(), num_hosts=world)
        self.train_loader = Loader(
            self.train_ds, d.batch_size, shuffle=True, seed=cfg.run.seed,
            num_workers=d.num_workers, prefetch=d.prefetch,
            batcher=train_batcher, **shard)
        self.val_loader = Loader(
            self.val_ds, d.batch_size, shuffle=False, seed=cfg.run.seed,
            num_workers=d.num_workers, prefetch=d.prefetch,
            batcher=val_batcher, **shard)
        # the eval batch's valid_mask joins it on the stager thread
        self.train_prefetch = DevicePrefetcher(self.train_loader, device,
                                               depth=d.device_prefetch)
        self.val_prefetch = DevicePrefetcher(
            self.val_loader, device, depth=d.device_prefetch,
            assemble=lambda b, hb: (*hb, self.val_loader.valid_mask(b)))
        self.steps_per_epoch = max(len(self.train_loader), 1)
        self.state = create_train_state(cfg, device, self.steps_per_epoch,
                                        group=ddp.group())
        self.train_step = make_train_step(cfg)
        self.eval_step = (make_nested_eval_step(cfg)
                          if cfg.model.head == "nested"
                          else make_eval_step(cfg))
        self.records = (RecordWriter(cfg.run.out_dir)
                        if cfg.run.write_records and primary else None)
        self.tb = None
        if cfg.run.tensorboard and primary:
            from ..utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(os.path.join(cfg.run.out_dir, "tb"))
        self.ckpt = CheckpointManager(
            cfg.run.out_dir, save_every_epoch=cfg.run.save_every_epoch,
            best_only=cfg.run.save_best_only, keep=cfg.run.keep_checkpoints)
        self.start_epoch = 0
        if cfg.run.resume:
            self.ckpt.restore(self.state, cfg.run.resume)
            # meta lives beside the checkpoint resumed (maybe another run's)
            meta = CheckpointManager.meta_for_checkpoint(cfg.run.resume)
            self.start_epoch = int(meta.get("last_epoch", -1)) + 1
            self.ckpt.best_metric = meta.get("best_metric", float("-inf"))
            host0_print(f"resumed from {cfg.run.resume} at epoch "
                        f"{self.start_epoch}")
        elif cfg.run.auto_resume:
            # rank 0 scans first (it quarantines a corrupt file); the
            # others then find what it found
            if not primary:
                ddp.barrier()
            self.state, self.start_epoch = self.ckpt.restore_latest(self.state)
            if primary:
                ddp.barrier()
            if not ddp.agree(self.start_epoch):
                raise RuntimeError("ranks auto-resumed at different epochs")
            if self.start_epoch:
                host0_print(f"auto-resumed from {cfg.run.out_dir} at epoch "
                            f"{self.start_epoch}")
        if self.start_epoch and self.records is not None:
            # keep the curve before the stop: the resumed run appends
            self.records.resume_at(self.start_epoch)
        if ddp.initialized():  # after the restore: every rank starts equal
            self.state.ddp = ddp.wrap(self.state.model, device)
        if self.records is not None and self.native_dataplane:
            self.records.append_txt("# native C++ dataplane active")
        host0_print(
            f"[trainer] workload={cfg.workload} arch={cfg.model.arch} "
            f"params={param_count(self.state):,} device={device} "
            f"world={world} ddp={ddp.backend()} "
            f"global_batch={d.batch_size * world} "
            f"dtype={cfg.model.dtype} flash={cfg.model.flash_attention} "
            f"steps/epoch={self.steps_per_epoch}")

    def train_epoch(self, epoch: int,
                    eta: Optional[EtaLogger] = None) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        sums, n_batches = None, 0
        it = iter(self.train_prefetch)
        try:
            for step, (images, labels) in enumerate(it):
                metrics = self.train_step(self.state, images, labels)
                n_batches += 1
                sums = _sum_into(sums, metrics)
                self.sentinel.observe(metrics["step_ok"])
                if step % self.cfg.run.log_every == 0:
                    if eta is not None:
                        eta.maybe_log(epoch, step, **{
                            k: float(v) for k, v in metrics.items()})
                    self.sentinel.flush()  # raises SentinelDiverged (rc 8)
        finally:
            it.close()  # stop and join the stager on an exception
        self.sentinel.flush()
        if sums is None:
            return {"loss": 0.0, "top1": 0.0, "top3": 0.0,
                    "step_ok": 1.0, "grad_norm": 0.0}
        return {k: float(v) / n_batches for k, v in sums.items()}

    def evaluate(self) -> Dict[str, float]:
        it = iter(self.val_prefetch)
        try:
            if self.cfg.model.head == "nested":
                return nested_eval(self.state, self.eval_step, it)
            totals = eval_totals(self.state, self.eval_step, it)
        finally:
            it.close()
        n = max(totals["n"], 1.0)
        return {"val_loss": totals["loss_sum"] / n,
                "val_top1": totals["top1"] / n,
                "val_top3": totals["top3"] / n}

    def run(self) -> Dict[str, float]:
        cfg = self.cfg
        eta = EtaLogger(self.steps_per_epoch, cfg.run.epochs, cfg.run.log_every)
        last: Dict[str, float] = {}
        try:
            if cfg.run.eval_first and self.start_epoch == 0:
                host0_print("[initial eval] " + " ".join(
                    f"{k}={v:.4f}" for k, v in self.evaluate().items()))
            for epoch in range(self.start_epoch, cfg.run.epochs):
                t0 = time.time()
                train_m = self.train_epoch(epoch, eta)
                val_m = (self.evaluate()
                         if (epoch + 1) % cfg.run.eval_every == 0 else {})
                last = {**train_m, **val_m, "epoch_time": time.time() - t0}
                host0_print(f"[epoch {epoch}] " + " ".join(
                    f"{k}={v:.4f}" for k, v in last.items()))
                if self.records is not None:
                    self.records.log_epoch(epoch, **last)
                if self.tb is not None:
                    for k, v in last.items():
                        group = "val" if k.startswith("val_") else "train"
                        self.tb.add_scalar(f"{group}/{k}", v, epoch)
                    self.tb.flush()
                self.ckpt.save(self.state, epoch, metric=val_m.get("val_top1"))
        finally:
            if self.tb is not None:
                self.tb.close()
            self.train_loader.close()
            self.val_loader.close()
        return last
