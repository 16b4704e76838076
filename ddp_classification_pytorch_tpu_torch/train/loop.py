"""The trainer — the port of the JAX package's `train/loop.py::Trainer` for
one process on one device: datasets → loaders → state → steps →
`train_epoch` / `evaluate` → records → a verified checkpoint per epoch.
Trains TResNet-M (whose checkpoints `cli/serve.py --ckpt` serves) and the
ViT family, on synthetic data.

Not ported yet (ROADMAP.md): image-folder, CIFAR and PLC data and the
native dataplane, device-side prefetch, `--resume`/`--auto_resume`,
best-only checkpoints, tensorboard, the profiler window, the pod fleet,
chaos hooks and the compile sentinel.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import Config
from ..data.loader import Loader
from ..data.synthetic import SyntheticDataset
from ..obs.registry import Registry
from ..utils.logging import EtaLogger, RecordWriter, host0_print
from . import checkpoint
from .sentinel import StepSentinel
from .state import create_train_state, param_count
from .steps import make_eval_step, make_train_step

INPUT_DTYPES = ("uint8", "float32")


def build_datasets(cfg: Config) -> Tuple[Any, Any]:
    """(train_ds, val_ds): the synthetic sets the JAX package builds
    (`loop.py:102-109`); other datasets are not ported yet."""
    d = cfg.data
    if d.input_dtype not in INPUT_DTYPES:
        raise ValueError(
            f"unknown data.input_dtype {d.input_dtype!r}; one of {INPUT_DTYPES}")
    if d.dataset != "synthetic":
        raise ValueError(f"dataset {d.dataset!r} not yet ported to the torch "
                         "package (ported: synthetic; ROADMAP.md)")
    size = d.synthetic_size or 512
    train = SyntheticDataset(size, d.image_size, d.num_classes,
                             seed=cfg.run.seed, out_dtype=d.input_dtype)
    val = SyntheticDataset(max(size // 4, d.batch_size), d.image_size,
                           d.num_classes, seed=cfg.run.seed, item_offset=size,
                           out_dtype=d.input_dtype)
    return train, val


def _sum_into(totals: Optional[Dict[str, torch.Tensor]],
              out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device-side running sums (one host read at the end)."""
    if totals is None:
        return {k: v.detach().clone() for k, v in out.items()}
    for k, v in out.items():
        totals[k] += v
    return totals


class Trainer:
    def __init__(self, cfg: Config, device: torch.device):
        self.cfg, self.device = cfg, device
        self.obs = Registry()
        self.sentinel = StepSentinel(cfg.run.max_bad_steps, registry=self.obs)
        self.train_ds, self.val_ds = build_datasets(cfg)
        self.train_loader = Loader(self.train_ds, cfg.data.batch_size,
                                   shuffle=True, seed=cfg.run.seed)
        self.val_loader = Loader(self.val_ds, cfg.data.batch_size,
                                 shuffle=False, seed=cfg.run.seed)
        self.steps_per_epoch = max(len(self.train_loader), 1)
        self.state = create_train_state(cfg, device, self.steps_per_epoch)
        self.train_step = make_train_step(cfg)
        self.eval_step = make_eval_step(cfg)
        self.records = (RecordWriter(cfg.run.out_dir)
                        if cfg.run.write_records else None)
        self.best_metric = float("-inf")
        self.best_epoch = -1
        host0_print(
            f"[trainer] workload={cfg.workload} arch={cfg.model.arch} "
            f"params={param_count(self.state):,} device={device} "
            f"dtype={cfg.model.dtype} flash={cfg.model.flash_attention} "
            f"steps/epoch={self.steps_per_epoch}")

    def _to_device(self, *arrays) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(a).to(self.device, non_blocking=True)
                     for a in arrays)

    def train_epoch(self, epoch: int,
                    eta: Optional[EtaLogger] = None) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        sums, n_batches = None, 0
        for step, batch in enumerate(self.train_loader):
            metrics = self.train_step(self.state, *self._to_device(*batch))
            n_batches += 1
            sums = _sum_into(sums, metrics)
            self.sentinel.observe(metrics["step_ok"])
            if step % self.cfg.run.log_every == 0:
                if eta is not None:
                    eta.maybe_log(epoch, step,
                                  **{k: float(v) for k, v in metrics.items()})
                self.sentinel.flush()  # raises SentinelDiverged (rc 8)
        self.sentinel.flush()
        if sums is None:
            return {"loss": 0.0, "top1": 0.0, "top3": 0.0,
                    "step_ok": 1.0, "grad_norm": 0.0}
        return {k: float(v) / n_batches for k, v in sums.items()}

    def evaluate(self) -> Dict[str, float]:
        totals = None
        for b, (images, labels) in enumerate(self.val_loader):
            valid = self.val_loader.valid_mask(b)
            out = self.eval_step(self.state,
                                 *self._to_device(images, labels, valid))
            totals = _sum_into(totals, out)
        if totals is None:
            return {"val_loss": 0.0, "val_top1": 0.0, "val_top3": 0.0}
        totals = {k: float(v) for k, v in totals.items()}
        n = max(totals["n"], 1.0)
        return {"val_loss": totals["loss_sum"] / n,
                "val_top1": totals["top1"] / n,
                "val_top3": totals["top3"] / n}

    def save(self, epoch: int, metric: Optional[float]) -> str:
        """`ckpt_e{epoch}.pt` with its sha256 sidecar, then `meta.json`."""
        out = self.cfg.run.out_dir
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"ckpt_e{epoch}.pt")
        checkpoint.save(self.state.model.state_dict(), path)
        if metric is not None and metric > self.best_metric:
            self.best_metric, self.best_epoch = metric, epoch
        meta = {"last_epoch": epoch, "best_metric": self.best_metric,
                "best_epoch": self.best_epoch, "step": self.state.step}
        tmp = os.path.join(out, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, os.path.join(out, "meta.json"))
        return path

    def run(self) -> Dict[str, float]:
        cfg = self.cfg
        eta = EtaLogger(self.steps_per_epoch, cfg.run.epochs, cfg.run.log_every)
        last: Dict[str, float] = {}
        if cfg.run.eval_first:
            host0_print("[initial eval] " + " ".join(
                f"{k}={v:.4f}" for k, v in self.evaluate().items()))
        for epoch in range(cfg.run.epochs):
            t0 = time.time()
            train_m = self.train_epoch(epoch, eta)
            val_m = (self.evaluate() if (epoch + 1) % cfg.run.eval_every == 0
                     else {})
            last = {**train_m, **val_m, "epoch_time": time.time() - t0}
            host0_print(f"[epoch {epoch}] " + " ".join(
                f"{k}={v:.4f}" for k, v in last.items()))
            if self.records is not None:
                self.records.log_epoch(epoch, **last)
            if cfg.run.save_every_epoch:
                self.save(epoch, val_m.get("val_top1"))
        return last
