"""PLC's progressive-label-correction trainer — the port of the JAX
package's `train/plc_loop.py`.

The reference ships the Clothing1M dataset (PLC/FolderDataset.py) and the
correction algorithms (PLC/utils.py:291-360) but no training entry point
(SURVEY §1). `PLCTrainer` is the JAX package's completion of it, a
`Trainer` whose epoch loop

1. trains normally for `plc.warmup_epochs`;
2. then, each epoch, runs an ordered forward over the train set (the
   train images through the eval transform, `make_predict_step` a batch,
   on the device prefetcher; under a process group each rank takes its
   contiguous slice and `all_gather_into_tensor` stitches the slices back
   in dataset order, so every rank holds the same (N, C) logits);
3. applies LRT or probabilistic correction to the labels
   (`ops/labelnoise.py`), carrying δ across epochs, capped by
   `plc.max_flip_frac`; every rank computes the same correction;
4. writes the corrected labels back into the dataset
   (`update_corrupted_label`, PLC/FolderDataset.py:80-82) so the next
   epoch trains on them, and, after each checkpoint, rank 0 writes δ into
   `meta.json` and the labels to `plc_labels.npy`, which `--resume` and
   `--auto_resume` restore.

Synthetic-noise injection (`plc.noise_type >= 0`, with the `eta` matrix
the caller passes) reproduces the reference's experiment setup
(utils.py:149-220).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..data.device_prefetch import DevicePrefetcher
from ..data.loader import Loader
from ..data.transforms import build_transform, preset_for_dataset
from ..ops.labelnoise import (cap_flips, label_noise, lrt_correction,
                              prob_correction)
from ..parallel import ddp
from ..utils.logging import EtaLogger, host0_print
from .checkpoint import CheckpointManager
from .loop import Trainer, make_native_batcher
from .steps import make_predict_step


def _dataset_labels(ds) -> np.ndarray:
    return np.asarray(ds.labels)


def _set_dataset_labels(ds, new_labels: np.ndarray) -> None:
    if hasattr(ds, "update_corrupted_label"):
        ds.update_corrupted_label(new_labels)  # PLC/FolderDataset.py:80-82
    else:
        ds.labels = np.asarray(new_labels, np.int32)


class PLCTrainer(Trainer):
    """Trainer + per-epoch label correction. `eta` (N, C) is the class
    posterior that synthetic noise injection draws from."""

    def __init__(self, cfg: Config, device: torch.device, train_ds: Any = None,
                 val_ds: Any = None, eta: Optional[np.ndarray] = None):
        self._eta = eta
        super().__init__(cfg, device, train_ds, val_ds)

    def _build(self, cfg: Config, device: torch.device, train_ds: Any,
               val_ds: Any) -> None:
        super()._build(cfg, device, train_ds, val_ds)
        eta = self._eta
        self.predict_step = make_predict_step(
            cfg, batch_stat_mode=cfg.plc.batch_stat_predictions)
        self.delta = cfg.plc.current_delta
        self.corrections_per_epoch: list = []
        self.injected = 0  # labels the noise injection changed
        self._predict_ds = None
        resume_dir = ""
        if cfg.run.resume:
            resume_dir = os.path.dirname(os.path.abspath(cfg.run.resume))
        elif cfg.run.auto_resume and self.start_epoch:
            resume_dir = cfg.run.out_dir  # Trainer already restored the state
        if resume_dir:
            # the corrected labels and the carried δ are train state too:
            # without them a resumed run reverts to the noisy labels
            meta = CheckpointManager.read_meta_at(
                os.path.join(resume_dir, "meta.json"))
            self.delta = float(meta.get("plc_delta", self.delta))
            labels_path = os.path.join(resume_dir, "plc_labels.npy")
            if os.path.exists(labels_path):
                _set_dataset_labels(self.train_ds, np.load(labels_path))
                host0_print(f"[plc] restored corrected labels from {labels_path}")
                # the restored labels hold the injection and every
                # correction since: injecting again would overwrite them
                return
        if cfg.plc.noise_type >= 0:
            if eta is None:
                raise ValueError("synthetic noise injection requires an eta matrix")
            labels = _dataset_labels(self.train_ds)
            noisy, _, count = label_noise(
                labels, eta, cfg.plc.noise_type, cfg.plc.noise_factor,
                rng=np.random.default_rng(cfg.run.seed))
            _set_dataset_labels(self.train_ds, noisy)
            self.injected = count
            host0_print(f"[plc] injected type-{cfg.plc.noise_type} noise: "
                        f"{count}/{len(labels)} labels corrupted")

    # ---------------------------------------------------------------- infer --
    def _predict_pipeline(self):
        """(dataset, batcher) of the ordered f(x) pass: the train images
        through the eval transform (a shallow copy of the dataset with the
        transform swapped; its labels are never read), on the wire the
        train step takes. Image folders of the dataplane's kinds keep the
        dataplane, in eval mode."""
        if self._predict_ds is not None:
            return self._predict_ds, self._predict_batcher
        d = self.cfg.data
        preset = preset_for_dataset(d.dataset, d.transform)
        ds = self.train_ds
        if preset is not None and hasattr(ds, "transform"):
            ds = copy.copy(ds)
            ds.transform = build_transform(preset, False, d.image_size,
                                           d.train_crop_size, d.input_dtype)
        self._predict_ds = ds
        self._predict_batcher = make_native_batcher(ds, self.cfg, train=False)
        return self._predict_ds, self._predict_batcher

    def predict_train_logits(self) -> np.ndarray:
        """The (N, C) logits of the train set in dataset order, on every
        rank. Each rank runs its contiguous slice of the set (padded by
        wrapping to whole global batches, `shard_indices_for_host` without
        a shuffle) through the predict step; the slices are gathered in
        rank order, which is dataset order, and the padding dropped."""
        n = len(self.train_ds)
        d = self.cfg.data
        ds, batcher = self._predict_pipeline()
        loader = Loader(ds, d.batch_size, shuffle=False, seed=self.cfg.run.seed,
                        num_workers=d.num_workers, prefetch=d.prefetch,
                        batcher=batcher, host_id=ddp.rank(),
                        num_hosts=ddp.world_size())
        # the images only: the labels are not this pass's
        prefetch = DevicePrefetcher(loader, self.device, depth=d.device_prefetch,
                                    assemble=lambda i, hb: (hb[0],))
        chunks = []
        it = iter(prefetch)
        try:
            for (images,) in it:
                chunks.append(self.predict_step(self.state, images))
        finally:
            it.close()  # stop and join the stager on an exception
            loader.close()
        local = torch.cat(chunks)
        if ddp.world_size() > 1:
            full = local.new_empty((ddp.world_size() * local.shape[0],
                                    local.shape[1]))
            dist.all_gather_into_tensor(full, local.contiguous())
            local = full
        return local[:n].cpu().numpy()

    # ------------------------------------------------------------- correct --
    def correct_labels(self) -> int:
        """One correction pass; returns the number of changed labels."""
        f_x = self.predict_train_logits()
        y = _dataset_labels(self.train_ds)
        cap_on = self.cfg.plc.max_flip_frac < 1.0
        p = None
        if self.cfg.plc.correction == "lrt" or cap_on:
            # LRT and the cap's ranking read probabilities
            # (utils.py:305-309); no (N, C) softmax when neither does
            z = f_x - f_x.max(axis=1, keepdims=True)
            p = np.exp(z)
            p /= p.sum(axis=1, keepdims=True)
        if self.cfg.plc.correction == "lrt":
            new_y, self.delta = lrt_correction(
                y, p, self.delta, self.cfg.plc.delta_increment)
        elif self.cfg.plc.correction == "prob":
            new_y, self.delta = prob_correction(
                y, f_x, np.random.default_rng(self.cfg.run.seed),
                self.delta, self.cfg.plc.delta_increment, self.cfg.plc.thd)
        else:
            raise ValueError(f"unknown correction {self.cfg.plc.correction!r}")
        changed = int((np.asarray(new_y) != y).sum())
        if cap_on:
            proposed = changed
            new_y = cap_flips(y, new_y, p, self.cfg.plc.max_flip_frac)
            changed = int((new_y != y).sum())
            if changed < proposed:
                host0_print(f"[plc] capped correction: {proposed} proposed "
                            f"-> {changed} applied (max_flip_frac="
                            f"{self.cfg.plc.max_flip_frac})")
        _set_dataset_labels(self.train_ds, new_y)
        return changed

    # ------------------------------------------------------------------ run --
    def run(self) -> Dict[str, float]:
        cfg = self.cfg
        eta = EtaLogger(self.steps_per_epoch, cfg.run.epochs, cfg.run.log_every)
        last: Dict[str, float] = {}
        labels_path = os.path.join(cfg.run.out_dir, "plc_labels.npy")
        done = False
        try:
            for epoch in range(self.start_epoch, cfg.run.epochs):
                t0 = time.time()
                train_m = self.train_epoch(epoch, eta)
                if self.fleet is not None:
                    # the epoch-boundary exchange (Trainer.run), before the
                    # correction pass, which holds collectives of its own
                    self.fleet.check()
                changed = 0
                if epoch + 1 > cfg.plc.warmup_epochs:
                    changed = self.correct_labels()
                    self.corrections_per_epoch.append(changed)
                    self._heartbeat.touch()  # the pass ended in a host read
                val_m = (self.evaluate()
                         if (epoch + 1) % cfg.run.eval_every == 0 else {})
                last = {**train_m, **val_m, "corrected": float(changed),
                        "delta": float(self.delta),
                        "epoch_time": time.time() - t0}
                host0_print(f"[plc epoch {epoch}] " + " ".join(
                    f"{k}={v:.4f}" for k, v in last.items()))
                if self.records is not None:
                    self.records.log_epoch(epoch, **last)
                if self.tb is not None:
                    for k, v in last.items():
                        group = "val" if k.startswith("val_") else (
                            "plc" if k in ("corrected", "delta") else "train")
                        self.tb.add_scalar(f"{group}/{k}", v, epoch)
                    self.tb.flush()
                self.ckpt.save(self.state, epoch, metric=val_m.get("val_top1"))
                if ddp.is_primary():
                    # the correction state beside the checkpoints, once the
                    # epoch's write has landed: one writer of meta.json,
                    # and meta never ahead of the files
                    self.ckpt.wait()
                    self.ckpt._write_meta(plc_delta=float(self.delta))
                    np.save(labels_path, _dataset_labels(self.train_ds))
                ddp.barrier()  # no rank reads a stale copy
            done = True
        finally:
            self._teardown(done)
        return last
