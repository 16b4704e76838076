"""The trainer — the port of the JAX package's `train/loop.py::Trainer`, one
process per device: datasets → this rank's loaders (worker threads, the
native dataplane on image folders) → device prefetch → state (wrapped
once in DistributedDataParallel under a process group, parallel/ddp.py)
→ steps → `train_epoch` / `evaluate` (sums reduced across the ranks) →
records, tensorboard scalars and verified checkpoints of the whole train
state, written by rank 0, which `--resume` and `--auto_resume` pick up on
every rank. Trains the ResNets and VGG19-BN (over any number of ranks,
with global batch statistics), TResNet-M (one rank) and the ViT family,
each under the heads fc, arcface and nested (CDR's gradient transform
too), on synthetic data, image folders and CIFAR pickles; `cli/serve.py
--ckpt` serves their checkpoints. The nested head's eval is the all-K sweep
(`nested_eval`: `val_top1` at the best K, `val_top3` there, `best_k`).

Image folders of the `cdr` and `cifar` kinds, and PLC's annotation
datasets, take the item route (`data/native.py::decode_image` and the
numpy `Transform` on the loader's threads), the JAX package's PIL route.
The PLC workload's trainer is `train/plc_loop.py::PLCTrainer`.

The run-control spine is the JAX trainer's (`loop.py:161-212,287-298,
321-353,421-444,550-560` there): the hang watchdog
(`utils/backend_probe.py::StepHeartbeat`, armed first, touched at the log
cadence, at the epoch end and after each sync point, stopped on every way
out), the fault plan (`utils/chaos.py`, inert without a spec), and over
more than one rank (or on an elastic pod) the fleet
(`parallel/fleet.py`): SIGTERM deferred to the epoch boundary, a
divergence noted as abort intent instead of raised mid-epoch, the lease
refreshed at the log cadence, one abort exchange after each epoch's
steps (before eval and save: every rank leaves with the same rc), and
`--auto_resume` as the resume consensus.

`--profile_steps N` captures a torch.profiler trace (CPU and CUDA
activities) of steps `[min(10, spe − N), +N)` of epoch 0 on rank 0 (JAX
`loop.py:364-392`): each step inside a `bench_step#<n>` range, the step's
own `fwd` / `bwd` / `optimizer` ranges opened while the profiler is
active; the window closes after the last profiled step's synchronize, at
the end of epoch 0 at the latest, and in `run`'s `finally` on every
exit that runs it (rc 8 and a pod's `PodAbort`, 143 included; the hang
watchdog's rc 7 is an `os._exit`, which runs none); the capture is
written to `<out>/profile/<host>.trace.json.gz` (or `--profile_dir`),
which `obs/trace.py::breakdown_from_torch_trace` reads.

Not ported yet (ROADMAP.md): async checkpoints, `h2d_overlap` and the
compile sentinel.
"""

from __future__ import annotations

import contextlib
import os
import socket
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
from ..obs.trace import STEP_MARKER
from ..parallel import ddp
from ..parallel import fleet as fleetlib
from ..utils import chaos as chaoslib
from ..utils.backend_probe import StepHeartbeat
from ..utils.logging import EtaLogger, RecordWriter, host0_print
from ..ops.nested import best_k
from .checkpoint import CheckpointManager
from .sentinel import SentinelDiverged, StepSentinel
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
        # the hang watchdog (inert at hang_timeout_s 0), armed FIRST: the
        # construction below already does device work (the kernels' first
        # build, the state's placement, the restore)
        self._heartbeat = StepHeartbeat(
            cfg.run.hang_timeout_s, where=f"trainer[{cfg.workload}]").start()
        try:
            self._build(cfg, device, train_ds, val_ds)
        except BaseException:
            self._heartbeat.stop()
            raise

    def _build(self, cfg: Config, device: torch.device, train_ds: Any,
               val_ds: Any) -> None:
        device = ddp.local_device(device)
        self.cfg, self.device = cfg, device
        world, primary = ddp.world_size(), ddp.is_primary()
        # a malformed spec is a ValueError here: rc 2 at the CLI. The
        # one-shot markers live under <out>/chaos; the rank feeds the
        # CHAOS_HOST gate
        self.chaos = chaoslib.plan_for_run(cfg.run.fault_spec, cfg.run.out_dir)
        if self.chaos:
            host0_print(f"[chaos] fault plan active: {self.chaos}")
        check_world(cfg, world)
        self.obs = Registry()
        # the pod's epoch-boundary exchange and SIGTERM deferral over more
        # than one rank; an elastic pod keeps the coordinator at world 1,
        # to refresh its lease and see a recovered peer's fresh one
        elastic = fleetlib.elastic_enabled() and bool(cfg.run.out_dir)
        self.fleet = (fleetlib.FleetCoordinator(
            out_dir=cfg.run.out_dir if elastic else "", registry=self.obs)
            if world > 1 or elastic else None)
        if self.fleet is not None and world > 1:
            self._defer_sigterm_to_epoch_boundary()
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
            batcher=train_batcher, chaos=self.chaos or None, **shard)
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
        self.train_step = make_train_step(cfg, chaos=self.chaos or None)
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
            best_only=cfg.run.save_best_only, keep=cfg.run.keep_checkpoints,
            chaos=self.chaos or None)
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
            # the resume consensus: rank 0 alone scans, verifies and
            # quarantines, every rank restores the file it names and the
            # ranks prove it with a digest all-gather (PodInconsistent,
            # rc 9); one rank takes the plain restore_latest
            self.state, self.start_epoch = fleetlib.consensus_restore_latest(
                self.ckpt, self.state)
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
        # the global step counter, the chaos step hooks' coordinate
        self._host_step = self.state.step
        self._setup_profiler()
        host0_print(
            f"[trainer] workload={cfg.workload} arch={cfg.model.arch} "
            f"params={param_count(self.state):,} device={device} "
            f"world={world} ddp={ddp.backend()} "
            f"global_batch={d.batch_size * world} "
            f"dtype={cfg.model.dtype} flash={cfg.model.flash_attention} "
            f"steps/epoch={self.steps_per_epoch}")

    # ---------------------------------------------------------------- fleet --
    def _defer_sigterm_to_epoch_boundary(self) -> None:
        """Over several ranks a SIGTERM becomes abort intent instead of
        killing this rank mid-collective (which would leave its peers
        waiting in an all-reduce for good); the epoch-boundary exchange
        turns it into rc 143 on every rank. Installed from the main
        thread only (signals need it); one rank keeps the default
        die-now."""
        import signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return

        def on_sigterm(signum, frame):
            self.fleet.note_abort(143, "SIGTERM received (preemption)")

        signal.signal(signal.SIGTERM, on_sigterm)

    def _sentinel_flush(self) -> None:
        """`sentinel.flush`, pod-aware: without a fleet it raises to the
        CLI (rc 8); on a pod the divergence becomes abort intent and this
        rank keeps issuing the epoch's remaining step collectives (its
        updates are skipped while non-finite); the intent surfaces as
        rc 8 on every rank at the epoch-boundary exchange."""
        try:
            self.sentinel.flush()
        except SentinelDiverged as e:
            if self.fleet is None:
                raise
            self.fleet.note_abort(SentinelDiverged.exit_code, str(e))

    def _chaos_step_hooks(self) -> None:
        """The host-side step faults at this step's global index."""
        self._host_step += 1
        step = self._host_step - 1
        self.chaos.maybe_sigterm(step=step)
        self.chaos.maybe_peer_dead(step=step)
        self.chaos.maybe_peer_slow(step=step)
        self.chaos.maybe_host_lost(step=step)

    # -------------------------------------------------------------- profile --
    def _setup_profiler(self) -> None:
        """Resolve the profiler window once (JAX `_setup_profiler`); rank
        0 captures."""
        cfg = self.cfg
        self._prof_steps = cfg.run.profile_steps if ddp.is_primary() else 0
        self._prof_dir = (cfg.run.profile_dir
                          or os.path.join(cfg.run.out_dir, "profile"))
        self._prof = None
        # skip a few warmup steps when the epoch affords it
        self._prof_start_step = min(
            10, max(self.steps_per_epoch - self._prof_steps, 0))

    @property
    def _prof_active(self) -> bool:
        return self._prof is not None

    def _maybe_profile_start(self, epoch: int, step: int) -> None:
        if (self._prof_steps and epoch == 0 and self._prof is None
                and step == self._prof_start_step):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()

    def _step_range(self):
        """The step's `bench_step#<n>` range while capturing."""
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(
            f"{STEP_MARKER}#{self.state.step}")

    def _maybe_profile_stop(self, step: int) -> None:
        if self._prof is None:
            return
        done = step - self._prof_start_step + 1 >= self._prof_steps
        if done or step == self.steps_per_epoch - 1:  # never past epoch 0
            self._close_profiler()

    def _close_profiler(self) -> None:
        """Synchronize, stop the capture and write it."""
        prof, self._prof, self._prof_steps = self._prof, None, 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        os.makedirs(self._prof_dir, exist_ok=True)
        path = os.path.join(self._prof_dir,
                            f"{socket.gethostname()}.trace.json.gz")
        prof.export_chrome_trace(path)
        host0_print(f"[trainer] profiler trace captured → {path}")

    # ---------------------------------------------------------------- train --
    def train_epoch(self, epoch: int,
                    eta: Optional[EtaLogger] = None) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        sums, n_batches = None, 0
        it = iter(self.train_prefetch)
        try:
            for step, (images, labels) in enumerate(it):
                self._maybe_profile_start(epoch, step)
                with self._step_range():
                    metrics = self.train_step(self.state, images, labels)
                self._maybe_profile_stop(step)
                n_batches += 1
                sums = _sum_into(sums, metrics)
                self.sentinel.observe(metrics["step_ok"])
                if self.chaos:
                    self._chaos_step_hooks()
                if step % self.cfg.run.log_every == 0:
                    if eta is not None:
                        eta.maybe_log(epoch, step, **{
                            k: float(v) for k, v in metrics.items()})
                    # raises SentinelDiverged (rc 8); on a pod, abort intent
                    self._sentinel_flush()
                    self._heartbeat.touch()
                    if self.fleet is not None:
                        # a live rank never looks dead to a lease scan
                        self.fleet.refresh_lease()
        finally:
            it.close()  # stop and join the stager on an exception
        self._sentinel_flush()
        if sums is None:
            return {"loss": 0.0, "top1": 0.0, "top3": 0.0,
                    "step_ok": 1.0, "grad_norm": 0.0}
        out = {k: float(v) / n_batches for k, v in sums.items()}
        self._heartbeat.touch()
        return out

    def evaluate(self) -> Dict[str, float]:
        it = iter(self.val_prefetch)
        try:
            if self.cfg.model.head == "nested":
                out = nested_eval(self.state, self.eval_step, it)
                self._heartbeat.touch()
                return out
            totals = eval_totals(self.state, self.eval_step, it)
        finally:
            it.close()
        self._heartbeat.touch()  # its one host read proves progress
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
                if self.fleet is not None:
                    # the epoch-boundary exchange, before eval and save: a
                    # stopped or diverged epoch is neither evaluated nor
                    # checkpointed, and every rank raises the same rc
                    self.fleet.check()
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
            self._teardown()
        return last

    def _teardown(self) -> None:
        """`run`'s way out, whatever it is: the watchdog stopped, a capture
        cut short closed and written, tensorboard flushed, the loaders'
        threads stopped."""
        self._heartbeat.stop()
        if self._prof is not None:
            try:
                self._close_profiler()
            except Exception:  # must not mask the original exception
                pass
        if self.tb is not None:
            self.tb.close()
        self.train_loader.close()
        self.val_loader.close()
