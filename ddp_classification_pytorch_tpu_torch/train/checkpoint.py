"""Verified checkpoints of the port: `torch.save`d files with a sha256
sidecar, and the `CheckpointManager` the trainer saves and resumes
through — the JAX package's `train/checkpoint.py` for one process
(`checkpoint.py:44-72,162-525` there), as `.pt` files.

- `save` writes the bytes to a temp file and `os.replace`s it into place
  (no torn file on preemption), then writes `<path>.sha256` the same way,
  strictly after the file: a crash in between leaves a file without a
  sidecar, never a sidecar vouching for unwritten bytes.
- `restore` verifies the sidecar before it loads. A missing sidecar or a
  digest mismatch is a `ValueError` (rc 2 in the CLIs: deterministic, a
  supervisor must not retry it).
- A trainer's file holds the whole train state (`TrainState.state_dict()`:
  the model, the optimizer's momentum, `step`, `opt_count`); `model_state`
  takes the model's part, which is what `cli/serve.py --ckpt` serves (it
  also serves a file of bare weights). The model's part is the unwrapped
  module's, with no DistributedDataParallel `module.` prefix.
- Under a process group the state is replicated: rank 0 writes the files
  and `meta.json` while the other ranks wait at a barrier, and every rank
  restores. A file written by a run of one world size resumes in a run
  of another. Under ZeRO-1 every rank first gathers the optimizer state
  on rank 0 (`TrainState.consolidate`, a collective), so the file holds
  the plain optimizer's full state and resumes with ZeRO-1 or without,
  at any world size, and under `cli/serve.py` (JAX
  `checkpoint.py:526-559`). Over a model axis the class shards, and over
  GPipe stages every stage's blocks, are gathered the same way before
  rank 0 writes (and before the async writer's host copy), so the file
  holds the one-rank model, which resumes at any (dp, mp, pp).
- Async writes (`async_save`, `run.async_checkpoint`, JAX
  `checkpoint.py:169-183,255-334`): the host copy of the state is taken
  synchronously — a real copy, since SGD updates the live tensors in
  place — then the serialization, the writes, the sidecars, `publish`,
  `meta.json` and the pruning run on one background thread in that
  order, one write in flight. `wait()` joins it and re-raises its
  failure once, as "async checkpoint write failed". The trainer waits
  before the next save, before a restore reads the directory and on
  every way out of `run`; the barrier after `save` no longer means the
  file is on disk. A process killed mid-write (the hang watchdog's
  `os._exit(7)`) leaves a `*.tmp`, or a file without its sidecar, never
  a torn file that verifies.
- The event plane (`obs/events.py`, armed by `SCENARIO_EVENTS`): a
  verified epoch file emits `publish` (epoch, path, digest, world_size)
  once its sidecar has landed, and every quarantine emits `quarantine`
  (path, reason), as the JAX manager does — so a serve replica's watcher
  (`serve/reload.py`) and the trainer write one `events.jsonl`.
- `CheckpointManager.verified_candidates` is the hot-reload scan: epoch
  files newest first, each verified and loaded (a failure quarantined and
  the next newest tried), with the verified sidecar's digest.
- Over several ranks `--auto_resume` is the fleet's consensus
  (`parallel/fleet.py::consensus_restore_latest`): rank 0 alone scans
  (`restore_latest_with_provenance`, quarantining what fails), the others
  restore exactly the file it names (`restore_exact`, which never
  quarantines). A file without its sidecar is never picked: the JAX
  manager accepts it as "legacy", the port quarantines it (ROADMAP.md §3).
- Fault injection (`utils/chaos.py`): `ckpt_io` and `publish_corrupt`
  tear the landed file to half its bytes AFTER its sha256 was computed,
  so the sidecar no longer vouches for it; a torn publish emits
  `publish_torn` (JAX `checkpoint.py:170-178,278-296`).

`load_jax_checkpoint` reads a checkpoint the JAX package's trainer wrote
(`ckpt_eN.msgpack`: flax's `to_bytes` of its TrainState) with the port's
own msgpack reader (`train/flax_msgpack.py`: the card's machine has no
`msgpack`) and maps its `params` and `batch_stats` through
`models/convert.py` into the served model's `state_dict`: what
`cli/serve.py --ckpt <file>.msgpack` serves. Its `.sha256` sidecar is
verified as the JAX manager verifies it (`checkpoint.py:204-249` there): a
mismatch raises ValueError (rc 2), a missing sidecar is JAX's "legacy"
file and is accepted.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

import torch

from ..obs.events import emit
from ..parallel import ddp
from ..utils.logging import host0_print

_DIGEST = re.compile(r"[0-9a-f]{64}")


def checksum_path(path: str) -> str:
    return path + ".sha256"


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, Mapping):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _host_copy(obj: Any) -> Any:
    """`obj` with every tensor copied to the CPU: a snapshot that nothing
    the step loop does afterwards can change (`_to_cpu` hands back a CPU
    tensor itself)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, Mapping):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def save(obj: Mapping[str, Any], path: str,
         tear: Optional[Callable[[str], Any]] = None) -> str:
    """Atomically write `obj` (a state dict, nested dicts allowed; tensors
    moved to the CPU) and its sidecar; returns the file's sha256. `tear`
    (fault injection) is called with `path` once the bytes have landed
    and their digest is known, before the sidecar is written."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_cpu(obj), tmp)
    digest = _sha256_file(tmp)
    os.replace(tmp, path)
    if tear is not None:
        tear(path)
    sc_tmp = f"{checksum_path(path)}.{os.getpid()}.tmp"
    with open(sc_tmp, "w") as f:
        f.write(digest + "\n")
    os.replace(sc_tmp, checksum_path(path))
    return digest


def verify(path: str) -> Optional[str]:
    """None when `path` matches its sidecar, else why it does not."""
    sidecar = checksum_path(path)
    if not os.path.isfile(path):
        return f"checkpoint {path} does not exist"
    if not os.path.isfile(sidecar):
        return (f"checkpoint {path} has no sha256 sidecar ({sidecar}); "
                "refusing unverified weights")
    with open(sidecar) as f:
        expected = f.read().strip()
    if not _DIGEST.fullmatch(expected):
        return f"checkpoint {path} has a malformed sha256 sidecar"
    actual = _sha256_file(path)
    if actual != expected:
        return (f"checkpoint {path} fails its sha256: file {actual}, "
                f"sidecar {expected}")
    return None


def restore(path: str) -> Dict[str, Any]:
    """Verify `path` against its sidecar, then load it on the CPU (tensors
    and plain values only: `weights_only=True`)."""
    err = verify(path)
    if err is not None:
        raise ValueError(err)
    return torch.load(path, map_location="cpu", weights_only=True)


def file_digest(path: str) -> str:
    """sha256 of a checkpoint's bytes: its sidecar's, when well formed
    (already proven to match by `verify`), else hashed directly."""
    try:
        with open(checksum_path(path)) as f:
            expected = f.read().strip()
        if _DIGEST.fullmatch(expected):
            return expected
    except OSError:
        pass
    return _sha256_file(path)


def load_verified(path: str, mmap: bool = False) -> Optional[Dict[str, Any]]:
    """The file at `path` if it verifies and loads on the CPU, else None,
    with the file quarantined (`*.corrupt`) — the keep-going contract that
    `--auto_resume` and the hot-reload watcher share. `mmap` maps the file
    instead of reading it, so tensors never used (a train state's
    optimizer part, for a server) are never read."""
    if not os.path.exists(path):
        return None  # lost a quarantine race with another process
    err = verify(path)
    if err is not None:
        quarantine_file(path, err)
        return None
    try:
        return torch.load(path, map_location="cpu", weights_only=True,
                          mmap=mmap)
    except (OSError, ValueError, RuntimeError, EOFError) as e:
        quarantine_file(path, f"cannot be restored: {e}")
        return None


def load_jax_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The served model's `state_dict` from a JAX package checkpoint (see
    the module docstring). ValueError for a file that fails its sidecar,
    is not the msgpack flax writes, or holds no ported model."""
    from ..models.convert import from_jax_variables
    from . import flax_msgpack

    if not os.path.isfile(path):
        raise ValueError(f"checkpoint {path} does not exist")
    sidecar = checksum_path(path)
    if os.path.isfile(sidecar):
        with open(sidecar) as f:
            expected = f.read().strip()
        if not _DIGEST.fullmatch(expected) or _sha256_file(path) != expected:
            raise ValueError(
                f"checkpoint {path} does not match its sha256 sidecar "
                f"({sidecar}) — corrupt or torn")
    else:
        host0_print(f"[ckpt] no sha256 sidecar for {path} (pre-checksum "
                    "checkpoint); accepting")
    with open(path, "rb") as f:
        tree = flax_msgpack.unpackb(f.read())
    if not isinstance(tree, dict) or not isinstance(tree.get("params"), dict):
        raise ValueError(f"checkpoint {path} holds no flax `params` tree")
    stats = tree.get("batch_stats")
    return from_jax_variables(tree["params"],
                              stats if isinstance(stats, dict) else {})


def model_state(obj: Mapping[str, Any]) -> Mapping[str, torch.Tensor]:
    """The model's weights in a restored file: the `model` part of a train
    state, or the file itself when it holds bare weights."""
    return obj["model"] if "optimizer" in obj else obj


def quarantine_file(path: str, reason: str, kind: str = "checkpoint") -> None:
    """Rename a corrupt checkpoint (and its sidecar) to `*.corrupt`, so the
    next restart's scan does not fail on it again; kept on disk as
    evidence. `kind` names the artifact in the log line: the serve AOT
    sidecar (serve/aot.py) quarantines its manifest and payloads here."""
    dst = path + ".corrupt"
    try:
        os.replace(path, dst)
    except OSError:
        # another process (a trainer's resume, a replica's watcher) moved
        # it first: the second rename is a no-op, one *.corrupt remains
        return
    emit("quarantine", path=path, reason=reason)
    if os.path.exists(checksum_path(path)):
        os.replace(checksum_path(path), dst + ".sha256")
    host0_print(f"[ckpt] quarantined corrupt {kind} {path} -> {dst} "
                f"({reason})")


class CheckpointManager:
    """Per-epoch and best checkpoints of one run, `meta.json`, pruning and
    resume (the JAX `CheckpointManager`), written synchronously or, with
    `async_save`, on a background thread.

    `ckpt_e{N}.pt` every epoch (unless `best_only`), `ckpt_best.pt` when
    the metric improves (the same bytes), then `meta.json` (`last_epoch`,
    `best_epoch`, `best_metric`) strictly after the bytes; with `keep` > 0
    only the newest `keep` epoch files stay. `chaos` (a
    `utils/chaos.py::FaultPlan`) tears the files of its ckpt_io and
    publish_corrupt epochs."""

    def __init__(self, out_dir: str, save_every_epoch: bool = True,
                 best_only: bool = False, keep: int = 0,
                 chaos: Optional[Any] = None, async_save: bool = False):
        self.out_dir = out_dir
        self._chaos = chaos
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._pending_error: List[Exception] = []
        self.save_every_epoch = save_every_epoch
        self.best_only = best_only
        self.keep = keep
        self.best_metric = float("-inf")
        os.makedirs(out_dir, exist_ok=True)

    def epoch_path(self, epoch: int) -> str:
        return os.path.join(self.out_dir, f"ckpt_e{epoch}.pt")

    @property
    def best_path(self) -> str:
        return os.path.join(self.out_dir, "ckpt_best.pt")

    @property
    def meta_path(self) -> str:
        return os.path.join(self.out_dir, "meta.json")

    # ----------------------------------------------------------------- meta --
    @staticmethod
    def read_meta_at(meta_path: str) -> dict:
        if not os.path.exists(meta_path):
            return {}
        with open(meta_path) as f:
            try:
                return json.load(f)
            except ValueError:  # a torn file: default meta beats no restart
                return {}

    def read_meta(self) -> dict:
        return self.read_meta_at(self.meta_path)

    @staticmethod
    def meta_for_checkpoint(ckpt_path: str) -> dict:
        """Meta of the run that wrote a checkpoint (resuming another run's)."""
        return CheckpointManager.read_meta_at(os.path.join(
            os.path.dirname(os.path.abspath(ckpt_path)), "meta.json"))

    def _write_meta(self, **kw: Any) -> None:
        meta = self.read_meta()
        meta.update(kw)
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, self.meta_path)

    # ----------------------------------------------------------------- save --
    def save(self, state, epoch: int, metric: Optional[float] = None) -> bool:
        """Write this epoch's checkpoints and meta (rank 0; every rank
        calls it and returns after rank 0 has its host copy, or, written
        synchronously, after the files); True on a new best."""
        is_best = metric is not None and metric > self.best_metric
        if metric is not None:
            self.best_metric = max(self.best_metric, metric)
        paths = []
        if self.save_every_epoch and not self.best_only:
            paths.append(self.epoch_path(epoch))
        if is_best:
            paths.append(self.best_path)
        meta: Dict[str, Any] = {"last_epoch": epoch}
        if is_best:
            meta.update(best_epoch=epoch, best_metric=float(metric))
        consolidate = getattr(state, "consolidate", None)
        if paths and consolidate is not None:
            consolidate()  # `paths` is every rank's: a collective, ZeRO-1
        if ddp.is_primary():
            self.wait()  # one write in flight; the last one's failure
            # one host copy for every path, taken before the loop goes on
            sd = (((_host_copy if self.async_save else _to_cpu)(
                state.state_dict())) if paths else None)
            if self.async_save:
                self._pending = threading.Thread(
                    target=self._guarded_write, args=(sd, paths, epoch, meta),
                    name="ckpt-writer", daemon=True)
                self._pending.start()
            else:
                self._write(sd, paths, epoch, meta)
        ddp.barrier()
        return is_best

    def _write(self, sd: Optional[Dict[str, Any]], paths: List[str],
               epoch: int, meta: Dict[str, Any]) -> None:
        """Each path's bytes then its sidecar (`publish` once it has
        landed), then meta, then the pruning: meta never names a file that
        is not on disk yet."""
        for path in paths:
            torn: List[bool] = []
            digest = save(sd, path, tear=None if self._chaos is None
                          else lambda p: torn.append(
                              self._chaos.maybe_corrupt_checkpoint(
                                  p, epoch=epoch)))
            if path != self.best_path:
                # visible to watchers once its sidecar has landed
                emit("publish", epoch=epoch, path=path, digest=digest,
                     world_size=ddp.world_size())
                if any(torn):
                    emit("publish_torn", epoch=epoch, path=path)
        self._write_meta(**meta)
        if paths and self.keep > 0:
            self._prune()

    def _guarded_write(self, *args: Any) -> None:
        try:
            self._write(*args)
        except Exception as e:  # surfaced by the next wait()
            self._pending_error.append(e)

    def wait(self) -> None:
        """Block until the write in flight (if any) has landed; re-raise
        its failure, once: a lost checkpoint must not pass for a saved
        one."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.join()
        if self._pending_error:
            err = self._pending_error[0]
            self._pending_error.clear()
            raise RuntimeError("async checkpoint write failed") from err

    def _epoch_checkpoints(self) -> List[int]:
        if not os.path.isdir(self.out_dir):
            return []
        return [int(m.group(1)) for m in
                (re.fullmatch(r"ckpt_e(\d+)\.pt", n)
                 for n in os.listdir(self.out_dir)) if m]

    def _prune(self) -> None:
        have = sorted(self._epoch_checkpoints())
        for e in have[: max(len(have) - self.keep, 0)]:
            os.remove(self.epoch_path(e))
            if os.path.exists(checksum_path(self.epoch_path(e))):
                os.remove(checksum_path(self.epoch_path(e)))

    # -------------------------------------------------------------- restore --
    def restore(self, state, path: str):
        """Load `path` into `state` (in place; returned). A file that fails
        its sidecar, or is no train state, is a ValueError (rc 2: resuming
        from a named bad file fails the same way every time); falling back
        is `restore_latest`'s."""
        self.wait()
        err = verify(path)
        if err is not None:
            raise ValueError(f"{err} — use --auto_resume to fall back to the "
                             "newest verified checkpoint, or delete the file")
        state.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))
        return state

    def _restore_verified(self, state, path: str) -> bool:
        """Restore `path` if it verifies and loads; quarantine it if not."""
        obj = load_verified(path)
        if obj is None:
            return False
        try:
            state.load_state_dict(obj)
        except (ValueError, RuntimeError, KeyError) as e:
            quarantine_file(path, f"cannot be restored: {e}")
            return False
        return True

    def verified_candidates(self, newer_than: int = -1
                            ) -> Iterator[Tuple[int, str, Optional[Dict],
                                                str]]:
        """The hot-reload scan: (epoch, path, loaded file or None, digest)
        for each `ckpt_e{N}.pt` with N > `newer_than`, newest first. A file
        whose sidecar has not landed yet is not published: it is skipped,
        not quarantined (`save` writes the sidecar strictly after the
        file, so a poll can fall between the two; the next poll sees it).
        A file that fails its sidecar or does not load is quarantined and
        yields None (its digest ""), and the scan goes on to the next
        newest; `*.corrupt` files never match. Files are memory-mapped, so
        a server reads only the tensors it uses. Lazy: a caller that takes
        the first candidate it can serve verifies no older file."""
        for e in sorted(self._epoch_checkpoints(), reverse=True):
            if e <= newer_than:
                break
            path = self.epoch_path(e)
            if not os.path.exists(checksum_path(path)):
                continue
            obj = load_verified(path, mmap=True)
            yield e, path, obj, (file_digest(path) if obj is not None else "")

    def restore_latest(self, state) -> Tuple[Any, int]:
        """(state, next_epoch): the newest epoch checkpoint that verifies and
        loads, else `ckpt_best.pt`; a bad candidate is quarantined and the
        next newest tried. next_epoch is 0 when there is nothing to
        restore."""
        state, next_epoch, _, _ = self.restore_latest_with_provenance(state)
        return state, next_epoch

    def restore_latest_with_provenance(
            self, state) -> Tuple[Any, int, Optional[str], Optional[str]]:
        """`restore_latest` that also says WHAT it restored: (state,
        next_epoch, path, sha256), path and digest None on a fresh start
        (what the fleet's consensus broadcasts from rank 0)."""
        self.wait()
        for e in sorted(self._epoch_checkpoints(), reverse=True):
            path = self.epoch_path(e)
            if self._restore_verified(state, path):
                self.best_metric = self.read_meta().get("best_metric",
                                                        float("-inf"))
                return state, e + 1, path, file_digest(path)
        if self._restore_verified(state, self.best_path):
            meta = self.read_meta()
            self.best_metric = meta.get("best_metric", float("-inf"))
            return (state, int(meta.get("best_epoch", -1)) + 1,
                    self.best_path, file_digest(self.best_path))
        return state, 0, None, None

    def restore_exact(self, state, path: str,
                      expected_digest: str) -> Optional[Any]:
        """A follower's consensus restore: load `path` into `state` iff
        its bytes hash to `expected_digest` (rank 0's choice); None when
        the file is missing, differs or does not load. Never quarantines:
        scanning and renaming are rank 0's alone, so a bad file makes ONE
        `*.corrupt`; a follower's failure surfaces in the fleet's digest
        agreement (rc 9) instead."""
        self.wait()
        try:
            if _sha256_file(path) != expected_digest:
                return None
            state.load_state_dict(torch.load(path, map_location="cpu",
                                             weights_only=True))
        except (OSError, ValueError, RuntimeError, KeyError, EOFError):
            return None
        return state
