"""Console and record output — the port's copy of the JAX package's
`utils/logging.py` parts the trainer uses: ETA console lines
(BASELINE/main.py:295-303), `output.txt` per-epoch appends and
`history.json` (NESTED/train.py:421,444-445), resumed with `resume_at`.
Under a process group only rank 0 prints (the trainer gives only rank 0
a `RecordWriter`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

from ..parallel import ddp


def host0_print(*a: Any, **kw: Any) -> None:
    """`print` on rank 0 (the JAX `jax.process_index() == 0` rule)."""
    if ddp.is_primary():
        print(*a, **kw)


class EtaLogger:
    """Per-N-step console line with batch time and ETA in minutes."""

    def __init__(self, steps_per_epoch: int, epochs: int, log_every: int = 20):
        self.steps_per_epoch = steps_per_epoch
        self.epochs = epochs
        self.log_every = log_every
        self.t0 = time.time()

    def maybe_log(self, epoch: int, step: int, **metrics: float) -> None:
        if step % self.log_every != 0:
            return
        now = time.time()
        elapsed = now - self.t0
        self.t0 = now
        done = epoch * self.steps_per_epoch + step
        remain = max(self.epochs * self.steps_per_epoch - done, 0)
        eta_min = (elapsed / max(self.log_every, 1)) * remain / 60.0
        parts = "\t".join(f"{k}: {v:.4f}" for k, v in metrics.items())
        host0_print(f"Epoch: {epoch}\tstep: {step}/{self.steps_per_epoch}\t{parts}"
              f"\t{self.log_every}-step time: {elapsed:.2f}s\tETA: {eta_min:.1f} min")


class RecordWriter:
    """`output.txt` + `history.json` writer."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.txt_path = os.path.join(out_dir, "output.txt")
        self.history_path = os.path.join(out_dir, "history.json")
        self.history: Dict[str, list] = {}
        os.makedirs(out_dir, exist_ok=True)

    def append_txt(self, line: str) -> None:
        with open(self.txt_path, "a") as f:
            f.write(line.rstrip("\n") + "\n")

    def resume_at(self, start_epoch: int) -> None:
        """Reload `history.json` truncated to `start_epoch`, so a resumed run
        appends to the curve before the stop instead of rewriting it with
        only the epochs after it (and drops epochs past the checkpoint
        restored)."""
        if os.path.exists(self.history_path):
            try:
                with open(self.history_path) as f:
                    prior = json.load(f)
            except (ValueError, OSError):
                prior = {}  # a torn file must not stop the resumed run
            for k, v in prior.items():
                if isinstance(v, list):
                    self.history[k] = [None if x is None else float(x)
                                       for x in v[:start_epoch]]
            self.flush_history()

    def log_epoch(self, epoch: int, **metrics: float) -> None:
        """One epoch record → output.txt and history (`history[k][e]` is
        epoch e's value; gaps are JSON nulls)."""
        self.append_txt(
            f"epoch:{epoch}\t" + "\t".join(f"{k}:{v:.6f}" for k, v in metrics.items()))
        for k, v in metrics.items():
            lst = self.history.setdefault(k, [])
            if len(lst) > epoch:
                lst[epoch] = float(v)
            else:
                while len(lst) < epoch:
                    lst.append(None)
                lst.append(float(v))
        self.flush_history()

    def flush_history(self) -> None:
        # atomic tmp + replace: a preemption mid-write leaves the previous
        # epoch's complete file
        tmp = self.history_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.history, f, indent=1)
        os.replace(tmp, self.history_path)
