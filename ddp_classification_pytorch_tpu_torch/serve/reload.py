"""Checkpoint hot-reload for the serving engine — the port's counterpart of
the JAX package's `serve/reload.py`.

A trainer keeps writing `ckpt_eN.pt` + sha256 sidecars into a run dir;
the server must pick new weights up without dropping traffic, and must
NEVER load a corrupt or torn candidate. Both behaviors already exist in
the training stack — this module points them at the engine:

- verification + quarantine are `train/checkpoint.py`'s own
  (`CheckpointManager.verified_candidates`): a candidate failing its
  sha256 sidecar or loading is renamed `*.corrupt` (evidence, and the
  scan stops matching it) and the watcher falls back to the next-newest
  candidate — the `--auto_resume` semantics;
- the candidate's model is built by the caller's `build` (in the CLI,
  `train/state.py::create_served_model` over `checkpoint.model_state`,
  from a memory-mapped file, so a train state's optimizer part is never
  read) on the watcher's thread, and its copies to the card have
  finished (the device is synchronized) before the swap publishes it;
- a model whose `state_dict` keys, shapes or dtypes differ from the one
  serving (`ServingEngine.state_compatible`), or whose weights do not fit
  the served arch at all (`build` raises ValueError), is REJECTED, not
  quarantined: the file is fine, it belongs to another deployment;
- the swap is `ServingEngine.swap_state()`: the batcher adopts the new
  model at a batch boundary, so no micro-batch mixes two checkpoints, and
  drops the old one there. The swap carries the verified sha256 + epoch
  so every answer (and /healthz) attests which weights served it.

A failed reload is therefore invisible to clients: the engine keeps
serving the previous verified weights, and the only trace is the
quarantined file plus a `reloads_rejected` tick in the metrics.

The poll itself is hardened against the filesystem it watches: a file
vanishing between scan and hash, an ENOENT/EIO mid-poll, a run dir
briefly unmounted — any OSError (or other surprise) is logged, counted,
and answered with a bounded exponential backoff (poll_s · 2^errors,
capped at `max_backoff_s`), after which the SAME thread re-arms and polls
again. `alive` is surfaced in /healthz, and the error/backoff transitions
land in the event log (`obs/events.py`).

Under a serve fleet (serve/fleet.py) the watcher is also the replica's
heartbeat: every poll tick rewrites the fleet lease (so a wedged watcher
thread == a stale lease), and the hot swap itself is token-gated — the
replica only swaps while holding the fleet's single drain token, which
makes the reload a rolling wave with at most one replica out at a time.

`chaos` (a `utils/chaos.py::FaultPlan`) stages the fs flake: its
watcher_io faults make the matching poll raise `OSError(EIO)`, which the
backoff layer absorbs like any other (JAX `reload.py:76,157-158`).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Mapping, Optional

import torch

from ..obs.events import emit
from ..obs.registry import Registry
from ..train.checkpoint import CheckpointManager, model_state
from ..utils.logging import host0_print


class CheckpointWatcher:
    """Polls a run dir and hot-swaps newer verified checkpoints into an
    engine. `build(state_dict) -> nn.Module` makes the served model from a
    checkpoint's weights (ValueError when they do not fit). Drive
    `check_once()` directly (tests, single-shot reload) or `start()` a
    daemon poll thread (`serve.reload_poll_s` cadence)."""

    def __init__(
        self,
        run_dir: str,
        engine: Any,
        build: Callable[[Mapping[str, torch.Tensor]], Any],
        poll_s: float = 5.0,
        metrics: Optional[Any] = None,
        max_backoff_s: float = 30.0,
        fleet: Optional[Any] = None,
        chaos: Optional[Any] = None,
    ):
        self.manager = CheckpointManager(run_dir, save_every_epoch=False)
        self.chaos = chaos  # FaultPlan for watcher_io drills; None = never
        self.engine = engine
        self.build = build
        self.poll_s = max(float(poll_s), 0.1)
        self.max_backoff_s = max(float(max_backoff_s), self.poll_s)
        self.metrics = metrics
        self.fleet = fleet  # FleetMember; poll tick doubles as heartbeat
        # newest epoch actually serving; candidates at or below it are not
        # re-loaded (an epoch file is written once — atomic rename)
        self.loaded_epoch = -1
        # transient-failure bookkeeping: consecutive_errors drives the
        # bounded backoff, last_error is the operator-facing diagnosis
        self.polls = 0
        self.consecutive_errors = 0
        self.last_error: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # watcher instruments live in the ENGINE's registry when metrics are
        # wired (so /metrics exposes them next to serve_*/engine_*); a
        # standalone watcher still self-observes into a private registry
        registry = metrics.registry if (
            metrics is not None and hasattr(metrics, "registry")
        ) else Registry()
        self._polls_total = registry.counter(
            "watcher_polls_total", "reload-dir polls attempted")
        self._errors_total = registry.counter(
            "watcher_errors_total", "polls that hit an fs fault (backed off)")
        self._swaps_total = registry.counter(
            "watcher_swaps_total", "verified checkpoints hot-swapped in")
        self._quarantines_total = registry.counter(
            "watcher_quarantines_total",
            "corrupt candidates renamed *.corrupt during a poll")
        self._backoff_gauge = registry.gauge(
            "watcher_backoff_seconds",
            "current error backoff (0 = healthy cadence)")

    @property
    def alive(self) -> bool:
        """True while the poll thread is running — /healthz surfaces this
        so a replica serving stale weights with a dead watcher is
        distinguishable from one that is merely between polls."""
        return self._thread is not None and self._thread.is_alive()

    def _heartbeat(self) -> None:
        if self.fleet is not None:
            self.fleet.heartbeat(digest=self.engine.params_digest,
                                 generation=self.engine.params_generation)

    def _reject(self, epoch: int, why: str) -> None:
        if self.metrics is not None:
            self.metrics.record_reload(ok=False)
        host0_print(f"[serve] reload candidate epoch {epoch} rejected ({why}); "
                    f"still serving epoch {self.loaded_epoch}")

    def _servable(self, epoch: int, obj) -> Optional[Any]:
        """The served model built from a verified file's weights, its
        copies finished; None (rejected) when they do not fit."""
        try:
            model = self.build(model_state(obj))
        except ValueError as e:
            self._reject(epoch, f"weights do not fit the served model: {e}")
            return None
        device = getattr(self.engine, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            # the copies ran on this thread's stream: finished before the
            # device thread may read the weights
            torch.cuda.synchronize(device)
        compat = getattr(self.engine, "state_compatible", None)
        if callable(compat) and not compat(model):
            # valid bytes, wrong program: a state whose keys, shapes or
            # dtypes no longer match the serving model belongs to another
            # deployment — rejected, not quarantined
            self._reject(epoch, "state incompatible with the serving model")
            return None
        return model

    def _scan(self):
        """(epoch, path, digest, model) for each candidate newer than the
        one serving, newest first; model None = quarantined or rejected."""
        for e, path, obj, digest in self.manager.verified_candidates(
                self.loaded_epoch):
            if obj is None:  # quarantined by the manager; try next-newest
                self._quarantines_total.inc()
                self._reject(e, "quarantined")
                yield e, path, digest, None
                continue
            yield e, path, digest, self._servable(e, obj)

    def _adopt(self, epoch: int, path: str, digest: str, model) -> None:
        emit("verify_ok", epoch=epoch, path=path, digest=digest)
        self.engine.swap_state(model, digest=digest, generation=epoch)
        self.loaded_epoch = epoch
        emit("swap", epoch=epoch, digest=digest)

    def restore_initial(self) -> int:
        """Serve the newest verified checkpoint at startup (quarantining any
        bad ones on the way, like --auto_resume); returns the loaded epoch
        (-1 = nothing verified yet — the engine serves its fresh weights
        until the first good checkpoint lands)."""
        for e, path, digest, model in self._scan():
            if model is not None:
                self._adopt(e, path, digest, model)
                break
        # announce ourselves before the first poll tick: a joining
        # replica should appear in the registry as soon as it serves
        self._heartbeat()
        return self.loaded_epoch

    def check_once(self) -> bool:
        """One poll: try candidates newer than `loaded_epoch`, newest first.
        A corrupt candidate is quarantined (`*.corrupt`) and counted as a
        rejected reload; serving continues on the current weights. Returns
        True iff a swap happened. OSErrors propagate to `poll_once` (the
        backoff layer); direct callers see them raw."""
        self.polls += 1
        self._polls_total.inc()
        # the lease rewrite IS the replica heartbeat: piggybacking it on
        # the poll tick means a wedged watcher goes visibly stale
        self._heartbeat()
        if self.chaos:
            self.chaos.maybe_fail_watcher_poll(poll=self.polls)
        for e, path, digest, model in self._scan():
            if model is None:
                continue
            if self.fleet is not None \
                    and not self.fleet.try_begin_drain(digest):
                # another replica holds the fleet's drain token: our wave
                # slot comes on a later poll (or after its token goes
                # TTL-stale and we take it over). Nothing is dropped.
                host0_print(f"[serve] reload to epoch {e} waiting for the "
                            "fleet drain token (rolling wave)")
                return False
            self._adopt(e, path, digest, model)
            self._swaps_total.inc()
            if self.fleet is not None:
                # swap adopted at the next batch boundary; release our
                # wave slot with the digest we now serve
                self.fleet.end_drain(digest=digest, generation=e)
            if self.metrics is not None:
                self.metrics.record_reload(ok=True)
            host0_print(f"[serve] hot-reloaded checkpoint epoch {e}")
            return True
        return False

    def poll_once(self) -> float:
        """`check_once` wrapped in the transient-failure policy; returns the
        delay before the next poll. Success (or a quiet poll) resets the
        backoff to `poll_s`; a failure doubles it, bounded by
        `max_backoff_s` — deterministic, so tests can pin the sequence."""
        try:
            self.check_once()
        except Exception as e:  # a poll hiccup must not kill serving
            self.consecutive_errors += 1
            self.last_error = f"{type(e).__name__}: {e}"
            backoff = min(self.poll_s * (2 ** min(self.consecutive_errors, 6)),
                          self.max_backoff_s)
            host0_print(f"[serve] reload poll failed ({self.last_error}); "
                        f"watcher backing off {backoff:.1f}s "
                        f"(error {self.consecutive_errors}, re-arming)")
            emit("watcher_error", error=self.last_error, poll=self.polls,
                 backoff_s=backoff)
            self._errors_total.inc()
            self._backoff_gauge.set(backoff)
            return backoff
        self.consecutive_errors = 0
        self.last_error = None
        self._backoff_gauge.set(0.0)
        return self.poll_s

    # ------------------------------------------------------------- thread --
    def start(self) -> "CheckpointWatcher":
        if self._thread is not None:
            return self

        def loop():
            delay = self.poll_s
            while not self._stop.wait(delay):
                delay = self.poll_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serve-reload")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
