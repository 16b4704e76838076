"""Checkpoint hot-reload in the port (`serve/reload.py`) on the port's
checkpoints, on the CPU: the JAX package's reload cases of
`tests/test_serve.py`, plus the port's rejection of an incompatible
checkpoint, the watcher's backoff, `restore_initial`, the fleet's drain
token, and the trainer's side of the event spine.

A reduced ResNet (basic blocks (1, 1, 1, 1), 8 filters, CIFAR stem,
32 px, 8 classes, f32) keeps each checkpoint under a megabyte. The events
the port writes are read back and validated by the JAX package's
`read_events` / `validate_events`.
"""

import glob
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.obs import events as jax_events
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.models import resnet
from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel
from ddp_classification_pytorch_tpu_torch.serve.engine import (
    QueueFull,
    ServingEngine,
)
from ddp_classification_pytorch_tpu_torch.serve.fleet import FleetMember
from ddp_classification_pytorch_tpu_torch.serve.metrics import ServeMetrics
from ddp_classification_pytorch_tpu_torch.serve.reload import CheckpointWatcher
from ddp_classification_pytorch_tpu_torch.train import checkpoint
from ddp_classification_pytorch_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
from ddp_classification_pytorch_tpu_torch.train.state import init_weights_
from ddp_classification_pytorch_tpu_torch.train.steps import (
    make_topk_predict_step,
)

CPU = torch.device("cpu")
BUCKETS = (2, 4)
PREDICT = make_topk_predict_step(get_preset("baseline"), 3)


def _model(seed: int = 0, scale: float = 1.0, classes: int = 8):
    model = ClassifierModel(resnet.ResNet(
        (1, 1, 1, 1), resnet.BasicBlock, num_classes=classes, num_filters=8,
        cifar_stem=True, dtype=torch.float32))
    init_weights_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(scale)
    return model.eval()


def _build(state_dict):
    """The served model from a checkpoint's weights (the CLI's
    `served_model_builder`, for the reduced net): ValueError when they do
    not fit."""
    model = _model()
    try:
        model.load_state_dict(state_dict)
    except RuntimeError as e:
        raise ValueError(str(e)) from None
    return model.eval()


IMGS = np.random.default_rng(7).integers(0, 256, (8, 32, 32, 3)).astype(np.uint8)


def _engine(model=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("batch_timeout_ms", 40.0)
    kw.setdefault("queue_depth", 16)
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("metrics", ServeMetrics())
    return ServingEngine(model if model is not None else _model(), PREDICT,
                         image_size=32, device=CPU, **kw)


def _scores(model, imgs):
    return PREDICT(model, torch.from_numpy(np.ascontiguousarray(imgs)))[0].numpy()


def _corrupt(path):
    with open(path, "r+b") as fh:
        fh.seek(100)
        fh.write(b"\xde\xad\xbe\xef")


def test_hot_reload_swaps_and_quarantines_corrupt(tmp_path, monkeypatch):
    """A newer verified checkpoint hot-swaps between batches (responses
    change to the new weights' outputs, bitwise); a newer-still CORRUPT
    candidate is quarantined (*.corrupt) and serving continues on the last
    verified weights. The trainer's and the watcher's events share one
    log that the JAX package's schema accepts."""
    events = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("SCENARIO_EVENTS", events)
    run_dir = str(tmp_path / "run")
    mgr = CheckpointManager(run_dir)
    base = _model()
    mgr.save(_model(scale=1.5), epoch=1)

    metrics = ServeMetrics()
    engine = _engine(base, metrics=metrics)
    watcher = CheckpointWatcher(run_dir, engine, _build, metrics=metrics)
    base_scores = _scores(base, IMGS[:2])
    assert watcher.check_once() is True
    assert watcher.loaded_epoch == 1
    f = engine.submit(IMGS[0])
    engine.submit(IMGS[1])
    assert engine.process_once() == 2
    got = f.result(timeout=30)
    # the swap took: responses now match the RELOADED weights, not the old
    np.testing.assert_array_equal(got.scores, _scores(engine._state, IMGS[:2])[0])
    assert not np.array_equal(got.scores, base_scores[0])
    assert engine._state is not base  # the old model was let go
    digest1 = checkpoint.file_digest(mgr.epoch_path(1))
    assert (got.digest, got.generation) == (digest1, 1)
    assert (engine.params_digest, engine.params_generation) == (digest1, 1)

    # corrupt newer candidate: epoch-2 bytes torn after the sidecar landed
    mgr.save(_model(scale=2.0), epoch=2)
    _corrupt(mgr.epoch_path(2))
    assert watcher.check_once() is False  # nothing newer verified
    assert os.path.exists(mgr.epoch_path(2) + ".corrupt")
    assert not os.path.exists(mgr.epoch_path(2))
    assert watcher.loaded_epoch == 1  # still serving the verified weights
    snap = metrics.snapshot()
    assert snap["reloads"] == 1 and snap["reloads_rejected"] == 1
    # and the engine still answers (on the epoch-1 weights)
    f = engine.submit(IMGS[2])
    engine.submit(IMGS[3])
    assert engine.process_once() == 2
    np.testing.assert_array_equal(f.result(timeout=30).scores,
                                  _scores(engine._state, IMGS[2:4])[0])

    log = jax_events.read_events(events)
    assert jax_events.validate_events(log) == []
    assert [r["kind"] for r in log] == ["publish", "verify_ok", "swap",
                                        "publish", "quarantine"]
    publish = log[0]
    assert publish["epoch"] == 1 and publish["digest"] == digest1
    assert publish["world_size"] == 1 and publish["path"] == mgr.epoch_path(1)
    assert log[2] == {**log[2], "epoch": 1, "digest": digest1}
    assert log[4]["path"] == mgr.epoch_path(2) and "sha256" in log[4]["reason"]


def test_swap_racing_drain_never_mixes_params_in_a_batch():
    """swap_state storms from a reloader thread while requests flow and the
    engine finally drains: every answered Prediction is INTERNALLY
    consistent — its scores bitwise those of the model its digest names."""
    img = IMGS[0]
    model_a, model_b = _model(), _model(scale=1.5)
    expected = {}
    for name, m in (("fresh", model_a), ("A", model_a), ("B", model_b)):
        rows = set()
        for b in BUCKETS:
            out = _scores(m, np.stack([img] * b))
            rows.update(out[i].tobytes() for i in range(b))
        expected[name] = rows
    assert not expected["A"] & expected["B"]

    engine = _engine(model_a, batch_timeout_ms=5.0, queue_depth=32).start()
    stop = threading.Event()

    def swapper():
        flip = False
        while not stop.is_set():
            if flip:
                engine.swap_state(model_b, digest="B", generation=2)
            else:
                engine.swap_state(model_a, digest="A", generation=1)
            flip = not flip
            time.sleep(0.002)

    t = threading.Thread(target=swapper)
    t.start()
    futures = []
    try:
        for _ in range(24):
            try:
                futures.append(engine.submit(img))
            except QueueFull:
                pass
            time.sleep(0.003)
        # drain races the still-running swapper: the inline flush keeps
        # the one-model-per-batch contract too
        engine.drain()
    finally:
        stop.set()
        t.join()
    preds = [f.result(timeout=30) for f in futures]
    assert preds, "no request was ever accepted"
    for p in preds:
        assert p.digest in expected
        assert p.scores.tobytes() in expected[p.digest], (
            f"scores answered under digest {p.digest!r} do not match that "
            "checkpoint's weights — a micro-batch mixed two models")


def test_quarantine_double_rename_yields_exactly_one_corrupt(tmp_path):
    """The shared-run-dir race: the serving watcher AND a trainer-side
    manager both find the same corrupt candidate and quarantine it. In
    either order the loser's rename is a silent no-op — exactly ONE
    *.corrupt file, no crash, serving state untouched."""

    def corrupt_candidate(run_dir, epoch):
        mgr = CheckpointManager(run_dir)
        mgr.save(_model(), epoch=epoch)
        _corrupt(mgr.epoch_path(epoch))
        return mgr

    stub = SimpleNamespace(swap_state=lambda *a, **k: None)
    # order 1: the trainer-side manager quarantines first (its resume)
    d1 = str(tmp_path / "a")
    mgr = corrupt_candidate(d1, 1)
    watcher = CheckpointWatcher(d1, stub, _build)
    assert checkpoint.load_verified(mgr.epoch_path(1)) is None
    assert watcher.check_once() is False  # nothing left to scan; no crash
    assert watcher.loaded_epoch == -1
    assert len(glob.glob(os.path.join(d1, "*.pt.corrupt"))) == 1

    # order 2: the watcher quarantines first, the manager loses the race
    d2 = str(tmp_path / "b")
    mgr = corrupt_candidate(d2, 1)
    watcher = CheckpointWatcher(d2, stub, _build)
    assert watcher.check_once() is False
    assert mgr.restore_latest(_model())[1] == 0  # nothing restorable
    # and a second rename of the SAME path (both sides committed to
    # quarantine before either rename landed) is a no-op, not a crash
    checkpoint.quarantine_file(mgr.epoch_path(1), "sha256 mismatch")
    assert len(glob.glob(os.path.join(d2, "*.pt.corrupt"))) == 1
    assert watcher.loaded_epoch == -1


def test_incompatible_checkpoint_is_rejected_not_quarantined(tmp_path):
    """Valid bytes, wrong program: a checkpoint of another head size is
    rejected (reloads_rejected + 1), kept on disk unrenamed, and serving
    stays on the current weights; a fitting newer one then swaps in."""
    run_dir = str(tmp_path)
    mgr = CheckpointManager(run_dir)
    mgr.save(_model(classes=5), epoch=3)
    metrics = ServeMetrics()
    engine = _engine(metrics=metrics)
    watcher = CheckpointWatcher(run_dir, engine, _build, metrics=metrics)
    before = engine._state
    assert watcher.check_once() is False
    assert metrics.reloads_rejected == 1 and metrics.reloads == 0
    assert os.path.exists(mgr.epoch_path(3))
    assert not glob.glob(os.path.join(run_dir, "*.corrupt"))
    assert watcher.loaded_epoch == -1
    f = engine.submit(IMGS[0])
    engine.process_once()
    assert f.result(timeout=30).digest == "fresh" and engine._state is before

    # the same keys and shapes in another dtype: built, then refused by
    # the engine's state check
    def build_f64(sd):
        return _build(sd).double()

    watcher.build = build_f64
    mgr.save(_model(scale=1.5), epoch=4)
    assert watcher.check_once() is False
    assert metrics.reloads_rejected == 3  # epoch 4 (dtype), epoch 3 again

    watcher.build = _build
    assert watcher.check_once() is True and watcher.loaded_epoch == 4
    assert metrics.reloads == 1


def test_watcher_survives_oserror_with_bounded_backoff(tmp_path, monkeypatch):
    """An OSError mid-poll is counted and answered with poll_s · 2^errors,
    capped at max_backoff_s; a clean poll resets the cadence, and the poll
    thread stays alive throughout and swaps once the fault clears."""
    run_dir = str(tmp_path)
    mgr = CheckpointManager(run_dir)
    metrics = ServeMetrics()
    engine = _engine(metrics=metrics)
    events = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("SCENARIO_EVENTS", events)
    watcher = CheckpointWatcher(run_dir, engine, _build, poll_s=0.1,
                                metrics=metrics, max_backoff_s=0.5)
    real = watcher.manager.verified_candidates
    faults = {"left": 4}

    def flaky(*a, **k):
        if faults["left"] > 0:
            faults["left"] -= 1
            raise OSError(5, "Input/output error (injected)")
        return real(*a, **k)

    monkeypatch.setattr(watcher.manager, "verified_candidates", flaky)
    delays = [watcher.poll_once() for _ in range(3)]
    assert delays == pytest.approx([0.2, 0.4, 0.5])
    assert watcher.consecutive_errors == 3
    assert "Input/output error" in watcher.last_error
    reg = metrics.registry.expose()
    assert "watcher_errors_total 3" in reg
    assert "watcher_backoff_seconds 0.5" in reg

    watcher.start()
    try:
        deadline = time.monotonic() + 10
        while faults["left"] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert watcher.alive  # the fault did not kill the thread
        mgr.save(_model(scale=1.5), epoch=0)
        while watcher.loaded_epoch != 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert watcher.loaded_epoch == 0 and watcher.alive
        assert watcher.consecutive_errors == 0 and watcher.last_error is None
    finally:
        watcher.stop()
    assert not watcher.alive
    log = jax_events.read_events(events)
    assert jax_events.validate_events(log) == []
    errors = [r for r in log if r["kind"] == "watcher_error"]
    assert len(errors) == 4 and errors[0]["backoff_s"] == pytest.approx(0.2)


def test_restore_initial_picks_the_newest_verified(tmp_path):
    """At startup the newest epoch that verifies and fits is served; a
    corrupt newer one is quarantined on the way, and the fleet lease is
    written before the first poll."""
    run_dir = str(tmp_path)
    mgr = CheckpointManager(run_dir)
    for e in (0, 1, 2):
        mgr.save(_model(scale=1.0 + e / 4), epoch=e)
    _corrupt(mgr.epoch_path(2))
    engine = _engine()
    fleet = FleetMember(str(tmp_path / "fleet"), 0,
                        registry=engine.metrics.registry)
    watcher = CheckpointWatcher(run_dir, engine, _build,
                                metrics=engine.metrics, fleet=fleet)
    assert watcher.restore_initial() == 1
    assert os.path.exists(mgr.epoch_path(2) + ".corrupt")
    f = engine.submit(IMGS[0])
    engine.process_once()
    pred = f.result(timeout=30)
    assert (pred.digest, pred.generation) == (
        checkpoint.file_digest(mgr.epoch_path(1)), 1)
    np.testing.assert_array_equal(pred.scores,
                                  _scores(_model(scale=1.25), IMGS[:2])[0])
    lease = fleet.peers()[0]  # announced before the first poll (the swap
    # lands at the next batch boundary, so the lease names the weights
    # serving at the time: the fresh ones)
    assert (lease.replica, lease.state, lease.digest) == (0, "serving",
                                                          "fresh")
    # an empty run dir serves the fresh weights
    empty = CheckpointWatcher(str(tmp_path / "none"), _engine(), _build)
    assert empty.restore_initial() == -1


def test_swap_waits_for_the_fleet_drain_token(tmp_path):
    """Under a fleet the swap happens only while holding the single drain
    token: refused while a peer holds it, then taken, swapped and
    released, with the lease carrying the new digest and generation."""
    run_dir, fleet_dir = str(tmp_path / "run"), str(tmp_path / "fleet")
    mgr = CheckpointManager(run_dir)
    mgr.save(_model(scale=1.5), epoch=5)
    engine = _engine()
    me = FleetMember(fleet_dir, 0, registry=engine.metrics.registry)
    peer = FleetMember(fleet_dir, 1)
    watcher = CheckpointWatcher(run_dir, engine, _build,
                                metrics=engine.metrics, fleet=me)
    assert peer.try_begin_drain("other")
    assert watcher.check_once() is False and watcher.loaded_epoch == -1
    peer.end_drain(digest="other", generation=0)
    assert watcher.check_once() is True and watcher.loaded_epoch == 5
    digest = checkpoint.file_digest(mgr.epoch_path(5))
    assert (me.state, me.digest, me.generation) == ("serving", digest, 5)
    assert not os.path.exists(os.path.join(fleet_dir, "serve_fleet",
                                           "wave.token"))
    assert me.peers()[0].generation == 5
    assert "fleet_wave_swaps_total 1" in engine.metrics.registry.expose()


def test_checkpoint_events_pass_jax_validation(tmp_path, monkeypatch):
    """The trainer's side of the event spine: a verified epoch save emits
    `publish` (epoch, path, digest, world_size) after its sidecar, the best
    copy none, and a quarantine on resume `quarantine` (path, reason) — the
    JAX manager's records, which the JAX schema accepts."""
    events = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("SCENARIO_EVENTS", events)
    monkeypatch.setenv("SCENARIO_SOURCE", "trainer.h0")
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(_model(), epoch=0, metric=0.5)  # epoch file + best copy
    mgr.save(_model(scale=1.5), epoch=1, metric=0.2)
    _corrupt(mgr.epoch_path(1))
    state, next_epoch = mgr.restore_latest(_model())
    assert next_epoch == 1  # fell back to epoch 0
    log = jax_events.read_events(events)
    assert jax_events.validate_events(log) == []
    assert [r["kind"] for r in log] == ["publish", "publish", "quarantine"]
    for rec, e in zip(log, (0, 1)):
        assert set(rec) == {"ts", "kind", "source", "epoch", "path", "digest",
                            "world_size"}
        assert (rec["epoch"], rec["path"], rec["source"]) == (
            e, mgr.epoch_path(e), "trainer.h0")
    assert log[0]["digest"] == checkpoint.file_digest(mgr.epoch_path(0))
    assert set(log[2]) == {"ts", "kind", "source", "path", "reason"}
    assert log[2]["path"] == mgr.epoch_path(1)


def test_candidate_without_its_sidecar_yet_is_skipped_not_quarantined(
        tmp_path):
    """A poll that falls between a save's file and its sidecar (the
    sidecar is written strictly after the bytes) leaves the file alone:
    no quarantine, no rejection; once the sidecar lands the next poll
    swaps it in."""
    run_dir = str(tmp_path)
    mgr = CheckpointManager(run_dir)
    mgr.save(_model(scale=1.5), epoch=7)
    sidecar = checkpoint.checksum_path(mgr.epoch_path(7))
    os.replace(sidecar, str(tmp_path / "held.sha256"))
    metrics = ServeMetrics()
    engine = _engine(metrics=metrics)
    watcher = CheckpointWatcher(run_dir, engine, _build, metrics=metrics)
    assert watcher.check_once() is False
    assert os.path.exists(mgr.epoch_path(7))
    assert not glob.glob(os.path.join(run_dir, "*.corrupt"))
    assert metrics.reloads_rejected == 0 and watcher.loaded_epoch == -1
    os.replace(str(tmp_path / "held.sha256"), sidecar)
    assert watcher.check_once() is True and watcher.loaded_epoch == 7
