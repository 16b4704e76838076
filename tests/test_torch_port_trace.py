"""The port's profiler breakdown (`obs/trace.py`), its phase probes
(`train/steps.py::make_phase_probes`) and the Trainer's profiler window,
on the CPU.

(a) `parse_chrome_trace`, `aggregate` and `SpanRecorder` give the JAX
    module's rows exactly, on JAX's checked-in fixture
    (`tests/data/fixture.trace.json`, read only) and on generated traces
    (nested, overlapping, window-straddling and unknown events on several
    lanes); `classify` gives JAX's bucket wherever JAX gives one, and
    places CUDA's `Memcpy HtoD` in h2d.
(b) `from_torch_trace` on a CUDA-shaped torch.profiler export: kernels
    attributed through their `correlation` launch to the phase range
    holding it (the backward's launches on another thread), the
    `gpu_user_annotation` copies of the ranges dropped, copies and NCCL
    kernels by name, the window the device span of the step's work; the
    six buckets sum to its wall.
(c) A 2-step capture through the port's Trainer on the CPU (JAX's
    `test_profiler_window_captures_trace`): the window closes inside
    epoch 0, `<out>/profile/<host>.trace.json.gz` lands, and it parses to
    two steps whose buckets sum to their walls with fwd, bwd and
    optimizer time. The phase probes leave the state as it was, their
    loss is the step's, and their times feed `SpanRecorder`.
"""

import copy
import json
import os
import socket
import time

import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.obs import trace as jax_trace
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.obs import trace
from ddp_classification_pytorch_tpu_torch.train import steps
from ddp_classification_pytorch_tpu_torch.train.loop import Trainer

from torch_port_threads import one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "fixture.trace.json")
NAMES = ("all-reduce.5", "reduce-scatter.4", "TransferToDevice", "copy-start",
         "transpose(dot.7)", "gradients/conv1", "adamw.update", "sgd",
         "forward/block1", "fwd", "bwd", "optimizer", "dot.3", "fusion.12",
         "Memcpy HtoD (Pinned -> Device)", "Memcpy DtoD (Device -> Device)",
         "ncclDevKernel_AllReduce_Sum_f32_RING_LL", "Memset (Device)",
         "flash_fwd_kernel_sm90", "void at::native::vectorized_elementwise")


def _generated(seed):
    """A random trace: step windows on one lane, events of the names above
    that both vocabularies place alike on three lanes, some straddling a
    window, some nested."""
    names = [n for n in NAMES if trace.classify(n) == jax_trace.classify(n)]
    rng = np.random.default_rng(seed)
    events, t = [], 0.0
    for n in range(3):
        wall = float(rng.uniform(5e3, 2e4))
        events.append({"ph": "X", "name": "bench_step", "pid": 1, "tid": 0,
                       "ts": t, "dur": wall, "args": {"step_num": n}})
        for _ in range(25):
            s = t + float(rng.uniform(-0.1, 1.0)) * wall
            events.append({"ph": "X", "name": str(rng.choice(names)),
                           "pid": 1, "tid": int(rng.integers(0, 3)),
                           "ts": s, "dur": float(rng.uniform(1, 0.3 * wall))})
        t += wall + 1.0
    events.append({"ph": "M", "name": "process_name", "pid": 1})
    return {"traceEvents": events}


def _traces():
    with open(FIXTURE) as f:
        yield json.load(f)
    for seed in range(4):
        yield _generated(seed)


def test_parser_and_aggregate_give_jaxs_rows():
    for tr in _traces():
        want = jax_trace.parse_chrome_trace(tr)
        got = trace.parse_chrome_trace(tr)
        assert got == want and len(got) >= 2
        assert trace.aggregate(got) == jax_trace.aggregate(want)
        for row in got:  # idle is clamped at 0 only where classified
            # lanes overlap past the wall
            total = sum(row[b] for b in trace.BUCKETS)
            if row["idle"] > 0:
                assert total == pytest.approx(row["step_ms"])
            else:
                assert total >= row["step_ms"] - 1e-9
    assert trace.aggregate([]) == {}


def test_classify_keeps_jaxs_buckets():
    for name in NAMES:
        if jax_trace.classify(name) is not None:
            assert trace.classify(name) == jax_trace.classify(name), name
    assert jax_trace.classify("Memcpy HtoD (Pinned -> Device)") is None
    assert trace.classify("Memcpy HtoD (Pinned -> Device)") == "h2d"
    assert trace.classify("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == (
        "collectives")
    assert trace.classify("Memcpy DtoD (Device -> Device)") is None


def test_span_recorder_gives_jaxs_trace_and_rows():
    ours, theirs = trace.SpanRecorder(), jax_trace.SpanRecorder()
    phases = [(0.010, {"fwd": 0.004, "bwd": 0.003, "optimizer": 0.001}),
              (0.005, {"fwd": 0.004, "bwd": 0.004, "optimizer": 0.002}),
              (0.012, {"fwd": 0.005, "bwd": 0.004})]
    for n, (wall, ph) in enumerate(phases):
        ours.add_step(n, wall, ph)
        theirs.add_step(n, wall, ph)
    assert ours.to_chrome_trace() == theirs.to_chrome_trace()
    assert ours.breakdown() == theirs.breakdown()
    with pytest.raises(ValueError):
        ours.add_step(0, 0.01, {"idle": 0.001})


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
            "ts": float(ts), "dur": float(dur), "args": args}


def test_from_torch_trace_attributes_kernels_through_their_launches():
    """Host: step 5 in [0, 1000) µs with fwd [0, 300), bwd [300, 700) (its
    launches on the autograd thread 2), optimizer [700, 1000). Device:
    kernels run later than their launches; a gpu_user_annotation copy of
    fwd spans the device lane and must not count."""
    ev = [_ev("user_annotation", "bench_step#5", 0, 1000),
          _ev("user_annotation", "fwd", 0, 300),
          _ev("user_annotation", "bwd", 300, 400),
          _ev("user_annotation", "optimizer", 700, 300),
          _ev("gpu_user_annotation", "fwd", 100, 900, tid=9)]
    launches = [(1, 10, 1), (2, 200, 1), (3, 350, 2), (4, 600, 2),
                (5, 800, 1), (6, 50, 1), (7, 650, 2), (8, 1500, 1)]
    for corr, ts, tid in launches:
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", ts, 5, tid=tid,
                      correlation=corr))
    kernels = [(1, "conv_fwd_kernel", 100, 100), (2, "elementwise", 200, 100),
               (3, "wgrad_kernel", 400, 200), (4, "dgrad", 600, 100),
               (5, "multi_tensor_apply", 800, 50)]
    for corr, name, ts, dur in kernels:
        ev.append(_ev("kernel", name, ts, dur, tid=9, correlation=corr))
    ev.append(_ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 150, 40,
                  tid=10, correlation=6))
    ev.append(_ev("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 700,
                  80, tid=11, correlation=7))
    ev.append(_ev("kernel", "next_step_kernel", 1600, 10, tid=9,
                  correlation=8))  # launched after the window: not this step
    (row,) = trace.parse_chrome_trace(trace.from_torch_trace(
        {"traceEvents": ev}))
    assert row["step"] == 5
    assert row["step_ms"] == pytest.approx(0.750)  # device span 100 → 850
    assert row["fwd"] == pytest.approx(0.200)
    assert row["bwd"] == pytest.approx(0.300)
    assert row["optimizer"] == pytest.approx(0.050)
    assert row["h2d"] == pytest.approx(0.040)
    assert row["collectives"] == pytest.approx(0.080)
    assert row["idle"] == pytest.approx(0.080)
    assert sum(row[b] for b in trace.BUCKETS) == pytest.approx(row["step_ms"])


def _tiny_cfg(out):
    cfg = get_preset("baseline")
    cfg.model.arch, cfg.model.dtype = "vit_t16", "float32"
    cfg.data.dataset, cfg.data.synthetic_size = "synthetic", 16
    cfg.data.image_size, cfg.data.num_classes = 32, 10
    cfg.data.batch_size, cfg.data.num_workers = 4, 1
    cfg.run.epochs, cfg.run.out_dir = 1, str(out)
    return cfg


def test_profiler_window_captures_a_trace_through_the_trainer(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    cfg.run.profile_steps = 2
    tr = Trainer(cfg, torch.device("cpu"))
    assert tr.steps_per_epoch == 4 and tr._prof_start_step == 2
    tr.run()
    assert tr._prof_active is False
    assert tr._prof_steps == 0  # the window closed inside epoch 0
    path = tmp_path / "profile" / f"{socket.gethostname()}.trace.json.gz"
    assert trace.find_trace_file(str(tmp_path / "profile")) == str(path)
    rows = trace.breakdown_from_torch_trace(str(path))
    assert [r["step"] for r in rows] == [2, 3]
    for r in rows:
        assert min(r["fwd"], r["bwd"], r["optimizer"]) > 0
        assert sum(r[b] for b in trace.BUCKETS) == pytest.approx(
            r["step_ms"])
    assert not torch.autograd.profiler._is_profiler_enabled


def test_phase_probes_leave_the_state_and_feed_the_span_recorder(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    tr = Trainer(cfg, torch.device("cpu"))
    state = tr.state
    images, labels = next(iter(tr.train_prefetch))
    probes = steps.make_phase_probes(cfg)
    before = copy.deepcopy(state.model.state_dict())
    rec = trace.SpanRecorder()
    t = time.perf_counter()
    loss = probes["fwd"](state, images, labels)
    t_fwd = time.perf_counter() - t
    t = time.perf_counter()
    loss2, norm = probes["fwd_bwd"](state, images, labels)
    t_fb = time.perf_counter() - t
    after = state.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert all(p.grad is None for p in state.model.parameters())
    assert float(loss) == pytest.approx(float(loss2), rel=1e-6)
    t = time.perf_counter()
    m = tr.train_step(state, images, labels)
    t_step = time.perf_counter() - t
    assert float(m["loss"]) == pytest.approx(float(loss), rel=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(float(norm), rel=1e-5)
    rec.add_step(0, t_step, {"fwd": t_fwd, "bwd": max(t_fb - t_fwd, 0.0),
                             "optimizer": max(t_step - t_fb, 0.0)})
    (row,) = rec.breakdown()
    assert row["fwd"] > 0
    assert sum(row[b] for b in trace.BUCKETS) == pytest.approx(
        row["step_ms"])
    tr._teardown()
