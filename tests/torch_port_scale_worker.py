"""One rank of the scaling levers' two-rank tests
(tests/test_torch_port_zero.py, tests/test_torch_port_grad_accum.py): a
gloo process group on the CPU joined from torchrun's environment
variables, as tests/torch_port_ddp_worker.py joins it.

    python tests/torch_port_scale_worker.py IN.pt OUT_DIR

IN.pt holds the reduced ResNet-50's state dict, the recipe, the global
batches and `cases`, the names of the runs to make; each rank writes
OUT_DIR/rank<R>.pt with one entry a case. Every run is the port's train
step (`train/steps.py::make_train_step`) under DistributedDataParallel
(`parallel/ddp.py::wrap`), on this rank's half of each global batch,
recording the metrics and, after each step, the model's state and the
optimizer's consolidated state (`TrainState.consolidate` +
`state_dict`, on rank 0):

- `zero`: ZeRO-1 on (`ZeroRedundancyOptimizer` over the same groups),
  the f32 wire; then its checkpoint written through
  `CheckpointManager(async_save=True)` (OUT_DIR/zero/ckpt_e0.pt), read
  back on every rank into a fresh state with ZeRO-1 off, and one more
  step taken by both (`resumed_off`, `continued`);
- `replicated`: the same with ZeRO-1 off, its checkpoint
  (OUT_DIR/replicated/ckpt_e0.pt) read back into a fresh ZeRO-1 state
  (`replicated_into_zero`);
- `arcface_zero` / `arcface_replicated`: the arcface head with its own
  head group (`head_lr`, Adam), ZeRO-1 on and off;
- `bf16`: the bf16 wire (`grad_reduce_dtype=bfloat16`), ZeRO-1 on;
- `accum`: `grad_accum` 2, the f32 wire, ZeRO-1 on: one all-reduce a
  step through `no_sync()`;
- `plain` / `remat`: ZeRO-1 on, the f32 wire, each block of the ResNet
  plain or rematerialized (`--remat`: the backward recomputes it, its
  BNs' all-reduces with it).

Imports torch, numpy and the port only (no JAX), so a rank starts fast.
"""

import os
import sys

import torch


def _half(t: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def _cfg(data, head="fc", **parallel):
    from ddp_classification_pytorch_tpu_torch.config import get_preset

    cfg = get_preset("arcface" if head == "arcface" else "baseline")
    cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
    cfg.data.num_classes = 10
    for k, v in data["optim"].items():
        setattr(cfg.optim, k, v)
    if head == "arcface":
        cfg.optim.optimizer, cfg.optim.head_lr = "adam", data["head_lr"]
        cfg.model.arc_embed_dim = 256
    for k, v in parallel.items():
        setattr(cfg.parallel, k, v)
    return cfg


def _model(head, group, remat=False):
    """tests/torch_port_heads.py's reduced ResNet-50 under `head` (fc or
    arcface), its BNs over `group`."""
    from ddp_classification_pytorch_tpu_torch.models import factory, heads, resnet

    backbone = resnet.ResNet(
        block_cls=resnet.Bottleneck, dtype=torch.float32, group=group,
        num_classes=10 if head == "fc" else 0, stage_sizes=(1, 1, 1, 1),
        num_filters=8, remat=remat)
    if head == "fc":
        return factory.ClassifierModel(backbone)
    return factory.ArcFaceModel(backbone, heads.ArcEmbedding(256, (512, 256)),
                                heads.ArcMarginHead(10, 256, 30.0, 0.5, True))


def _state(data, cfg, head="fc"):
    """A fresh train state of the reduced ResNet-50 (under `head`) from
    the input weights, DDP-wrapped, ZeRO-1 as `cfg` says."""
    from ddp_classification_pytorch_tpu_torch.parallel import ddp
    from ddp_classification_pytorch_tpu_torch.train import schedule
    from ddp_classification_pytorch_tpu_torch.train.state import TrainState

    model = _model(head, ddp.group(), cfg.model.remat)
    model.load_state_dict(data[f"{head}_state_dict"])
    model.to(memory_format=torch.channels_last)
    o = cfg.optim
    zero = schedule.zero_enabled(cfg.parallel.zero_opt, ddp.world_size())
    state = TrainState(
        model, schedule.build_optimizer(
            o, schedule.param_groups(o, model, cfg.model.freeze_bn),
            zero=zero),
        schedule.build_schedule(o, 1, cfg.parallel.grad_accum),
        head_schedule=(schedule.build_schedule(schedule.head_config(o), 1)
                       if schedule.two_groups(o) else None))
    state.ddp = ddp.wrap(model, torch.device("cpu"),
                         cfg.parallel.grad_reduce_dtype)
    assert schedule.is_zero(state.optimizer) == zero
    return state


def _snapshot(state):
    """The model's state and (on rank 0) the consolidated optimizer
    state, as copies; every rank takes part in the consolidation."""
    from ddp_classification_pytorch_tpu_torch.parallel import ddp
    from ddp_classification_pytorch_tpu_torch.train.checkpoint import _host_copy

    state.consolidate()
    return {"model": _host_copy(state.model.state_dict()),
            "optimizer": (_host_copy(state.optimizer_state_dict())
                          if ddp.is_primary() else None),
            "step": state.step, "opt_count": state.opt_count}


def _steps(state, step, batches, rank, world):
    out = {"metrics": [], "states": []}
    for images, labels in batches:
        m = step(state, _half(images, rank, world), _half(labels, rank, world))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(_snapshot(state))
    return out


def run(data, case, rank, world, out_dir):
    from ddp_classification_pytorch_tpu_torch.parallel import ddp
    from ddp_classification_pytorch_tpu_torch.train.checkpoint import (
        CheckpointManager)
    from ddp_classification_pytorch_tpu_torch.train.steps import make_train_step

    head = "arcface" if case.startswith("arcface") else "fc"
    parallel = {"zero_opt": "off" if case.endswith("replicated") else "on"}
    if case == "bf16":
        parallel["grad_reduce_dtype"] = "bfloat16"
    if case == "accum":
        parallel["grad_accum"] = 2
    cfg = _cfg(data, head, **parallel)
    cfg.model.remat = case == "remat"
    state = _state(data, cfg, head)
    step = make_train_step(cfg)
    batches = data["accum_batches" if case == "accum" else "batches"]
    out = _steps(state, step, batches[:2], rank, world)
    if case not in ("zero", "replicated"):
        return out
    # the checkpoint of this run, read back under the other ZeRO setting,
    # and one more step of both
    ckpt = CheckpointManager(os.path.join(out_dir, case), async_save=True)
    ckpt.save(state, 0)
    ckpt.wait()  # rank 0's write lands before any rank reads it
    ddp.barrier()
    other = _cfg(data, head, zero_opt="off" if case == "zero" else "on")
    fresh = _state(data, other, head)
    ckpt.restore(fresh, ckpt.epoch_path(0))
    key = "resumed_off" if case == "zero" else "replicated_into_zero"
    out[key] = _steps(fresh, make_train_step(other), batches[2:3], rank, world)
    out["continued"] = _steps(state, step, batches[2:3], rank, world)
    return out


def main() -> None:
    from ddp_classification_pytorch_tpu_torch.parallel import ddp

    torch.set_num_threads(1)
    inp, out_dir = sys.argv[1:3]
    data = torch.load(inp, weights_only=True)
    with ddp.process_group(torch.device("cpu")):
        rank, world = ddp.rank(), ddp.world_size()
        result = {case: run(data, case, rank, world, out_dir)
                  for case in data["cases"]}
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
