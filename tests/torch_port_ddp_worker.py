"""One rank of tests/test_torch_port_ddp.py: a gloo process group on the
CPU, joined from torchrun's environment variables (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) as the port's CLI joins it.

    python tests/torch_port_ddp_worker.py IN.pt OUT_DIR
    python tests/torch_port_ddp_worker.py --cli ARGS...

IN.pt holds the inputs (tensors and plain values); each rank writes its
results to OUT_DIR/rank<R>.pt:

- `bn`: the port's BatchNorm with the world group on this rank's half of
  a batch: y and dx of its half, dγ and dβ summed over the ranks (the
  global batch's), the running statistics;
- `steps`: the reduced ResNet-50 under DistributedDataParallel, one train
  step per batch on this rank's half of it (metrics and the whole state
  after each), then `train/loop.py::eval_totals` over this rank's shard of
  a val set (the loader's wrap padding masked);
- `cdr` / `nested`: the same net under the cdr preset (the masked
  gradients and threshold of each step) and under the nested head with
  freeze-BN (the k of each step; first the per-K counts of the all-K eval
  over this rank's shard of the val set, summed across the ranks, and
  `nested_eval`'s result), two train steps each, the state after them;
- `plc`: a `PLCTrainer` over the reduced ResNet-50 (its fc state) on the
  val set as the train set: the ordered pass's logits gathered from the
  ranks, then one LRT correction: the labels, δ and the count.

With `--cli`, the rank runs the port's train CLI (`cli/train.py`'s
`main`) on ARGS instead and exits with its rc.

Imports torch, numpy and the port only (no JAX), so a rank starts fast.
"""

import os
import sys

import numpy as np
import torch


class ArrayDataset:
    """Images and labels held in memory, in the loaders' item protocol."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        self.images, self.labels = images, labels

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i: int, rng=None):
        return self.images[i], int(self.labels[i])


def _half(t: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def run_bn(data, rank, world):
    from ddp_classification_pytorch_tpu_torch.models.batchnorm import BatchNorm
    from ddp_classification_pytorch_tpu_torch.parallel import ddp

    c = data["weight"].shape[0]
    bn = BatchNorm(c, process_group=ddp.group()).train()
    assert bn.synced()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(data[name])
    x = _half(data["x"], rank, world).permute(0, 3, 1, 2).requires_grad_()
    g = _half(data["g"], rank, world).permute(0, 3, 1, 2)
    y = bn(x)
    dx, dw, db = torch.autograd.grad(y, (x, bn.weight, bn.bias), g)
    return {"y": y.detach().permute(0, 2, 3, 1), "dx": dx.permute(0, 2, 3, 1),
            "dweight": ddp.sum_across(dw.clone()),
            "dbias": ddp.sum_across(db.clone()),
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def run_steps(data, rank, world):
    from ddp_classification_pytorch_tpu_torch.config import get_preset
    from ddp_classification_pytorch_tpu_torch.data.loader import Loader
    from ddp_classification_pytorch_tpu_torch.models import resnet
    from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel
    from ddp_classification_pytorch_tpu_torch.parallel import ddp
    from ddp_classification_pytorch_tpu_torch.train import schedule
    from ddp_classification_pytorch_tpu_torch.train.loop import eval_totals
    from ddp_classification_pytorch_tpu_torch.train.state import TrainState
    from ddp_classification_pytorch_tpu_torch.train.steps import (
        make_eval_step, make_train_step)

    cfg = get_preset("baseline")
    cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
    cfg.data.num_classes = 10
    for k, v in data["optim"].items():
        setattr(cfg.optim, k, v)
    model = ClassifierModel(resnet.ResNet(
        block_cls=resnet.Bottleneck, dtype=torch.float32, group=ddp.group(),
        **data["reduced"]))
    model.backbone.load_state_dict(data["state_dict"])
    model.to(memory_format=torch.channels_last)
    device = torch.device("cpu")
    state = TrainState(model, schedule.build_optimizer(cfg.optim,
                                                       model.parameters()),
                       schedule.build_schedule(cfg.optim, 1),
                       ddp=ddp.wrap(model, device))
    step = make_train_step(cfg)
    out = {"metrics": [], "states": []}
    for images, labels in data["batches"]:
        m = step(state, _half(images, rank, world), _half(labels, rank, world))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append({
            "model": {k: v.clone() for k, v in model.backbone.state_dict().items()},
            "momentum": [state.optimizer.state[p]["momentum_buffer"].clone()
                         for p in state.params],
            "step": state.step, "opt_count": state.opt_count})
    ds = ArrayDataset(data["val_images"].numpy(), data["val_labels"].numpy())
    loader = Loader(ds, data["val_batch"], shuffle=False, host_id=rank,
                    num_hosts=world)
    batches = [(torch.from_numpy(im), torch.from_numpy(lb),
                torch.from_numpy(loader.valid_mask(k)))
               for k, (im, lb) in enumerate(loader)]
    out["eval_batches"] = len(batches)
    out["eval"] = eval_totals(state, make_eval_step(cfg), batches)
    return out


def run_heads(data, head, rank, world):
    """Two steps of the cdr preset (head fc) or of the nested preset under
    DDP, recording what every rank must agree on."""
    from ddp_classification_pytorch_tpu_torch.config import get_preset
    from ddp_classification_pytorch_tpu_torch.data.loader import Loader
    from ddp_classification_pytorch_tpu_torch.models import factory, heads, resnet
    from ddp_classification_pytorch_tpu_torch.parallel import ddp
    from ddp_classification_pytorch_tpu_torch.train import schedule, steps
    from ddp_classification_pytorch_tpu_torch.train.loop import nested_eval
    from ddp_classification_pytorch_tpu_torch.train.state import TrainState

    workload = "cdr" if head == "fc" else "nested"
    cfg = get_preset(workload)
    cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
    cfg.data.num_classes = 10
    for k, v in data["optim"].items():
        setattr(cfg.optim, k, v)
    stages = {k: v for k, v in data["reduced"].items() if k != "num_classes"}
    backbone = resnet.ResNet(
        block_cls=resnet.Bottleneck, dtype=torch.float32, group=ddp.group(),
        num_classes=10 if head == "fc" else 0, freeze_bn=cfg.model.freeze_bn,
        **stages)
    model = (factory.ClassifierModel(backbone) if head == "fc" else
             factory.NestedModel(backbone, heads.NetClassifier(
                 backbone.num_features, 10)))
    model.load_state_dict(data[f"{head}_state_dict"])
    model.to(memory_format=torch.channels_last)
    device = torch.device("cpu")
    state = TrainState(model, schedule.build_optimizer(
        cfg.optim, schedule.param_groups(cfg.optim, model,
                                         cfg.model.freeze_bn)),
        schedule.build_schedule(cfg.optim, 1), ddp=ddp.wrap(model, device))
    out = {"masks": [], "ks": []}
    if head == "nested":
        ds = ArrayDataset(data["val_images"].numpy(), data["val_labels"].numpy())
        loader = Loader(ds, data["val_batch"], shuffle=False, host_id=rank,
                        num_hosts=world)
        batches = [(torch.from_numpy(im), torch.from_numpy(lb),
                    torch.from_numpy(loader.valid_mask(k)))
                   for k, (im, lb) in enumerate(loader)]
        estep = steps.make_nested_eval_step(cfg)
        counts = [estep(state, *b) for b in batches]
        out["counts"] = {key: ddp.sum_across(sum(c[key] for c in counts))
                         for key in ("top1_k", "top3_k", "n")}
        out["eval"] = nested_eval(state, estep, batches)
    real_mask, real_k = steps.cdr_mask_, steps.nested_k

    def mask(pairs, ratio, clip):
        thresh = real_mask(pairs, ratio, clip)
        out["masks"].append((thresh.clone(), [g.clone() for _, g in pairs]))
        return thresh

    def draw(*args):
        out["ks"].append(real_k(*args))
        return out["ks"][-1]

    steps.cdr_mask_, steps.nested_k = mask, draw
    try:
        step = steps.make_train_step(cfg)
        out["metrics"] = [
            {k: float(v) for k, v in step(state, _half(images, rank, world),
                                          _half(labels, rank, world)).items()}
            for images, labels in data["batches"][:2]]
    finally:
        steps.cdr_mask_, steps.nested_k = real_mask, real_k
    out["model"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["step"], out["opt_count"] = state.step, state.opt_count
    return out


def run_plc(data, rank, world):
    from ddp_classification_pytorch_tpu_torch.models import factory, resnet
    from ddp_classification_pytorch_tpu_torch.parallel import ddp
    from ddp_classification_pytorch_tpu_torch.train import loop, schedule
    from ddp_classification_pytorch_tpu_torch.train.plc_loop import PLCTrainer
    from ddp_classification_pytorch_tpu_torch.train.state import TrainState

    cfg = plc_config(data, data["val_batch"])
    cfg.run.out_dir = os.path.join(data["out"], f"plc{rank}")

    def state(*args, **kw):
        model = factory.ClassifierModel(resnet.ResNet(
            block_cls=resnet.Bottleneck, dtype=torch.float32,
            group=ddp.group(), **data["reduced"]))
        model.load_state_dict(data["fc_state_dict"])
        model.to(memory_format=torch.channels_last)
        return TrainState(model, schedule.build_optimizer(
            cfg.optim, model.parameters()), schedule.build_schedule(cfg.optim, 1))

    loop.create_train_state = state
    ds = ArrayDataset(data["val_images"].numpy(), data["val_labels"].numpy())
    trainer = PLCTrainer(cfg, torch.device("cpu"), ds, ds)
    logits = torch.from_numpy(trainer.predict_train_logits())
    changed = trainer.correct_labels()
    return {"logits": logits, "labels": torch.from_numpy(ds.labels.copy()),
            "delta": trainer.delta, "changed": changed}


def plc_config(data, batch):
    """The plc preset at the reduced net's sizes (no records written)."""
    from ddp_classification_pytorch_tpu_torch.config import get_preset

    cfg = get_preset("plc")
    cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
    cfg.data.num_classes, cfg.data.batch_size = 10, batch
    cfg.data.num_workers = 0
    cfg.run.write_records = False
    cfg.plc.current_delta = data["plc_delta"]
    return cfg


def main() -> None:
    from ddp_classification_pytorch_tpu_torch.parallel import ddp

    if sys.argv[1] == "--cli":
        from ddp_classification_pytorch_tpu_torch.cli import train

        train.main(sys.argv[2:])
        return
    inp, out_dir = sys.argv[1:3]
    data = torch.load(inp, weights_only=True)
    with ddp.process_group(torch.device("cpu")):
        rank, world = ddp.rank(), ddp.world_size()
        assert (rank, world) == ddp.env_world()[:2]
        result = {"bn": run_bn(data["bn"], rank, world),
                  "steps": run_steps(data["steps"], rank, world),
                  "cdr": run_heads(data["steps"], "fc", rank, world),
                  "nested": run_heads(data["steps"], "nested", rank, world),
                  "plc": run_plc(data["steps"], rank, world)}
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
