"""One rank of the model axis's four-rank tests
(tests/test_torch_port_ring.py, tests/test_torch_port_model_axis.py): a
gloo process group on the CPU joined from torchrun's environment
variables, as tests/torch_port_scale_worker.py joins it.

    python tests/torch_port_model_axis_worker.py IN.pt OUT_DIR

IN.pt holds the inputs of every case and `cases`: "ring" runs the ring
alone, "model" everything else; each rank writes OUT_DIR/rank<R>.pt.
The meshes, made in this order on every rank (`parallel/mesh.py`):
`m22` data 2 × model 2 (model groups {0, 1}, {2, 3}), `m14` data 1 ×
model 4, and `m12`, the model groups of `m22` alone (two data-1 × model-2
meshes side by side). The cases:

- `ring`: `ring_attention` over m22's and m14's model groups, causal or
  not, the einsum and the flash bodies: this rank's output shard and the
  gradients of its q, k, v shards under the output cotangent `do`;
- `ep`: `moe_mlp` over the same groups, this rank's expert slice: the
  output and the gradients of x, the gates and its bank slices;
- `ce`: `arc_margin_ce_sharded` over m22 (batch group the data group) and
  m14, with the margin (train) and with m 0 and a `valid` mask (eval):
  loss, counts and the gradients of this rank's features and weight
  shard;
- `vit` on m12's first pair and `moe` on its second, then `vit22` and
  `arcface` over m22: two train steps of the port's step
  (`train/steps.py::make_train_step`) from the whole weights given, each
  step's metrics and then the whole state gathered (`consolidate` +
  `state_dict`, on the mesh's first rank);
- `ckpt`: the `vit` pair's state written by `CheckpointManager` (async),
  then read back at data 2 × model 1 (m22's data groups, ZeRO-1 on) and
  at data 2 × model 2, each rank's tensors recorded;
- `cdr`: CDR's mask on the `vit` pair's state (its fc class-sharded)
  over seeded gradients, gathered whole.

The reduced ViT is `vit_t16` with its config patched to depth 2, width
64, 2 heads (the JAX side patches its own). Imports torch, numpy and the
port only (no JAX).
"""

import os
import sys

import torch
import torch.distributed as dist

REDUCED_VIT = (16, 64, 2, 2)


def _cfg(data, workload, **model):
    from ddp_classification_pytorch_tpu_torch.config import get_preset

    cfg = get_preset(workload)
    cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
    cfg.data.image_size, cfg.data.num_classes = data["image"], data["classes"]
    for k, v in data["optim"].items():
        setattr(cfg.optim, k, v)
    for k, v in model.items():
        setattr(cfg.model, k, v)
    cfg.model.dtype = "float32"
    return cfg


def _state(cfg, model, mesh, data_group, whole):
    """A train state of `model` from the whole weights `whole`, sharded
    over `mesh`, ZeRO-1 over `data_group` where it has two ranks, under
    DDP over it."""
    from ddp_classification_pytorch_tpu_torch.models import factory
    from ddp_classification_pytorch_tpu_torch.parallel import ddp
    from ddp_classification_pytorch_tpu_torch.train import schedule
    from ddp_classification_pytorch_tpu_torch.train.state import TrainState

    model.load_state_dict(whole)
    dims = factory.shard_params_(model, mesh)
    o = cfg.optim
    dp = dist.get_world_size(data_group) if data_group is not None else 1
    state = TrainState(
        model, schedule.build_optimizer(
            o, schedule.param_groups(o, model, cfg.model.freeze_bn),
            zero=schedule.zero_enabled(cfg.parallel.zero_opt, dp),
            group=data_group),
        schedule.build_schedule(o, 1), mesh=mesh, shard_dims=dims)
    if dp > 1:
        state.ddp = ddp.wrap(model, torch.device("cpu"), group=data_group)
    return state


def _steps(cfg, state, batches, record):
    """Two train steps on this data shard's rows; metrics, then the whole
    state (on the mesh's data-0 ranks)."""
    from ddp_classification_pytorch_tpu_torch.train import steps

    mesh = state.mesh
    step = steps.make_train_step(cfg, mesh=mesh)
    out = []
    for images, labels in batches:
        n = images.shape[0] // mesh.dp
        rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
        m = step(state, images[rows], labels[rows])
        state.consolidate()
        whole = state.state_dict() if mesh.data_index == 0 else None
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.clone() for k, v in whole["model"].items()}
                    if whole else None))
    if record:
        return out
    return None


def _ring(data, meshes):
    from ddp_classification_pytorch_tpu_torch.ops.attention import (
        ring_attention,
        shard_tokens,
    )

    q, k, v, do = data["ring"]
    res = {}
    for name, mesh in meshes.items():
        g = mesh.model_group
        for causal in (False, True):
            for flash in (False, True):
                xs = [shard_tokens(t, g).clone().requires_grad_()
                      for t in (q, k, v)]
                out = ring_attention(*xs, g, causal=causal, use_flash=flash)
                out.backward(shard_tokens(do, g))
                res[(name, causal, flash)] = (
                    out.detach(), *[x.grad for x in xs])
    return res


def _ep(data, meshes):
    from ddp_classification_pytorch_tpu_torch.ops.moe import moe_mlp

    x, gates, banks, gout = data["ep"]
    res = {}
    for name, mesh in meshes.items():
        n, i = mesh.mp, mesh.model_index
        xs = x.clone().requires_grad_()
        gs = gates.clone().requires_grad_()
        local = [b.chunk(n)[i].clone().requires_grad_() for b in banks]
        out = moe_mlp(xs, gs, *local, dtype=torch.float32,
                      group=mesh.model_group)
        out.backward(gout)
        res[name] = (out.detach(), xs.grad, gs.grad,
                     [b.grad for b in local])
    return res


def _ce(data, meshes):
    from ddp_classification_pytorch_tpu_torch.ops.sharded_head import (
        arc_margin_ce_sharded,
    )

    feats, weight, labels, valid = data["ce"]
    res = {}
    for name, mesh in meshes.items():
        bl = feats.shape[0] // mesh.dp
        rows = slice(mesh.data_index * bl, (mesh.data_index + 1) * bl)
        for mode, m, vmask in (("train", 0.5, None), ("eval", 0.0, valid)):
            f = feats[rows].clone().requires_grad_()
            w = weight.chunk(mesh.mp)[mesh.model_index].clone()
            w.requires_grad_()
            loss, t1, t3 = arc_margin_ce_sharded(
                f, w, labels[rows], mesh.model_group, mesh.data_group,
                s=30.0, m=m, easy_margin=False,
                valid=None if vmask is None else vmask[rows])
            loss.backward()
            res[(name, mode)] = (loss.detach(), t1, t3, f.grad, w.grad)
    return res


def _cdr(state):
    """CDR's mask (`train/steps.py::_cdr_mask`) over the ViT pair's state
    with seeded whole gradients (N(0, 1), in parameter order, each rank
    keeping its shard of the class-sharded fc's): every masked gradient,
    gathered whole."""
    from ddp_classification_pytorch_tpu_torch.parallel.collectives import (
        all_gather,
    )
    from ddp_classification_pytorch_tpu_torch.train import steps

    mesh, gen = state.mesh, torch.Generator().manual_seed(77)
    for name, p in state.model.named_parameters():
        dim = state.shard_dims.get(name)
        shape = list(p.shape)
        if dim is not None:
            shape[dim] *= mesh.mp
        g = torch.randn(shape, generator=gen)
        if dim is not None:
            n = p.shape[dim]
            g = g.narrow(dim, mesh.model_index * n, n).clone()
        p.grad = g
    steps._cdr_mask(state, list(state.model.parameters()), 0.8, 0.8)
    return {name: all_gather(p.grad, mesh.model_group, state.shard_dims[name])
            if name in state.shard_dims else p.grad.clone()
            for name, p in state.model.named_parameters()}


def _arcface_model(group, classes):
    """tests/torch_port_heads.py's reduced ResNet-50 under the arcface
    head (easy margin), its BNs over `group`."""
    from ddp_classification_pytorch_tpu_torch.models import factory, heads, resnet

    backbone = resnet.ResNet(
        block_cls=resnet.Bottleneck, dtype=torch.float32, group=group,
        num_classes=0, stage_sizes=(1, 1, 1, 1), num_filters=8)
    return factory.ArcFaceModel(backbone, heads.ArcEmbedding(256, (512, 256)),
                                heads.ArcMarginHead(classes, 256, 30.0, 0.5,
                                                    True))


def main(inp, out):
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world)
    from ddp_classification_pytorch_tpu_torch.models import factory, vit
    from ddp_classification_pytorch_tpu_torch.parallel import mesh as M
    from ddp_classification_pytorch_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )

    data = torch.load(inp, weights_only=False)
    vit.VIT_CONFIGS["vit_t16"] = REDUCED_VIT
    m22 = M.make_mesh(M.MeshSpec(2, 2))
    m14 = M.make_mesh(M.MeshSpec(1, 4))
    m12 = M.Mesh(1, 2, 0, m22.model_index, None, m22.model_group)
    meshes = {"m22": m22, "m14": m14}
    if data["cases"] == "ring":
        torch.save({"ring": _ring(data, meshes)},
                   os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
        return
    res = {"ep": _ep(data, meshes), "ce": _ce(data, meshes)}

    image, classes = data["image"], data["classes"]
    pair = rank // 2
    if pair == 0:  # the ViT, tokens over the pair
        cfg = _cfg(data, "baseline", arch="vit_t16")
        model = factory.build_model(cfg.model, classes, image, None, m12)
        state = _state(cfg, model, m12, None, data["vit"])
    else:  # the MoE ViT, experts over the pair
        cfg = _cfg(data, "baseline", arch="vit_t16", moe_experts=4,
                   moe_top_k=2, moe_aux_weight=0.01)
        model = factory.build_model(cfg.model, classes, image, None, m12)
        state = _state(cfg, model, m12, None, data["moe"])
    res["vit" if pair == 0 else "moe"] = _steps(
        cfg, state, data["batches"], rank % 2 == 0)
    # every rank saves (consolidate is a collective of each pair's model
    # group); rank 0, primary, writes the ViT pair's whole state
    ckpt = CheckpointManager(os.path.join(out, "ckpt"), async_save=True)
    ckpt.save(state, 0)
    ckpt.wait()
    dist.barrier()
    if pair == 0:
        res["cdr"] = _cdr(state)

    cfg = _cfg(data, "baseline", arch="vit_t16")
    model = factory.build_model(cfg.model, classes, image, m22.data_group,
                                m22)
    state = _state(cfg, model, m22, m22.data_group, data["vit"])
    res["vit22"] = _steps(cfg, state, data["batches"], rank == 0)

    jcfg = _cfg(data, "arcface")
    jcfg.model.arc_embed_dim = 256
    jcfg.model.arc_easy_margin = True
    jcfg.parallel.arcface_sharded_ce = True
    model = factory.class_shard_(_arcface_model(m22.data_group, classes), m22)
    model.to(memory_format=torch.channels_last)
    state = _state(jcfg, model, m22, m22.data_group, data["arcface"])
    res["arcface"] = _steps(jcfg, state, data["arcface_batches"], rank == 0)

    # the checkpoint read back at data 2 × model 1 and data 2 × model 2
    path = os.path.join(out, "ckpt", "ckpt_e0.pt")
    whole = torch.load(path, weights_only=True)
    for name, mesh in (("dp2", None), ("dp2mp2", m22)):
        model = factory.build_model(cfg.model, classes, image,
                                    m22.data_group, mesh)
        st = _state(cfg, model, mesh, m22.data_group, whole["model"])
        st.load_state_dict(whole)
        st.consolidate()
        res[f"resume_{name}"] = (
            {k: v.clone() for k, v in st.model.state_dict().items()},
            st.optimizer_state_dict() if (mesh is None and rank < 2)
            else None)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
