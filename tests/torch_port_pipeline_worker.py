"""One rank of the GPipe tests' four-rank runs
(tests/test_torch_port_pipeline.py, tests/test_torch_port_three_axis.py):
a gloo process group on the CPU joined from torchrun's environment
variables, as tests/torch_port_model_axis_worker.py joins it.

    python tests/torch_port_pipeline_worker.py IN.pt OUT_DIR

IN.pt holds the inputs and `cases`: "pipe" or "three"; each rank writes
OUT_DIR/rank<R>.pt. "pipe" makes, in this order on every rank
(`parallel/mesh.py`), the meshes `p2` data 2 × pipe 2 (pipe groups {0,
1}, {2, 3}), `p4` pipe 4 and `m2` data 2 × model 2 (the 2-axis layout,
the stages on the model groups {0, 1}, {2, 3}); its cases:

- `exec`: `gpipe` of the toy stack (depth 8) over p2's and p4's pipe
  groups at (S, M) = (2, 2) and (4, 4), the whole batch on every rank:
  the output, the gradients of mean(out²) w.r.t. this stage's blocks and
  the input, the no-grad output, and the refusal of a 6-row batch at
  M 4 over 2 shards;
- `fwd`: the reduced `GPipeViT` (depth 4, width 64, 2 heads, 64 px) in
  eval over p2's and p4's pipe groups: the logits;
- `pp` and `cdr` on p2, `mp` on m2: two train steps of the port's step
  (baseline, and cdr on p2) from the whole weights given, each data
  shard its rows, DDP and ZeRO-1 over the data group; each step's
  metrics and then the whole state gathered on rank 0.

"three" runs the CLI twice first (`cli/train.py arcface --mp 2
--pp_stages 2 --pp_microbatches 2 --sharded_ce`, an epoch, then
`--auto_resume --epochs 2`), each on its own port, then joins a group of
its own and makes `t3`, the (data 1, model 2, pipe 2) mesh: `arc`, three
arcface `--sharded_ce` steps from the whole weights given; `scores`,
`GPipeArcFaceViT`'s labels=None scores and its embedding; `resume`, a
Trainer over the CLI's run dir with `--auto_resume` (epochs 3): where it
starts, this rank's block keys and margin shard as restored, and one
more epoch. The reduced ViTs patch `vit_t16`'s config (the JAX side
patches its own). Imports torch, numpy and the port only (no JAX).
"""

import os
import sys

import torch
import torch.distributed as dist

PIPE_VIT = (16, 64, 4, 2)


def _cfg(data, workload, **parallel):
    from ddp_classification_pytorch_tpu_torch.config import get_preset

    cfg = get_preset(workload)
    cfg.data.dataset, cfg.data.input_dtype = "synthetic", "float32"
    cfg.data.image_size, cfg.data.num_classes = data["image"], data["classes"]
    for k, v in data["optim"].items():
        setattr(cfg.optim, k, v)
    cfg.model.arch, cfg.model.dtype, cfg.model.dropout = "vit_t16", "float32", 0.0
    cfg.model.arc_embed_dim = 64
    cfg.parallel.pipeline_microbatches = data["micro"]
    for k, v in parallel.items():
        setattr(cfg.parallel, k, v)
    return cfg


def _state(cfg, mesh, whole):
    """A train state of the pipelined model from the whole weights
    `whole`: this stage's blocks and class shards, ZeRO-1 and DDP over
    the data group where it has two ranks."""
    from ddp_classification_pytorch_tpu_torch.models import factory
    from ddp_classification_pytorch_tpu_torch.parallel import ddp
    from ddp_classification_pytorch_tpu_torch.train import schedule
    from ddp_classification_pytorch_tpu_torch.train.state import TrainState

    model = factory.build_model(cfg.model, cfg.data.num_classes,
                                cfg.data.image_size, mesh.data_group, mesh,
                                cfg.parallel.pipeline_microbatches)
    model.load_state_dict(whole)
    dims = factory.shard_params_(model, mesh)
    o = cfg.optim
    dp = mesh.dp
    state = TrainState(
        model, schedule.build_optimizer(
            o, schedule.param_groups(o, model, cfg.model.freeze_bn),
            zero=schedule.zero_enabled(cfg.parallel.zero_opt, dp),
            group=mesh.data_group),
        schedule.build_schedule(o, 1), mesh=mesh, shard_dims=dims)
    if dp > 1:
        state.ddp = ddp.wrap(model, torch.device("cpu"), group=mesh.data_group)
    return state


def _steps(cfg, state, batches, record):
    """Train steps on this data shard's rows; metrics, then the whole
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
    return out if record else None


class _Toy(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w, self.b = torch.nn.Parameter(w), torch.nn.Parameter(b)


def _toy_fn(block, h):
    return torch.nn.functional.gelu(h @ block.w + block.b, approximate="tanh")


def _exec(data, meshes):
    from ddp_classification_pytorch_tpu_torch.ops.pipeline import gpipe
    from ddp_classification_pytorch_tpu_torch.parallel.mesh import block_stage

    w, b, x, x6 = data["toy"]
    res = {}
    for (s, m), name in (((2, 2), "p2"), ((4, 4), "p4")):
        mesh = meshes[name]
        own = [i for i in range(w.shape[0])
               if block_stage(i, w.shape[0], s) == mesh.pipe_index]
        blocks = [_Toy(w[i].clone(), b[i].clone()) for i in own]
        xs = x.clone().requires_grad_()
        out = gpipe(_toy_fn, blocks, xs, mesh.pipe_group, m)
        (out ** 2).mean().backward()
        with torch.no_grad():
            plain = gpipe(_toy_fn, blocks, x, mesh.pipe_group, m)
        try:
            gpipe(_toy_fn, blocks, x6, mesh.pipe_group, 4, shards=2)
            refusal = None
        except ValueError as e:
            refusal = str(e)
        res[(s, m)] = dict(out=out.detach(), plain=plain, own=own,
                           dw=[blk.w.grad for blk in blocks],
                           db=[blk.b.grad for blk in blocks], dx=xs.grad,
                           refusal=refusal)
    return res


def _fwd(data, meshes):
    from ddp_classification_pytorch_tpu_torch.models import factory

    cfg = _cfg(data, "baseline")
    images = data["batches"][0][0]
    res = {}
    for name in ("p2", "p4"):
        mesh = meshes[name]
        model = factory.build_model(cfg.model, data["classes"], data["image"],
                                    None, mesh, data["micro"])
        model.load_state_dict(data["vit"])
        factory.shard_params_(model, mesh)
        with torch.no_grad():
            res[name] = model.eval()(images.permute(0, 3, 1, 2))
    return res


def _pipe(data, rank):
    from ddp_classification_pytorch_tpu_torch.parallel import mesh as M

    p2 = M.make_mesh(M.MeshSpec(2, 1, 2))
    p4 = M.make_mesh(M.MeshSpec(1, 1, 4))
    m2 = M.make_mesh(M.MeshSpec(2, 2))
    meshes = {"p2": p2, "p4": p4}
    res = {"exec": _exec(data, meshes), "fwd": _fwd(data, meshes),
           "coords": (p2.data_index, p2.pipe_index, m2.data_index,
                      m2.model_index)}
    for case, workload, mesh, par in (
            ("pp", "baseline", p2, dict(pipeline_stages=2)),
            ("cdr", "cdr", p2, dict(pipeline_stages=2)),
            ("mp", "baseline", m2, dict(model_axis=2))):
        cfg = _cfg(data, workload, **par)
        state = _state(cfg, mesh, data["vit"])
        res[case] = _steps(cfg, state, data["batches"], rank == 0)
    return res


def _argv(data, out):
    return ["arcface", "--dataset", "synthetic", "--synthetic_size", "32",
            "--model", "vit_t16", "--image_size", str(data["image"]),
            "--num_classes", str(data["classes"]), "--batchsize", "8",
            "--dtype", "float32", "--device", "cpu", "--mp", "2",
            "--pp_stages", "2", "--pp_microbatches", "2", "--sharded_ce",
            "--num_workers", "1", "--log_every", "1", "--out", out]


def _cli(data, out, port, extra):
    from ddp_classification_pytorch_tpu_torch.cli import train as cli

    os.environ["MASTER_PORT"] = str(port)
    try:
        cli.main(_argv(data, out) + extra)
        return 0
    except SystemExit as e:
        return e.code


def _three(data, out, rank):
    from ddp_classification_pytorch_tpu_torch.models.pipeline_vit import gpipe_vit
    from ddp_classification_pytorch_tpu_torch.parallel import mesh as M
    from ddp_classification_pytorch_tpu_torch.train.loop import Trainer

    ports = data["ports"]
    run = os.path.join(out, "run")
    res = {"cli": [_cli(data, run, ports[0], ["--epochs", "1"]),
                   _cli(data, run, ports[1], ["--epochs", "2",
                                               "--auto_resume"])]}
    from ddp_classification_pytorch_tpu_torch.parallel import ddp

    # the world group and the fleet's control group, as the CLI joins them
    ddp.init_group(torch.device("cpu"), f"tcp://127.0.0.1:{ports[2]}",
                   int(os.environ["WORLD_SIZE"]), rank)
    t3 = M.make_mesh(M.MeshSpec(1, 2, 2))
    res["coords"] = (t3.model_index, t3.pipe_index)
    par = dict(model_axis=2, pipeline_stages=2, arcface_sharded_ce=True)
    cfg = _cfg(data, "arcface", **par)
    cfg.model.arc_easy_margin = True
    state = _state(cfg, t3, data["arcface"])
    res["arc"] = _steps(cfg, state, data["batches"], rank == 0)

    model = _state(cfg, t3, data["arcface"]).model.eval()
    x = data["batches"][0][0].permute(0, 3, 1, 2)
    with torch.no_grad():
        res["scores"] = (model(x), model.features(x))

    from ddp_classification_pytorch_tpu_torch.cli import train as cli

    cfg = cli.config_from_args(cli.build_parser().parse_args(
        _argv(data, run) + ["--epochs", "3", "--auto_resume"]))
    cfg.run.write_records = False
    tr = Trainer(cfg, torch.device("cpu"))
    pipe = gpipe_vit(tr.state.model)
    res["resume"] = dict(
        start_epoch=tr.start_epoch, step=tr.state.step, mesh=tr.mesh.shape,
        blocks=sorted(pipe.blocks, key=int),
        margin=tr.state.model.margin.weight.detach().clone(),
        patch=pipe.patch.weight.detach().clone())
    m = tr.train_epoch(tr.start_epoch)
    res["resume"].update(after=tr.state.step, loss=m["loss"],
                         eval=tr.evaluate())
    tr._close()
    return res


def main(inp, out):
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    from ddp_classification_pytorch_tpu_torch.models import vit

    data = torch.load(inp, weights_only=False)
    vit.VIT_CONFIGS["vit_t16"] = PIPE_VIT
    if data["cases"] == "pipe":
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=int(os.environ["WORLD_SIZE"]))
        res = _pipe(data, rank)
    else:
        res = _three(data, out, rank)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
