"""GPipe in the torch port — the executor (`ops/pipeline.py`), the
pipelined ViT (`models/pipeline_vit.py`) and its train steps — against the
JAX package on its 8-device CPU mesh, over four gloo ranks
(tests/torch_port_pipeline_worker.py, started once for the module), and
the CLI's pipeline flags against JAX's parser.

Tolerances: the executor in f32 within 1e-5 (its values and gradients,
against JAX's `gpipe` and against the sequential stack); the pipelined
ViT's forward within 1e-5 of JAX's f32 forward; the train steps at the
port's step parity tolerance (atol 1e-5 / rtol 1e-4, JAX in f64, as
tests/torch_port_steps.py holds the one-rank steps), every metric and
every parameter after each of two steps:

- `pp`: the reduced pipelined ViT (depth 4, width 64, 2 heads, 64 px: 16
  tokens) at data 2 × pipe 2 (`--pp_stages 2 --pp_microbatches 2`: two
  blocks a stage, DDP and ZeRO-1 over the data group);
- `cdr`: the same under the cdr workload (CDR's mask over the whole
  gradient, the blocks ranked as JAX's stacked leaves);
- `mp`: the 2-axis layout `--mp 2 --pp_microbatches 2` at data 2 × model
  2, the stages on the model group and the fc class-sharded over it, as
  JAX's (data, model) mesh shards both over `model`.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.cli import train as jax_cli
from ddp_classification_pytorch_tpu_torch.cli import train as port_cli
from ddp_classification_pytorch_tpu_torch.models import factory
from ddp_classification_pytorch_tpu_torch.models import vit as port_vit
from ddp_classification_pytorch_tpu_torch.models.pipeline_vit import GPipeViT
from ddp_classification_pytorch_tpu_torch.ops.pipeline import (
    check_batch,
    gpipe,
    gpipe_shards,
    stage_apply,
    ticks,
)
from ddp_classification_pytorch_tpu_torch.parallel import mesh as port_mesh

import torch_port_heads as H
import torch_port_model_axis as MA
import torch_port_pipeline as PP
from torch_port_threads import one_torch_thread  # noqa: F401

jax_pipe = importlib.import_module("ddp_classification_pytorch_tpu.ops.pipeline")

ATOL = 1e-5
METRICS = ("loss", "grad_norm", "top1", "top3", "step_ok")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return PP.ranks(tmp_path_factory, "pipe")


class _Toy(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w).clone())
        self.b = torch.nn.Parameter(torch.from_numpy(b).clone())


def _toy_fn(block, h):
    return torch.nn.functional.gelu(h @ block.w + block.b, approximate="tanh")


def _toy_blocks():
    w, b = PP.toy_params()
    return [_Toy(w[i], b[i]) for i in range(w.shape[0])]


def _sequential():
    """The toy stack in order: out and the gradients of mean(out²)."""
    blocks = _toy_blocks()
    x = torch.from_numpy(PP.toy_x()).requires_grad_()
    out = stage_apply(_toy_fn, blocks, x)
    (out ** 2).mean().backward()
    return (out.detach(), x.grad, torch.stack([b.w.grad for b in blocks]),
            torch.stack([b.b.grad for b in blocks]))


# ------------------------------------------------------------- executor --

@pytest.mark.parametrize("stages,micro", list(PP.EXEC))
def test_gpipe_over_gloo_ranks_matches_jax_and_sequential(run, stages,
                                                          micro):
    """Every rank gets JAX's output (and the sequential stack's); each
    stage's blocks get their slice of JAX's gradients, stage 0 the
    input's, the others zeros; the no-grad forward gives the same out."""
    ranks, _, _ = run
    want = PP.jax_toy(stages, micro)
    seq = _sequential()
    n = PP.TOY["depth"] // stages
    dp, _, pp = PP.EXEC[(stages, micro)]
    for r in range(4):
        got = ranks[r]["exec"][(stages, micro)]
        p = r % pp
        assert got["own"] == list(range(p * n, (p + 1) * n))
        for label, g in (("out", got["out"]), ("no-grad out", got["plain"])):
            np.testing.assert_allclose(g.numpy(), want[0], atol=ATOL,
                                       err_msg=f"{label} rank {r}")
            np.testing.assert_allclose(g.numpy(), seq[0].numpy(), atol=ATOL)
        np.testing.assert_allclose(torch.stack(got["dw"]).numpy(),
                                   want[2][p * n:(p + 1) * n], atol=ATOL)
        np.testing.assert_allclose(torch.stack(got["db"]).numpy(),
                                   want[3][p * n:(p + 1) * n], atol=ATOL)
        np.testing.assert_allclose(torch.stack(got["dw"]).numpy(),
                                   seq[2][p * n:(p + 1) * n].numpy(),
                                   atol=ATOL)
        dx = want[1] if p == 0 else np.zeros_like(want[1])
        np.testing.assert_allclose(got["dx"].numpy(), dx, atol=ATOL)


@pytest.mark.parametrize("stages,micro", list(PP.EXEC))
def test_gpipe_shards_in_one_process_match_jax(stages, micro):
    """`gpipe_shards` (the seam `chip_smoke.py` drives): JAX's output and
    gradients, M + S − 1 ticks."""
    want = PP.jax_toy(stages, micro)
    blocks = _toy_blocks()
    n = PP.TOY["depth"] // stages
    x = torch.from_numpy(PP.toy_x())
    out = stage_apply(_toy_fn, blocks, x)
    got = gpipe_shards(_toy_fn, [blocks[i * n:(i + 1) * n]
                                 for i in range(stages)], x, micro,
                       g_out=2 * out / out.numel())
    assert got.ticks == ticks(stages, micro) == micro + stages - 1
    np.testing.assert_allclose(got.out.numpy(), want[0], atol=ATOL)
    np.testing.assert_allclose(got.dx.numpy(), want[1], atol=ATOL)
    grads = [g for stage in got.grads for g in stage]
    np.testing.assert_allclose(torch.stack(grads[0::2]).numpy(), want[2],
                               atol=ATOL)
    np.testing.assert_allclose(torch.stack(grads[1::2]).numpy(), want[3],
                               atol=ATOL)


def test_single_stage_falls_back_to_the_sequential_stack():
    """A group of one runs the blocks in order and ignores M (JAX's S = 1
    fallback): a batch of 8 at M = 3 is not refused."""
    blocks = _toy_blocks()
    x = torch.from_numpy(PP.toy_x())
    jw, jb = PP.toy_params()
    mesh = PP.jax_mesh(8, 1)
    want = jax_pipe.gpipe(
        lambda p, h: jax.nn.gelu(h @ p["w"] + p["b"]),
        {"w": jnp.asarray(jw), "b": jnp.asarray(jb)}, jnp.asarray(PP.toy_x()),
        mesh=mesh, axis_name="model", microbatches=3)
    with torch.no_grad():
        got = gpipe(_toy_fn, blocks, x, None, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    torch.testing.assert_close(got, stage_apply(_toy_fn, blocks, x),
                               rtol=0, atol=0)


def test_remat_recomputes_each_block_with_the_same_bits():
    """`remat` (JAX's plain `jax.checkpoint` of each block): the stages
    in one process give the same output and gradients as without it."""
    x = torch.from_numpy(PP.toy_x())
    g = torch.from_numpy(PP.toy_x(seed=2))
    runs = []
    for remat in (False, True):
        blocks = _toy_blocks()
        runs.append(gpipe_shards(_toy_fn, [blocks[:4], blocks[4:]], x, 2,
                                 g_out=g, remat=remat))
    torch.testing.assert_close(runs[1].out, runs[0].out, rtol=0, atol=0)
    torch.testing.assert_close(runs[1].dx, runs[0].dx, rtol=0, atol=0)
    for a, b in zip(sum(runs[1].grads, []), sum(runs[0].grads, [])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flax_path_names_jaxs_pipelined_leaves():
    """`flax_path(..., gpipe=True)` maps every parameter of the port's
    GPipeViT and GPipeArcFaceViT onto a leaf of JAX's tree (a block's
    param onto its stacked leaf), and covers every leaf."""
    from ddp_classification_pytorch_tpu_torch.config import ModelConfig
    from ddp_classification_pytorch_tpu_torch.models.convert import flax_path

    for head in ("fc", "arcface"):
        params = PP.jax_params(head, PP.IMAGE, PP.CLASSES)
        want = {"/".join(k.key for k in path) for path, _ in
                jax.tree_util.tree_flatten_with_path(params)[0]}
        with _port_vit():
            model = factory.build_model(
                ModelConfig(arch="vit_t16", head=head, arc_embed_dim=64),
                PP.CLASSES, PP.IMAGE, mesh=port_mesh.Mesh(),
                pipeline_microbatches=2)
        got = {flax_path(n, gpipe=True) for n, _ in model.named_parameters()}
        assert got == want, head


def _jax_refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_divisibility_refusals_are_jaxs(run):
    """The depth and batch refusals, with JAX's texts (its
    `test_gpipe_validates_divisibility` cases)."""
    ranks, _, _ = run
    mesh = PP.jax_mesh(2, 4)
    jw, jb = PP.toy_params()

    def jax_gpipe(depth, b, micro):
        return jax_pipe.gpipe(
            lambda p, h: jax.nn.gelu(h @ p["w"] + p["b"]),
            {"w": jnp.asarray(jw[:depth]), "b": jnp.asarray(jb[:depth])},
            jnp.asarray(PP.toy_x(b=b)), mesh=mesh, axis_name="model",
            microbatches=micro)

    depth_text = _jax_refusal(lambda: jax_gpipe(6, 8, 2))
    assert depth_text == "depth 6 not divisible by 4 stages"
    with pytest.raises(ValueError) as e:
        port_mesh.block_stage(0, 6, 4)
    assert str(e.value) == depth_text
    blocks = _toy_blocks()[:6]
    with pytest.raises(ValueError) as e:
        gpipe_shards(_toy_fn, [blocks[:2], blocks[2:3], blocks[3:4],
                               blocks[4:]], torch.zeros(8, 4, 16), 2)
    assert str(e.value) == depth_text
    batch_text = _jax_refusal(lambda: jax_gpipe(8, 6, 4))
    assert batch_text == "batch 6 not divisible by microbatches×data (4×2)"
    with pytest.raises(ValueError) as e:
        check_batch(6, 4, 2)
    assert str(e.value) == batch_text
    for r in range(4):  # gpipe over a group of 2 and of 4 stages
        for key in PP.EXEC:
            assert ranks[r]["exec"][key]["refusal"] == batch_text


# ----------------------------------------------------------- the model --

class _port_vit:
    def __enter__(self):
        self.kept = port_vit.VIT_CONFIGS["vit_t16"]
        port_vit.VIT_CONFIGS["vit_t16"] = PP.PIPE_VIT

    def __exit__(self, *exc):
        port_vit.VIT_CONFIGS["vit_t16"] = self.kept


def _jax_forward(params, images, head="fc", mesh=None):
    cfg = PP.jax_cfg()
    cfg.model.dtype = "float32"
    mesh = mesh or PP.jax_mesh(8, 1)
    model = PP.jax_model(cfg, mesh)
    with PP.patched_vit():
        return np.asarray(jax.jit(lambda p, x: model.apply(
            {"params": p}, x, train=False))(params, jnp.asarray(images)))


def test_gpipe_vit_forward_matches_jax(run):
    """One process (the S = 1 fallback) and the stages over gloo ranks
    (2 and 4 of them) give JAX's f32 logits, on the pipelined mesh (2, 2)
    and on one stage."""
    ranks, _, _ = run
    params = PP.jax_params()
    images = MA.batches(300)[0][0]
    want = _jax_forward(params, images)
    np.testing.assert_allclose(
        _jax_forward(params, images, mesh=PP.jax_mesh(2, 2)), want,
        atol=ATOL)
    with _port_vit():
        model = GPipeViT("vit_t16", MA.CLASSES, MA.IMAGE, PP.MICRO,
                         torch.float32)
    model.load_state_dict(PP.port_sd(params))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(images).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    for r in range(4):
        for name in ("p2", "p4"):
            np.testing.assert_allclose(ranks[r]["fwd"][name].numpy(), want,
                                       atol=ATOL, err_msg=f"{name} {r}")


def test_ln_bf16_final_layernorm_is_jaxs():
    """`--ln_bf16` changes the pipelined ViT (its hand-written final
    LayerNorm computes in bf16, JAX `pipeline_vit.py:104-111`): the
    headless bf16 model's pooled features, with no blocks and a zero
    patch kernel (so the LayerNorm's input is bitwise the same on both
    sides), are within one bf16 ulp of the largest feature of JAX's,
    with the flag and without, and the flag moves JAX's features."""
    from ddp_classification_pytorch_tpu.models.pipeline_vit import (
        GPipeViT as JaxGPipeViT,
    )

    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    kept = (PP.jax_vit.VIT_CONFIGS["vit_t16"], port_vit.VIT_CONFIGS["vit_t16"])
    PP.jax_vit.VIT_CONFIGS["vit_t16"] = port_vit.VIT_CONFIGS["vit_t16"] = (
        16, 64, 0, 2)
    try:
        feats = {}
        for flag in (False, True):
            jm = JaxGPipeViT("vit_t16", 0, PP.jax_mesh(8, 1), 2,
                             dtype=jnp.bfloat16, ln_bf16=flag)
            p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
            p["patch"]["kernel"] = jnp.zeros_like(p["patch"]["kernel"])
            p["patch"]["bias"] = jax.random.normal(jax.random.PRNGKey(5),
                                                   (64,))
            p["ln_f"]["scale"] = 1 + 0.3 * jax.random.normal(
                jax.random.PRNGKey(6), (64,))
            want = np.asarray(jm.apply({"params": p}, jnp.asarray(x),
                                       train=False), np.float32)
            port = GPipeViT("vit_t16", 0, 32, 2, torch.bfloat16,
                            ln_bf16=flag)
            port.load_state_dict(PP.port_sd(jax.tree_util.tree_map(
                np.asarray, p)))
            with torch.no_grad():
                got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ulp)
            feats[flag] = want
    finally:
        PP.jax_vit.VIT_CONFIGS["vit_t16"], port_vit.VIT_CONFIGS["vit_t16"] = kept
    assert np.abs(feats[True] - feats[False]).max() > 0


def test_block_stage_is_jaxs_stage_rule():
    """Stage i owns blocks [i·L/S, (i+1)·L/S): JAX's P(stage axis) on the
    stacked (L, ...) leaves; on a (data, model) mesh the stages ride the
    model axis, on a 3-axis mesh the pipe axis."""
    import jax as _jax
    from ddp_classification_pytorch_tpu.parallel import mesh as jax_mesh

    for depth, s in ((12, 2), (12, 4), (8, 8), (4, 1)):
        got = [port_mesh.block_stage(i, depth, s) for i in range(depth)]
        assert got == [i // (depth // s) for i in range(depth)]
    for spec, axis in (((2, 2, 2), "pipe"), ((4, 2, 1), "model")):
        mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(*spec),
                                  _jax.devices()[:8])
        leaf = jnp.zeros((12, 3))
        want = jax_mesh._spec_for_param(
            "['params']['blocks']['ln1']['scale']", leaf,
            dict(mesh.shape).get("model", 1), dict(mesh.shape).get("pipe", 1))
        assert want[0] == axis
        port = port_mesh.make_mesh(port_mesh.MeshSpec(*spec), world=8, rank=5)
        assert port.stage_axis()[0] == axis
        assert port.shape == dict(mesh.shape)


def test_mesh_coords_are_jaxs_device_table():
    """rank = (d·mp + m)·pp + p: where JAX's (data, model, pipe) mesh puts
    device r on the CPU; pp = 1 is the (data, model) table."""
    from ddp_classification_pytorch_tpu.parallel import mesh as jax_mesh

    for spec in ((2, 2, 2), (1, 2, 4), (4, 1, 2), (2, 4, 1)):
        mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(*spec),
                                  jax.devices()[:8])
        ids = np.vectorize(lambda d: jax.devices().index(d))(mesh.devices)
        ids = ids.reshape(spec)
        for r, (d, m, p) in enumerate(port_mesh.mesh_coords(*spec)):
            assert ids[d, m, p] == r
    assert port_mesh.rank_table(4, 2) == [
        (d, m) for d, m, _ in port_mesh.mesh_coords(4, 2)]


# ---------------------------------------------------------- train steps --

def _assert_steps(got, want, head="fc"):
    for (gm, gstate), (wm, wparams, _) in zip(got, want):
        for key in METRICS:
            np.testing.assert_allclose(gm[key], wm[key], err_msg=key,
                                       **H.TOL)
        expect = PP.port_sd(wparams, head)
        assert sorted(gstate) == sorted(expect)
        for k, w in expect.items():
            np.testing.assert_allclose(gstate[k].numpy(), np.asarray(w),
                                       err_msg=k, **H.TOL)


@pytest.mark.parametrize("case,workload,spec", [
    ("pp", "baseline", (2, 1, 2)), ("cdr", "cdr", (2, 1, 2)),
    ("mp", "baseline", (2, 2, 1))])
def test_gpipe_vit_steps_match_jax(run, case, workload, spec):
    ranks, _, _ = run
    dp, mp, pp = spec
    cfg = PP.jax_cfg(workload, mp=mp, pp=pp if pp > 1 else 0)
    mesh = PP.jax_mesh(dp, mp, pp)
    with jax.enable_x64(True):
        jmodel = PP.jax_model(cfg, mesh)
    with PP.patched_vit():
        want = MA.jax_steps_run(cfg, jmodel, mesh, PP.jax_params(), {},
                                MA.batches(300))
    _assert_steps(ranks[0][case], want)


def test_ranks_sit_on_the_mesh_coordinates(run):
    ranks, _, _ = run
    for r in range(4):
        assert ranks[r]["coords"] == (r // 2, r % 2, r // 2, r % 2)


# ------------------------------------------------------------------ CLI --

PARSES = [["--pp_microbatches", "2"],
          ["--pp_stages", "2", "--pp_microbatches", "4", "--mp", "2"]]


@pytest.mark.parametrize("flag", ["--pp_microbatches", "--pp_stages"])
def test_pipeline_flags_parse_as_jaxs(flag):
    argv = ["arcface", flag, "2"] + (["--pp_microbatches", "2"]
                                     if flag == "--pp_stages" else [])
    jax_args = jax_cli.build_parser().parse_args(argv)
    port_args = port_cli.build_parser().parse_args(argv)
    for key in ("pp_microbatches", "pp_stages"):
        assert getattr(port_args, key) == getattr(jax_args, key), key
    jcfg, pcfg = (jax_cli.config_from_args(jax_args),
                  port_cli.config_from_args(port_args))
    for key in ("pipeline_microbatches", "pipeline_stages"):
        assert getattr(pcfg.parallel, key) == getattr(jcfg.parallel, key)


def _port_rc(argv, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        port_cli.main(argv + ["--out", str(tmp_path)])
    return e.value.code, capsys.readouterr().err


BASE = ["baseline", "--dataset", "synthetic", "--synthetic_size", "8",
        "--image_size", "32", "--num_classes", "4", "--batchsize", "4",
        "--epochs", "1", "--device", "cpu"]


@pytest.mark.parametrize("argv,text", [
    (["--model", "vit_t16", "--pp_stages", "2"],
     "--pp_stages requires --pp_microbatches"),
    (["--model", "vit_t16", "--pp_stages", "2", "--pp_microbatches", "2"],
     "mesh 0×1×2 does not cover 1 devices"),
    (["--model", "resnet50", "--pp_microbatches", "2"],
     "pipeline parallelism (--pp_microbatches) requires a ViT arch with a "
     "homogeneous block stack; got 'resnet50'"),
    (["--model", "vit_t16", "--grad_accum", "2", "--pp_microbatches", "2"],
     "grad-accum-indivisible: grad_accum > 1 does not compose with the "
     "pipeline schedule (pipeline_microbatches already owns the "
     "microbatch loop) — pick one microbatching scheme"),
    (["--model", "vit_t16", "--dropout", "0.1", "--pp_microbatches", "2"],
     "pipeline parallelism does not support dropout (the tick loop "
     "carries no per-tick rng); set --dropout 0"),
    (["--model", "vit_t16", "--moe_experts", "4", "--pp_microbatches",
      "2"], "pipeline parallelism and moe_experts both claim the model "
     "axis — one role per config (drop --pp_microbatches or "
     "--moe_experts)")])
def test_pipeline_refusals_exit_2_with_jaxs_text(tmp_path, capsys, argv,
                                                 text):
    rc, err = _port_rc(BASE + argv, tmp_path, capsys)
    assert rc == 2 and text in err, err
    assert torch.distributed.is_initialized() is False


def test_pipeline_model_refusals_are_jaxs():
    """The factory's refusals (arch, nested head, dropout, MoE, no mesh)
    with JAX's texts, in JAX's order."""
    from ddp_classification_pytorch_tpu.config import ModelConfig as JMC
    from ddp_classification_pytorch_tpu.models import factory as jax_factory
    from ddp_classification_pytorch_tpu_torch.config import ModelConfig

    jmesh = PP.jax_mesh(2, 4)
    pmesh = port_mesh.Mesh()
    for kw in (dict(arch="resnet50"), dict(head="nested"),
               dict(dropout=0.1), dict(moe_experts=4),
               dict(head="nested", dropout=0.1)):
        kw = {"arch": "vit_t16", **kw}
        want = _jax_refusal(lambda: jax_factory.build_model(
            JMC(**kw), 4, mesh=jmesh, pipeline_microbatches=2))
        with pytest.raises(ValueError) as e:
            factory.build_model(ModelConfig(**kw), 4, 32, mesh=pmesh,
                                pipeline_microbatches=2)
        assert str(e.value) == want, kw
    want = _jax_refusal(lambda: jax_factory.build_model(
        JMC(arch="vit_t16"), 4, mesh=None, pipeline_microbatches=2))
    with pytest.raises(ValueError) as e:
        factory.build_model(ModelConfig(arch="vit_t16"), 4, 32,
                            pipeline_microbatches=2)
    assert str(e.value) == want


def test_bf16_wire_refused_with_the_pipeline():
    """JAX's text for the bf16 wire over two data ranks with the pipeline
    (`check_scaling`, as the step sees a data axis of 2)."""
    from ddp_classification_pytorch_tpu_torch.config import get_preset
    from ddp_classification_pytorch_tpu_torch.train.steps import check_scaling

    cfg = get_preset("baseline")
    cfg.model.arch = "vit_t16"
    cfg.parallel.grad_reduce_dtype = "bfloat16"
    cfg.parallel.pipeline_microbatches = 2
    with pytest.raises(ValueError, match="pure-DP fast path; it does not "
                       "compose with a model/pipe axis"):
        check_scaling(cfg, world=2)
    check_scaling(cfg, world=1)  # one data rank: the wire is the identity


def test_pipeline_at_world_one_trains_and_resumes(tmp_path, capsys):
    """`baseline --pp_microbatches 2` on one process (JAX's S = 1
    fallback): an epoch, then `--auto_resume` continues it."""
    argv = BASE[:] + ["--model", "vit_t16", "--pp_microbatches", "2",
                      "--dtype", "float32", "--num_workers", "1"]
    with _port_vit():
        port_cli.main(argv + ["--out", str(tmp_path)])
        argv[argv.index("--epochs") + 1] = "2"
        port_cli.main(argv + ["--out", str(tmp_path), "--auto_resume"])
    out = capsys.readouterr().out
    assert "auto-resumed from" in out and "pp_microbatches=2" in out
    assert (tmp_path / "ckpt_e1.pt").exists()
