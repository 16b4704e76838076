"""The torch port's (data, model) mesh (parallel/mesh.py) against the JAX
package's `parallel/mesh.py`, on the CPU, and the CLI's model-axis flags
against the JAX CLI's.

- `MeshSpec.resolve` and `viable_world` give JAX's axes, verdicts and
  error texts over a grid of specs and device counts;
- the rank → (data, model) table is JAX's device table: rank r sits
  where JAX's mesh puts device r (model groups of contiguous ranks);
- `make_hybrid_mesh` lays the data axis across nodes as JAX's two-tier
  mesh does (slice-major data axis, each model group inside a slice),
  and refuses pipeline stages and a spec a slice cannot hold with JAX's
  texts;
- `shard_dim` (JAX's `_spec_for_param` in the port's names) shards
  exactly the class-dim matrices and the MoE banks, on their class /
  expert dim, over whole models of every head;
- the elastic gate `check_viable` reads the model and pipe axes as JAX's
  does;
- `--mp`, `--sharded_ce` and `--dcn_slices` parse as JAX's do (and the
  pipeline's `--pp_microbatches` and `--pp_stages`), and a world of one
  refuses `--mp 2` with the mesh text.
"""

import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.cli import train as jax_cli
from ddp_classification_pytorch_tpu.parallel import mesh as jax_mesh
from ddp_classification_pytorch_tpu_torch.cli import train as port_cli
from ddp_classification_pytorch_tpu_torch.config import ModelConfig
from ddp_classification_pytorch_tpu_torch.models import factory
from ddp_classification_pytorch_tpu_torch.parallel import fleet
from ddp_classification_pytorch_tpu_torch.parallel import mesh as port_mesh

from torch_port_threads import one_torch_thread  # noqa: F401

SPECS = [(0, 1), (0, 2), (2, 2), (4, 2), (0, 4), (3, 2), (1, 8), (0, 3),
         (2, 1), (8, 1)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_resolve_and_viable_world_match_jax(n):
    for dp, mp in SPECS:
        want = _outcome(lambda: jax_mesh.MeshSpec(dp, mp).resolve(n))
        got = _outcome(lambda: port_mesh.MeshSpec(dp, mp).resolve(n))
        assert got == want, (dp, mp, n)
        assert (port_mesh.viable_world(port_mesh.MeshSpec(dp, mp), n)
                == jax_mesh.viable_world(jax_mesh.MeshSpec(dp, mp), n))
    assert not port_mesh.viable_world(port_mesh.MeshSpec(), 0)


@pytest.mark.parametrize("dp,mp", [(4, 2), (2, 4), (1, 8), (8, 1), (2, 2)])
def test_rank_table_is_jaxs_device_table(dp, mp):
    import jax

    devices = jax.devices()[:dp * mp]
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(dp, mp), devices=devices)
    ids = np.vectorize(lambda d: devices.index(d))(mesh.devices)
    want = {int(ids[d, m]): (d, m) for d in range(dp) for m in range(mp)}
    assert dict(enumerate(port_mesh.rank_table(dp, mp))) == want
    for r in range(dp * mp):
        got = port_mesh.make_mesh(port_mesh.MeshSpec(dp, mp), world=dp * mp,
                                  rank=r)
        assert (got.data_index, got.model_index) == want[r]
        assert got.shape == dict(mesh.shape)


@pytest.mark.parametrize("slices,dp,mp", [(2, 0, 2), (2, 4, 2), (4, 0, 1),
                                          (2, 0, 4)])
def test_hybrid_mesh_matches_jaxs_two_tier_layout(monkeypatch, slices, dp,
                                                  mp):
    """On the 8-device CPU mesh JAX reshapes (slices, dp/slices, mp): the
    rank at (d, m) is the port's rank d·mp + m, so a model group never
    crosses a slice."""
    want = jax_mesh.make_hybrid_mesh(jax_mesh.MeshSpec(dp, mp),
                                     dcn_data_parallel=slices)
    import jax

    ids = np.vectorize(lambda d: jax.devices().index(d))(want.devices)
    for r in range(8):
        got = port_mesh.make_hybrid_mesh(port_mesh.MeshSpec(dp, mp),
                                         dcn_data_parallel=slices, world=8,
                                         rank=r)
        assert got.shape == dict(want.shape)
        assert ids[got.data_index, got.model_index] == r
        per_slice = 8 // slices
        assert all(q // per_slice == r // per_slice
                   for q in range(8) if q // got.mp == r // got.mp)
    # 0 slices: the world over LOCAL_WORLD_SIZE (a node's ranks)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(8 // slices))
    auto = port_mesh.make_hybrid_mesh(port_mesh.MeshSpec(dp, mp), world=8,
                                      rank=5)
    assert auto.shape == dict(want.shape)


def test_hybrid_mesh_refusals_are_jaxs():
    for spec in ((0, 2, 2), (3, 2, 1)):
        want = _outcome(lambda: jax_mesh.make_hybrid_mesh(
            jax_mesh.MeshSpec(*spec), dcn_data_parallel=2))
        got = _outcome(lambda: port_mesh.make_hybrid_mesh(
            port_mesh.MeshSpec(*spec), dcn_data_parallel=2, world=8, rank=0))
        assert want[0] == got[0] == "error"
        assert got[1] == want[1]


def _sharded(head, arch, mp=2, **model):
    cfg = ModelConfig(arch=arch, head=head, dtype="float32", **model)
    if arch.startswith("resnet"):
        cfg.variant = "cifar"
    m = factory.build_model(cfg, 10, 32)
    return {name: port_mesh.shard_dim(name, p.shape, mp)
            for name, p in m.named_parameters()
            if port_mesh.shard_dim(name, p.shape, mp) is not None}


@pytest.mark.parametrize("head,arch,extra,want", [
    ("fc", "resnet18", {}, {"backbone.fc.weight"}),
    ("fc", "vit_t16", {}, {"backbone.fc.weight"}),
    ("fc", "tresnet_m", {}, {"backbone.head.fc.weight"}),
    ("fc", "vgg19_bn", {}, set()),
    ("nested", "resnet18", {}, {"classifier.fc.weight"}),
    ("arcface", "resnet18", {}, {"margin.weight"}),
    ("fc", "vit_t16", {"moe_experts": 4},
     {"backbone.fc.weight"} | {f"backbone.blocks.{i}.{n}" for i in range(12)
                               for n in port_mesh.MOE_BANKS}),
], ids=["resnet-fc", "vit-fc", "tresnet-fc", "vgg-fc", "nested", "arcface",
        "moe"])
def test_shard_dim_is_jaxs_spec_for_param(head, arch, extra, want):
    """The sharded names over whole models; every one on dim 0 (torch's
    (C, D) of JAX's (D, C) kernel; the margin and the banks as JAX holds
    them). JAX's own rule on its names agrees (VGG's fc3 is replicated
    there too: neither "classifier" nor "['fc']" is in its path)."""
    got = _sharded(head, arch, **extra)
    assert set(got) == want and set(got.values()) <= {0}
    kernel = np.zeros((64, 10))
    for path, sharded in (("['backbone']['fc']['kernel']", True),
                          ("['classifier']['fc']['kernel']", True),
                          ("['backbone']['fc3']['kernel']", False),
                          ("['embedding']['fc1']['kernel']", False)):
        spec = jax_mesh._spec_for_param(path, kernel, 2)
        assert (spec == jax_mesh.P(None, "model")) == sharded, path
    # an expert count the axis does not divide stays replicated, as JAX's
    bank = np.zeros((3, 8, 8))
    assert jax_mesh._spec_for_param("['moe_w_in']", bank, 2) == jax_mesh.P()
    assert port_mesh.shard_dim("blocks.0.moe_w_in", bank.shape, 2) is None
    assert port_mesh.shard_dim("margin.weight", (10, 8), 1) is None


def test_a_class_count_the_axis_does_not_divide_is_refused():
    """2173 classes = 41 × 53 over 2: JAX's placement refuses it
    (`device_put` onto P(None, 'model')); the port refuses it at build
    with the same words."""
    import jax
    from jax.sharding import NamedSharding

    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(4, 2))
    with pytest.raises(ValueError) as jax_err:
        jax.device_put(np.zeros((8, 2173), np.float32),
                       NamedSharding(mesh, jax_mesh.P(None, "model")))
    cfg = ModelConfig(arch="resnet18", head="fc", dtype="float32",
                      variant="cifar")
    mesh_p = port_mesh.Mesh(dp=1, mp=2)
    model = factory.build_model(cfg, 2173, 32, mesh=mesh_p)
    with pytest.raises(ValueError) as port_err:
        factory.shard_params_(model, mesh_p)
    words = "should be divisible by 2, but it is equal to 2173"
    assert words in str(jax_err.value) and words in str(port_err.value)


def test_check_viable_reads_the_model_axis():
    fleet.check_viable([0, 1, 2, 3], data_parallel=2, model_parallel=2)
    fleet.check_viable([0, 1, 2, 3], data_parallel=0, model_parallel=2)
    with pytest.raises(fleet.PodUnviable, match="does not divide into the "
                       "configured mesh"):
        fleet.check_viable([0, 1, 2], data_parallel=0, model_parallel=2)
    with pytest.raises(fleet.PodUnviable, match="not the configured --dp"):
        fleet.check_viable([0, 1, 2], data_parallel=2)
    # the pipe axis counts too (JAX passes pp to its gate)
    fleet.check_viable([0, 1, 2, 3], data_parallel=0, model_parallel=1,
                       pipeline_parallel=2)
    with pytest.raises(fleet.PodUnviable, match=r"mp=2×pp=2\)"):
        fleet.check_viable([0, 1, 2, 3, 4, 5], data_parallel=0,
                           model_parallel=2, pipeline_parallel=2)


@pytest.mark.parametrize("argv", [
    ["--mp", "2"], ["--mp", "4", "--dp", "2"], ["--dcn_slices", "2"],
    ["--sharded_ce", "--mp", "2"]])
def test_model_axis_flags_parse_as_jaxs(argv):
    jax_args = jax_cli.build_parser().parse_args(["arcface"] + argv)
    port_args = port_cli.build_parser().parse_args(["arcface"] + argv)
    for key in ("mp", "dp", "dcn_slices", "sharded_ce"):
        assert getattr(port_args, key) == getattr(jax_args, key), key
    cfg = port_cli.config_from_args(port_args)
    assert cfg.parallel.model_axis == max(port_args.mp, 1)
    assert cfg.parallel.arcface_sharded_ce == port_args.sharded_ce
    assert cfg.parallel.dcn_slices == port_args.dcn_slices


@pytest.mark.parametrize("flag", ["--pp_microbatches", "--pp_stages"])
def test_pipeline_flags_stay_unknown(capsys, flag):
    """The pipeline flags, unknown to the port before GPipe was ported,
    now parse as JAX's parser parses them."""
    argv = ["baseline", flag, "2"]
    port_args = port_cli.build_parser().parse_args(argv)
    jax_args = jax_cli.build_parser().parse_args(argv)
    for key in ("pp_microbatches", "pp_stages"):
        assert getattr(port_args, key) == getattr(jax_args, key), key


def test_mp2_on_one_rank_exits_2_with_the_mesh_text(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        port_cli.main(["baseline", "--dataset", "synthetic",
                       "--synthetic_size", "8", "--model", "resnet18",
                       "--image_size", "32", "--num_classes", "10",
                       "--batchsize", "4", "--epochs", "1", "--device",
                       "cpu", "--mp", "2", "--out", str(tmp_path)])
    assert e.value.code == 2
    assert "mesh 0×2×1 does not cover 1 devices" in capsys.readouterr().err
    assert torch.distributed.is_initialized() is False
