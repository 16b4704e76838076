"""The ViT's mixture of experts in the torch port (ops/moe.py, the MoE
branch of models/vit.py, `--moe_*`) against the JAX package's, on the CPU,
and the train CLI's model options (`--moe_*`, `--dropout`, `--remat`,
`--ln_bf16`, `--mp`) against the JAX CLI's.

(a) `router_logits`, `topk_gates`, `load_balance_loss` and `moe_mlp` at
    f32 on the same numpy inputs: outputs and every input's gradient
    within 1e-6; their rejections ("top_k", "gates width").
(b) The reduced MoE ViT (vit_t16 cut to dim 64, depth 2, 1 head of 64,
    32 px, 8 experts of hidden 32, top-2) from one set of random weights
    (tests/torch_port_helpers.py::random_vit_params): eval logits at f32 within 1e-5 and
    under the bf16 policy within 5% of the logits' spread (the tolerance
    of tests/test_torch_port_vit.py; the JAX experts' bf16 products with
    f32 output as f32 products of the upcast operands, which XLA's CPU
    runtime needs: `_UpcastDots`); two SGD steps at f32 (metrics,
    every parameter, at atol 1e-5 / rtol 1e-4) and one under the bf16
    policy (loss, and the logits after the step at the bf16 tolerance);
    one step at `--grad_accum 2` against JAX's scan.
(c) The balance penalty with `--remat` on both sides: the port's summed
    penalty is JAX's sown sum, and weight 0.01 adds 0.01 × it to the loss
    and weight 0 nothing (the remat steps themselves are held against
    JAX's in tests/test_torch_port_remat.py).
(d) The converter and `flax_path` name the five expert params as flax
    does; the expert banks' init is flax's xavier-uniform with the expert
    count in both fans (U(±0.0884) at (8, 64, 32)).
(e) The CLI: the flags map as JAX's; every rejection exits rc 2 where the
    JAX package raises too; `--mp 2` on one rank exits rc 2 with the mesh
    text (JAX's 8-device mesh takes it); VGG19-BN's `--dropout 0`
    is 0.5 (JAX `factory.py:62`).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.cli import train as jax_train_cli
from ddp_classification_pytorch_tpu.models import factory as jax_factory
from ddp_classification_pytorch_tpu.models.factory import ClassifierModel as JaxClassifier
from ddp_classification_pytorch_tpu.models.vit import ViT as JaxViT
from ddp_classification_pytorch_tpu.ops import moe as jax_moe
from ddp_classification_pytorch_tpu.train import steps as jax_steps
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu.train.state import TrainState as JaxTrainState
from ddp_classification_pytorch_tpu_torch.cli import train as train_cli
from ddp_classification_pytorch_tpu_torch.models import factory, vgg, vit
from ddp_classification_pytorch_tpu_torch.models.convert import flax_path, vit_from_jax
from ddp_classification_pytorch_tpu_torch.ops import moe
from ddp_classification_pytorch_tpu_torch.train import schedule, steps
from ddp_classification_pytorch_tpu_torch.train.state import TrainState, init_weights_

from torch_port_helpers import OPTIM, random_vit_params
from torch_port_steps import SideBySide, batch, cfgs
from torch_port_threads import one_torch_thread  # noqa: F401

REDUCED = dict(patch=16, dim=64, depth=2, heads=1, num_classes=10)
EXPERTS, TOP_K, HIDDEN = 8, 2, 32
IMAGE, BATCH, CLASSES = 32, 4, 10
FN_TOL = dict(atol=1e-6, rtol=1e-6)


# ------------------------------------------------------ (a) the functions --

def _fn_inputs():
    rng = np.random.default_rng(0)
    b, t, c, e, h = 2, 4, 64, EXPERTS, HIDDEN

    def n(scale, *shape):
        return rng.normal(0.0, scale, shape).astype(np.float32)

    logits = n(1.0, b, t, e)
    gates = np.asarray(jax_moe.topk_gates(jnp.asarray(logits), TOP_K))
    return {"router": (n(1.0, b, t, c), n(0.3, c, e)),
            "gates": (logits,), "balance": (logits,),
            "mlp": (n(1.0, b, t, c), gates, n(0.1, e, c, h), n(0.1, e, h),
                    n(0.1, e, h, c), n(0.1, e, c))}


FNS = {
    "router": (jax_moe.router_logits, moe.router_logits),
    "gates": (lambda lg: jax_moe.topk_gates(lg, TOP_K),
              lambda lg: moe.topk_gates(lg, TOP_K)),
    "balance": (lambda lg: jax_moe.load_balance_loss(lg, TOP_K),
                lambda lg: moe.load_balance_loss(lg, TOP_K)),
    "mlp": (lambda *a: jax_moe.moe_mlp(*a, dtype=jnp.float32),
            lambda *a: moe.moe_mlp(*a, dtype=torch.float32)),
}


@pytest.mark.parametrize("name", list(FNS))
def test_moe_function_and_gradients_match_jax(name):
    args = _fn_inputs()[name]
    jfn, pfn = FNS[name]

    def out_and_grads(args, cot):
        out, vjp = jax.vjp(jfn, *args)
        return out, vjp(cot)

    shape = jax.eval_shape(jfn, *args).shape
    cot = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want, want_grads = jax.jit(out_and_grads)(args, cot)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = pfn(*targs)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FN_TOL)
    for i, (t, w) in enumerate(zip(targs, want_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=f"grad {i}", **FN_TOL)


@pytest.mark.parametrize("case", ["top_k=0", "top_k=9", "gates_width"])
def test_moe_rejections_are_jaxs(case):
    logits = np.zeros((1, 2, EXPERTS), np.float32)
    if case == "gates_width":
        x, gates, *w = _fn_inputs()["mlp"]
        gates = gates[..., :EXPERTS - 1]
        jcall = lambda: jax_moe.moe_mlp(*map(jnp.asarray, (x, gates, *w)))  # noqa: E731
        pcall = lambda: moe.moe_mlp(*map(torch.from_numpy, (x, gates, *w)))  # noqa: E731
        words = "gates width 7 != num experts 8"
    else:
        k = int(case.split("=")[1])
        jcall = lambda: jax_moe.topk_gates(jnp.asarray(logits), k)  # noqa: E731
        pcall = lambda: moe.topk_gates(torch.from_numpy(logits), k)  # noqa: E731
        words = f"top_k={k} must be in"
    for call in (jcall, pcall):
        with pytest.raises(ValueError, match=words):
            call()


# ---------------------------------------------------- (b) the MoE ViT --

class _UpcastDots:
    """`jnp` for the JAX `ops/moe.py` on the CPU, whose XLA runtime has no
    BF16 × BF16 → F32 dot (`preferred_element_type=f32` on bf16
    operands): that product is the f32 product of the operands upcast
    (exact products, f32 sums), so `einsum` upcasts them. The port's CPU
    route computes the same; the rest of the bf16 policy (where each side
    casts) is what the bf16 tests compare."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return jnp.einsum(spec, *ops,
                          preferred_element_type=preferred_element_type, **kw)


@pytest.fixture
def jax_bf16_dots(monkeypatch):
    monkeypatch.setattr(jax_moe, "jnp", _UpcastDots())


def _jax_vit(dtype=jnp.float32, remat=False):
    return JaxClassifier(backbone=JaxViT(dtype=dtype, moe_experts=EXPERTS,
                                         moe_top_k=TOP_K, remat=remat,
                                         **REDUCED))


def _port_vit(dtype=torch.float32, remat=False):
    return factory.ClassifierModel(vit.ViT(
        image_size=IMAGE, dtype=dtype, moe_experts=EXPERTS, moe_top_k=TOP_K,
        remat=remat, **REDUCED))


def _from_jax(params, stats=None):
    return {f"backbone.{k}": v for k, v in vit_from_jax(params).items()}


@pytest.fixture(scope="module")
def params():
    """numpy params of the reduced MoE ViT (`random_vit_params`: every
    LayerNorm γ/β and every bias, the experts' too, random)."""
    return random_vit_params(_jax_vit(), IMAGE, np.random.default_rng(7))


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(8).normal(
        size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32)


def _jax_logits(model, params, images):
    return jax.jit(lambda p, x: model.apply({"params": p}, x, train=False))(
        params, jnp.asarray(images))


def _port_logits(model, params, images):
    model.load_state_dict(_from_jax(params))
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(images).permute(0, 3, 1, 2)).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_moe_vit_logits_match_jax(params, images, dtype,
                                          jax_bf16_dots):
    want = np.asarray(_jax_logits(_jax_vit(jnp.dtype(dtype)), params, images))
    got = _port_logits(_port_vit(getattr(torch, dtype)), params, images)
    assert got.shape == want.shape == (BATCH, CLASSES) and want.std() > 1e-3
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 0.05 * want.std()


def _moe_cfgs(batch_size=BATCH, accum=1, weight=0.01, dtype="float32"):
    jcfg, cfg = cfgs("baseline", "vit_t16", IMAGE, batch_size, CLASSES,
                     **OPTIM)
    for c in (jcfg, cfg):
        c.model.moe_experts, c.model.moe_top_k = EXPERTS, TOP_K
        c.model.moe_aux_weight, c.model.dtype = weight, dtype
        c.parallel.grad_accum = accum
    return jcfg, cfg


def test_two_moe_vit_steps_match_jax(params):
    jcfg, cfg = _moe_cfgs()
    both = SideBySide(jcfg, cfg, _jax_vit(), _port_vit(), _from_jax, params,
                      {}, x64=False)
    for s in range(2):
        m = both.step(*batch(IMAGE, BATCH, CLASSES, 40 + s))
        assert float(m["step_ok"]) == 1.0


def _port_state(cfg, model):
    o = cfg.optim
    return TrainState(model, schedule.build_optimizer(
        o, schedule.param_groups(o, model, False)),
        schedule.build_schedule(o, 1, cfg.parallel.grad_accum))


def test_moe_vit_bf16_step_close_to_jax(params, jax_bf16_dots):
    jcfg, cfg = _moe_cfgs(dtype="bfloat16")
    jmodel = _jax_vit(jnp.bfloat16)
    tx = jax_schedule.build_optimizer(jcfg.optim, 1)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats={}, opt_state=tx.init(params))
    images, labels = batch(IMAGE, BATCH, CLASSES, 50)
    jstate, jm = jax_steps.make_train_step(jcfg, jmodel, tx)(
        jstate, jnp.asarray(images), jnp.asarray(labels))
    model = _port_vit(torch.bfloat16)
    model.load_state_dict(_from_jax(params))
    pm = steps.make_train_step(cfg)(_port_state(cfg, model),
                                    torch.from_numpy(images),
                                    torch.from_numpy(labels))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-2)
    x = np.random.default_rng(51).normal(size=images.shape).astype(np.float32)
    want = np.asarray(_jax_logits(jmodel, jstate.params, x))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).float().numpy()
    assert np.abs(got - want).max() <= 0.05 * want.std()


def test_moe_vit_accum2_step_matches_jax_scan(params):
    jcfg, cfg = _moe_cfgs(batch_size=8, accum=2)
    both = SideBySide(jcfg, cfg, _jax_vit(), _port_vit(), _from_jax, params,
                      {}, x64=False)
    m = both.step(*batch(IMAGE, 8, CLASSES, 60))
    assert float(m["step_ok"]) == 1.0
    assert both.state.step == both.state.opt_count == 1


# ------------------------------------------- (c) the penalty under remat --

def test_aux_penalty_is_jaxs_with_remat(params, images):
    """The summed penalty and its share of the loss: weight 0.01 against
    0 differs by 0.01 × JAX's sown sum (a remat forward on both sides)."""
    jmodel = _jax_vit(remat=True)
    _, aux = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, train=True, mutable=["losses"]))(
            params, jnp.asarray(images))
    want_aux = float(sum(jax.tree_util.tree_leaves(aux)))
    assert 2.0 * REDUCED["depth"] * 0.9 < want_aux  # ≈ top_k a block
    labels = np.arange(BATCH, dtype=np.int32) % CLASSES
    losses = {}
    for weight in (0.0, 0.01):
        _, cfg = _moe_cfgs(weight=weight)
        model = _port_vit(remat=True)
        model.load_state_dict(_from_jax(params))
        m = steps.make_train_step(cfg)(_port_state(cfg, model),
                                       torch.from_numpy(images),
                                       torch.from_numpy(labels))
        losses[weight] = float(m["loss"])
        assert model.backbone.moe_aux is None  # taken by the step
    model = _port_vit(remat=True)
    model.load_state_dict(_from_jax(params))
    model.train()(torch.from_numpy(images).permute(0, 3, 1, 2))
    np.testing.assert_allclose(float(vit.pop_moe_aux(model)), want_aux,
                               **FN_TOL)
    np.testing.assert_allclose(losses[0.01] - losses[0.0], 0.01 * want_aux,
                               atol=1e-6)


# ------------------------------------------ (d) names, layouts and init --

def test_converter_and_flax_path_name_the_expert_params(params):
    model = _port_vit()
    model.load_state_dict(_from_jax(params))  # strict
    block = params["backbone"]["block0"]
    assert "mlp_in" not in block
    for name, shape in (("moe_router", (64, EXPERTS)),
                        ("moe_w_in", (EXPERTS, 64, HIDDEN)),
                        ("moe_b_in", (EXPERTS, HIDDEN)),
                        ("moe_w_out", (EXPERTS, HIDDEN, 64)),
                        ("moe_b_out", (EXPERTS, 64))):
        got = model.state_dict()[f"backbone.blocks.0.{name}"]
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(block[name]))
    paths = {"/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(params)}
    names = [n for n, _ in model.named_parameters()]
    assert {flax_path(n) for n in names} == paths and len(names) == len(paths)
    assert schedule.frozen_bn_names(model) == []


def test_expert_init_is_flax_xavier_with_experts_in_both_fans():
    bound = np.sqrt(6.0 / ((64 + HIDDEN) * EXPERTS))
    assert abs(bound - 0.0884) < 1e-4
    # the initializer JAX's Block gives its banks (`vit.py:128-132`)
    w_jax = np.asarray(fnn.initializers.xavier_uniform()(
        jax.random.PRNGKey(0), (EXPERTS, 64, HIDDEN), jnp.float32))
    model = init_weights_(_port_vit(), torch.Generator().manual_seed(0))
    w = model.backbone.blocks[0].moe_w_in.detach().numpy()
    for arr in (w_jax, w):
        assert np.abs(arr).max() <= bound and np.abs(arr).max() > 0.95 * bound
        assert abs(arr.std() - bound / np.sqrt(3.0)) < 0.05 * bound
    router = model.backbone.blocks[1].moe_router.detach().numpy()
    assert np.abs(router).max() <= np.sqrt(6.0 / (64 + EXPERTS))
    assert not model.backbone.blocks[0].moe_b_in.detach().any()


# --------------------------------------------------------------- (e) CLI --

OPTION_FIELDS = ("dropout", "remat", "ln_bf16", "moe_experts", "moe_top_k",
                 "moe_aux_weight")


@pytest.mark.parametrize("argv", [
    ["baseline", "--model", "vit_t16", "--moe_experts", "8"],
    ["baseline", "--model", "vit_b16", "--moe_experts", "4", "--moe_top_k",
     "1", "--moe_aux_weight", "0"],
    ["baseline", "--moe_top_k", "3", "--moe_aux_weight", "0.5"],
    ["baseline", "--model", "vit_b16", "--dropout", "0.1", "--remat",
     "--ln_bf16"],
    ["nested", "--model", "vgg19_bn", "--dropout", "0"],
    ["baseline", "--remat", "--mp", "1"],
], ids=["moe", "moe-options", "no-experts", "vit-options", "vgg-dropout0",
        "resnet-remat"])
def test_cli_options_map_as_jaxs(argv):
    want = jax_train_cli.config_from_args(
        jax_train_cli.build_parser().parse_args(argv)).model
    got = train_cli.config_from_args(
        train_cli.build_parser().parse_args(argv)).model
    for f in OPTION_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def _jax_refuses(argv) -> bool:
    """Whether the JAX package refuses `argv`'s config (its CLI's mapping,
    or its model's build: the factory, or flax's init traced by
    `jax.eval_shape`)."""
    try:
        jcfg = jax_train_cli.config_from_args(
            jax_train_cli.build_parser().parse_args(argv))
        model = jax_factory.build_model(jcfg.model, 10)
        jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((1, IMAGE, IMAGE, 3)), train=False))
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("extra,words", [
    (["--model", "resnet18", "--moe_experts", "4"], "requires a ViT arch"),
    (["--model", "vit_t16", "--moe_experts", "5"], "must divide"),
    (["--model", "vit_t16", "--moe_experts", "4", "--dropout", "0.1"],
     "does not support dropout"),
    (["--model", "vit_t16", "--moe_experts", "4", "--moe_top_k", "5"],
     "top_k=5 must be in"),
    (["--model", "vit_t16", "--moe_experts", "4", "--moe_aux_weight", "-1"],
     "must be >= 0"),
    (["--mp", "2"], "mesh 0×2×1 does not cover 1 devices"),
], ids=["moe-resnet", "moe-divide", "moe-dropout", "moe-top-k",
        "aux-negative", "mp2"])
def test_rejections_exit_2(tmp_path, capsys, extra, words):
    argv = ["baseline", "--dataset", "synthetic", "--synthetic_size", "8",
            "--image_size", str(IMAGE), "--num_classes", "10", "--batchsize",
            "4", "--epochs", "1", "--dtype", "float32", "--device", "cpu",
            "--out", str(tmp_path)] + extra
    with pytest.raises(SystemExit) as e:
        train_cli.main(argv)
    assert e.value.code == 2 and words in capsys.readouterr().err
    # the JAX package refuses the same configs (it has a model axis)
    assert _jax_refuses(argv[:1] + extra) == (extra[0] != "--mp")


@pytest.mark.parametrize("dropout,p", [("0", 0.5), ("0.3", 0.3)])
def test_vgg_dropout_flag_follows_jaxs_or_half(dropout, p):
    argv = ["nested", "--model", "vgg19_bn", "--dropout", dropout]
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(argv))
    with torch.device("meta"):
        model = factory.build_model(cfg.model, 10, 32)
    drops = [m.p for m in model.modules() if isinstance(m, vgg.Dropout)]
    assert drops == [p]  # the 4096-d feature's, under nested
    jcfg = jax_train_cli.config_from_args(
        jax_train_cli.build_parser().parse_args(argv))
    assert jax_factory.build_backbone(jcfg.model, 0).dropout == p


def test_vit_dropout_sits_after_the_gelu_only():
    """One flax Dropout a block, in the MLP; the port's likewise."""
    seen = []

    def spy(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout):
            seen.append((context.module.rate, args[0].shape))
        return next_fun(*args, **kwargs)

    jmodel = JaxViT(dropout=0.1, **REDUCED)
    with fnn.intercept_methods(spy):
        jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((2, IMAGE, IMAGE, 3)), train=True))
    tokens = (IMAGE // 16) ** 2
    assert seen == [(0.1, (2, tokens, 4 * 64))] * REDUCED["depth"]
    port = vit.ViT(image_size=IMAGE, dropout=0.1, **REDUCED)
    drops = [m for m in port.modules() if isinstance(m, vgg.Dropout)]
    assert [d.p for d in drops] == [0.1] * REDUCED["depth"]
