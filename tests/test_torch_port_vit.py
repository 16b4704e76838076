"""The ViT in the torch port (models/vit.py) against the JAX package's flax
ViT, on the CPU, with weights carried across by `models/convert.py::
vit_from_jax`.

Reduced model: depth 2, width 64, 2 heads of 32, 64 px (16 tokens), 10
classes. f32 logits within 1e-4 of the JAX model with flash on (the JAX
Pallas kernel in interpret mode; the port's plain versions) and off (the
dense op on both sides). In bf16 the two packages round at different
points (XLA vs PyTorch elementwise kernels), so the bf16 check is looser:
5% of the logits' spread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.models.factory import ClassifierModel as JaxClassifier
from ddp_classification_pytorch_tpu.models.vit import ViT as JaxViT
from ddp_classification_pytorch_tpu_torch.config import ModelConfig
from ddp_classification_pytorch_tpu_torch.models import vit
from ddp_classification_pytorch_tpu_torch.models.convert import vit_from_jax
from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel, build_model
from ddp_classification_pytorch_tpu_torch.ops import flash_attention as port_fa

from torch_port_threads import one_torch_thread  # noqa: F401

REDUCED = dict(patch=16, dim=64, depth=2, heads=2, num_classes=10)
IMAGE = 64


def _jax_model(dtype=jnp.float32, use_flash=False):
    return JaxClassifier(backbone=JaxViT(dtype=dtype, use_flash=use_flash,
                                         flash_min_tokens=0, **REDUCED))


def _port_model(dtype=torch.float32, use_flash=False):
    return ClassifierModel(vit.ViT(image_size=IMAGE, dtype=dtype,
                                   use_flash=use_flash, flash_min_tokens=0,
                                   **REDUCED))


@pytest.fixture(scope="module")
def params():
    """flax params of the reduced ViT with every LayerNorm γ/β and every
    bias randomized, so a scale↔bias swap in the mapping shows."""
    x = jnp.zeros((1, IMAGE, IMAGE, 3))
    p = jax.jit(lambda k: _jax_model().init(k, x, train=False))(
        jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(7)

    def leaf(path, v):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        return np.asarray(v)

    return jax.tree_util.tree_map_with_path(leaf, p)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(8).normal(
        size=(2, IMAGE, IMAGE, 3)).astype(np.float32)


def _port_logits(model, params, images):
    model.load_state_dict({f"backbone.{k}": v for k, v in vit_from_jax(params).items()})
    with torch.no_grad():
        return model(torch.from_numpy(images).permute(0, 3, 1, 2)).float().numpy()


@pytest.mark.parametrize("use_flash", [False, True], ids=["dense", "flash"])
def test_reduced_vit_logits_match_jax(params, images, use_flash):
    want = np.asarray(_jax_model(use_flash=use_flash).apply(
        {"params": params}, jnp.asarray(images), train=False))
    got = _port_logits(_port_model(use_flash=use_flash), params, images)
    assert got.shape == want.shape == (2, 10)
    assert want.std() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_reduced_vit_bf16_policy_close_to_jax(params, images):
    """bf16 compute with f32 master weights, f32 LayerNorms, pool and head
    on both sides."""
    want = np.asarray(_jax_model(jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(images), train=False))
    model = _port_model(torch.bfloat16)
    got = _port_logits(model, params, images)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert np.abs(got - want).max() <= 0.05 * want.std()


def test_state_dict_layout_is_the_converter_image(params):
    """vit_from_jax gives exactly the port ViT's keys and shapes (strict
    load), with Dense kernels transposed and the conv in OIHW."""
    sd = vit_from_jax(params)
    port = _port_model().backbone
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    b = params["backbone"]
    np.testing.assert_array_equal(sd["blocks.1.attn.qkv.weight"].numpy(),
                                  np.asarray(b["block1"]["attn"]["qkv"]["kernel"]).T)
    np.testing.assert_array_equal(sd["patch_embed.weight"].numpy(),
                                  np.asarray(b["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["ln_final.weight"].numpy(),
                                  np.asarray(b["ln_final"]["scale"]))


@pytest.mark.parametrize("floor,launches", [(0, 2), (17, 0)],
                         ids=["at-floor", "below-floor"])
def test_flash_gate_follows_flash_min_tokens(monkeypatch, images, floor, launches):
    """16 tokens: flash_min_tokens 0 sends every block to the flash path,
    17 sends none (vit.py:63-64)."""
    calls = []
    monkeypatch.setattr(port_fa, "flash_forward",
                        lambda *a: calls.append(a) or port_fa.flash_forward_ref(*a))
    model = vit.ViT(image_size=IMAGE, dtype=torch.float32, use_flash=True,
                    flash_min_tokens=floor, **REDUCED)
    with torch.no_grad():
        model(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert len(calls) == launches


@pytest.mark.parametrize("option", [dict(moe_experts=4), dict(remat=True),
                                    dict(ln_bf16=True), dict(dropout=0.1)],
                         ids=["moe", "remat", "ln_bf16", "dropout"])
def test_unported_options_are_refused(option):
    cfg = ModelConfig(arch="vit_t16", **option)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        build_model(cfg, 10, IMAGE)


def test_vit_b16_is_the_published_shape():
    """ViT-B/16 at 512 px: width 768, 12 heads, depth 12, 1024 tokens."""
    model = build_model(ModelConfig(arch="vit_b16", dtype="bfloat16",
                                    flash_attention=True), 1000, 512).backbone
    assert model.pos_embed.shape == (1, 1024, 768)
    assert len(model.blocks) == 12 and model.blocks[0].attn.heads == 12
    assert model.blocks[0].attn.flash_min_tokens == 1024
    d = 768
    block = 2 * 2 * d + (d * 3 * d + 3 * d) + (d * d + d) + 2 * 4 * d * d + 4 * d + d
    want = (16 * 16 * 3 * d + d) + 1024 * d + 12 * block + 2 * d + (d * 1000 + 1000)
    assert sum(p.numel() for p in model.parameters()) == want == 87_202_024
