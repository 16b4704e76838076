"""TResNet in the torch port against the JAX package's flax TResNet, on the
CPU, with weights carried across by `models/convert.py`.

- Forward parity on the reduced model (stages (1,1,1,1), width 0.5, f32,
  10 classes), eval mode on randomized BN statistics, at 64 px and at 104 px
  (odd grids mid-net pin the blur / ceil-mode avg-pool padding). Tolerance
  5e-4, the one test_torch_oracle_parity.py holds the flax model to against
  torch.
- Layout: the port's TResNet-M `state_dict` passes through the JAX package's
  `convert_tresnet_state_dict` onto exactly the flax TResNet-M variable tree
  and comes back through `tresnet_from_jax` unchanged — timm's key layout,
  pinned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.models.import_torch import (
    convert_tresnet_state_dict,
)
from ddp_classification_pytorch_tpu.models.tresnet import TResNet as JaxTResNet
from ddp_classification_pytorch_tpu.models.tresnet import space_to_depth
from ddp_classification_pytorch_tpu.models.tresnet import tresnet_m as jax_tresnet_m
from ddp_classification_pytorch_tpu_torch.models import tresnet
from ddp_classification_pytorch_tpu_torch.models.convert import tresnet_from_jax
from ddp_classification_pytorch_tpu_torch.train.state import init_weights_

from torch_port_helpers import REDUCED, init_variables, randomize_bn

@pytest.fixture(scope="module")
def jax_variables():
    """The reduced JAX TResNet's init, made once for the module: a conv
    net's parameters and statistics do not depend on the image size (the
    init at 104 px gives the same values as at 64), so both sizes below
    share it."""
    return init_variables(JaxTResNet(dtype=jnp.float32, **REDUCED), 64)


@pytest.mark.parametrize("image_size", [64, 104])
def test_reduced_tresnet_forward_matches_jax(image_size, jax_variables):
    model = JaxTResNet(dtype=jnp.float32, **REDUCED)
    rng = np.random.default_rng(image_size)
    x = rng.normal(0, 1, (2, image_size, image_size, 3)).astype(np.float32)
    variables = jax_variables
    params, stats = randomize_bn(variables["params"], variables["batch_stats"],
                                 rng)
    apply = jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, train=False))
    want = np.asarray(apply(params, stats, jnp.asarray(x)))

    port = tresnet.TResNet(dtype=torch.float32, **REDUCED)
    port.load_state_dict(tresnet_from_jax(params, stats))
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()

    assert got.shape == want.shape == (2, 10)
    assert want.std() > 1e-3  # the comparison is not between constants
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(space_to_depth(jnp.asarray(x), 4))
    got = tresnet.SpaceToDepth(4)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_tresnet_m_layout_round_trips_through_jax_converter():
    port = tresnet.tresnet_m(num_classes=2173, dtype=torch.float32)
    init_weights_(port, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, tresnet.BatchNorm):
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    sd = port.state_dict()

    flax_tree = convert_tresnet_state_dict(sd)
    # the converted tree is exactly the flax TResNet-M's variable tree
    shapes = jax.eval_shape(
        lambda: jax_tresnet_m(num_classes=2173, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    for coll in ("params", "batch_stats"):
        want = jax.tree_util.tree_map(lambda a: a.shape, shapes[coll])
        got = jax.tree_util.tree_map(np.shape, flax_tree[coll])
        assert got == want, coll

    back = tresnet_from_jax(flax_tree["params"], flax_tree["batch_stats"])
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_tresnet_m_has_36_activated_abn_sites():
    port = tresnet.tresnet_m(num_classes=0, dtype=torch.float32)
    assert sum(isinstance(m, tresnet.FusedABN) for m in port.modules()) == 36


def test_training_mode_raises():
    """Training mode has no fallback either: on a device that is neither
    the CPU nor a card, the activated ABN's batch statistics (K1s's
    wrapper) raise, as its eval mode does."""
    port = tresnet.TResNet(dtype=torch.float32, **REDUCED).train()
    with pytest.raises(ValueError, match="bn_stats: no kernel for device meta"):
        port.to("meta")(torch.zeros(1, 3, 32, 32, device="meta"))
    abn = tresnet.FusedABN(8).train()
    with pytest.raises(ValueError, match="no kernel"):
        abn(torch.zeros(1, 8, 2, 2, device="meta"))


def test_cast_to_compute_dtype_follows_the_jax_policy():
    port = tresnet.TResNet(dtype=torch.bfloat16, **REDUCED).cast_to_compute_dtype()
    for name, t in port.state_dict().items():
        conv = t.dim() == 4 and ".se." not in name
        blur = name.endswith(".filt")
        want = torch.bfloat16 if (conv or blur) else torch.float32
        assert t.dtype == want, name
    with torch.inference_mode():
        out = port.eval()(torch.zeros(1, 3, 32, 32))
    assert out.dtype == torch.float32 and out.shape == (1, 10)
