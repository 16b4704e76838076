"""torchvision / timm imports in the torch port (`models/import_torch.py`,
`models/torch_oracle.py`, `cli/verify_import.py`), on the CPU.

(a) Oracle → port: each oracle (torchvision resnet18 and vgg19_bn, timm
    tresnet_m) randomized in every parameter and buffer, saved with
    `torch.save`, imported through `--pretrained_path`'s path
    (`load_pretrained_`): the port's eval forward equals the oracle's
    (2e-4, the CLI's tolerance; f32 on both sides). A width-mismatched
    head keeps its init; a renamed key, an off-layout VGG index and a
    ViT are ValueErrors.
(b) The same state dict through JAX's `import_torch` and through the
    port: the JAX converters' trees carried back by `models/convert.py`
    are the port's import tensor for tensor (timm's blur wrapping and SE
    convs included), and resnet18's logits agree (the JAX model in f32,
    2e-4).
(c) `cli/verify_import.py --device cpu` on a resnet18 oracle checkpoint at
    64 px, as the JAX CLI's test: PASS rc 0, `--tol 0` FAIL rc 1 (the two
    f32 convolution paths differ in the last bits), a missing key, a
    wrong arch or a file that is no checkpoint rc 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_classification_pytorch_tpu.models import import_torch as jax_import
from ddp_classification_pytorch_tpu.models import resnet as jax_resnet
from ddp_classification_pytorch_tpu_torch.cli import verify_import
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.models import torch_oracle
from ddp_classification_pytorch_tpu_torch.models.convert import (
    resnet_from_jax,
    tresnet_from_jax,
)
from ddp_classification_pytorch_tpu_torch.models.factory import build_backbone
from ddp_classification_pytorch_tpu_torch.models.import_torch import (
    family,
    import_state_dict,
    load_torch_checkpoint,
)
from ddp_classification_pytorch_tpu_torch.train.state import load_pretrained_

from torch_port_threads import one_torch_thread  # noqa: F401

ORACLES = {"resnet18": (lambda n: torch_oracle.make_torch_resnet("resnet18", n), 64),
           "vgg19_bn": (torch_oracle.make_torch_vgg19_bn, 224),
           "tresnet_m": (torch_oracle.make_torch_tresnet_m, 64)}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """arch → (oracle in eval mode, the path of its saved state dict)."""
    root = tmp_path_factory.mktemp("oracles")
    out = {}
    for i, (arch, (make, _)) in enumerate(ORACLES.items()):
        if arch == "vgg19_bn":  # randomize_ fills every tensor it reads;
            # built on meta, the 143 M parameters skip their init
            with torch.device("meta"):
                oracle = make(7).to_empty(device="cpu")
        else:  # TResNet-M's blur filter is no parameter: built for real
            oracle = make(7)
        torch_oracle.randomize_(oracle, seed=11 + i)
        path = str(root / f"{arch}.pth")
        torch.save(oracle.state_dict(), path)
        out[arch] = oracle.eval(), path
    return out


def _port(arch, num_classes):
    """The port's f32 backbone; VGG19-BN's zero-filled (its init costs
    seconds over 143 M parameters, and the imports overwrite them; it
    holds no fixed buffer, as TResNet-M's blur filter is)."""
    cfg = get_preset("baseline")
    cfg.model.arch, cfg.model.dtype = arch, "float32"
    if arch != "vgg19_bn":
        return build_backbone(cfg.model, num_classes)
    with torch.device("meta"):
        backbone = build_backbone(cfg.model, num_classes)
    backbone = backbone.to_empty(device="cpu")
    with torch.no_grad():
        for t in backbone.state_dict().values():
            t.zero_()
    return backbone


@pytest.mark.parametrize("arch", list(ORACLES))
def test_oracle_checkpoint_imports_into_the_port(checkpoints, arch):
    oracle, path = checkpoints[arch]
    image = ORACLES[arch][1]
    port = load_pretrained_(_port(arch, 7), path).eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 3, image, image)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(
            port(x.contiguous(memory_format=torch.channels_last)).numpy(),
            oracle(x).numpy(), atol=2e-4, rtol=2e-4)
    # another class count: the head keeps its values, the rest loads
    other = _port(arch, 3)
    head = {"resnet18": "fc.weight", "vgg19_bn": "classifier.6.weight",
            "tresnet_m": "head.fc.weight"}[arch]
    before = other.state_dict()[head].clone()
    load_pretrained_(other, path)
    assert torch.equal(other.state_dict()[head], before)


def test_import_refusals(checkpoints):
    sd = load_torch_checkpoint(checkpoints["resnet18"][1])
    own = _port("resnet18", 7).state_dict()
    bad = dict(sd, **{"layer9.0.conv1.weight": sd["layer1.0.conv1.weight"]})
    with pytest.raises(ValueError, match="layer9"):
        import_state_dict("resnet", bad, own)
    vsd = load_torch_checkpoint(checkpoints["vgg19_bn"][1])
    vown = _port("vgg19_bn", 7).state_dict()
    off = dict(vsd, **{"features.2.weight": vsd["features.1.weight"]})
    with pytest.raises(ValueError, match="features.2"):  # a ReLU's slot
        import_state_dict("vgg", off, vown)
    with pytest.raises(ValueError, match="vit_b16"):
        family("vit_b16")


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("arch", ["resnet18", "tresnet_m"])
def test_jax_import_and_the_port_import_agree(checkpoints, arch):
    """JAX's converter tree, carried back to torch names, is the port's
    import: the two imports of one file put the same tensors in (VGG's fc1
    permutation is held by tests/test_torch_port_vgg.py's 7×7 forward,
    through `vgg_from_jax`)."""
    path = checkpoints[arch][1]
    sd = load_torch_checkpoint(path)
    own = _port(arch, 7).state_dict()
    port = import_state_dict(family(arch), sd, own)
    convert, back = {
        "resnet18": (jax_import.convert_resnet_state_dict, resnet_from_jax),
        "tresnet_m": (jax_import.convert_tresnet_state_dict,
                      tresnet_from_jax)}[arch]
    tree = convert(_np(sd))
    carried = back(tree["params"], tree["batch_stats"])
    carried = {k: v for k, v in carried.items() if not k.endswith(".filt")}
    assert sorted(carried) == sorted(port)
    for k, v in port.items():
        np.testing.assert_array_equal(carried[k].numpy(), v.numpy(),
                                      err_msg=k)


def test_resnet18_logits_through_jax_and_the_port_agree(checkpoints):
    oracle, path = checkpoints["resnet18"]
    sd = load_torch_checkpoint(path)
    jmodel = jax_resnet.resnet18(num_classes=7, dtype=jnp.float32)
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    variables = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    tree = jax_import.convert_resnet_state_dict(_np(sd))
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]},
        jnp.asarray(x))
    assert set(tree["params"]) == set(variables["params"])
    port = load_pretrained_(_port("resnet18", 7), path).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


def _rc(argv):
    with pytest.raises(SystemExit) as e:
        verify_import.main(argv)
    return e.value.code


def test_verify_import_exit_codes(checkpoints, tmp_path, capsys):
    path = checkpoints["resnet18"][1]
    cpu = ["--arch", "resnet18", "--device", "cpu", "--batch", "1"]
    assert _rc([path, *cpu]) == 0
    out = capsys.readouterr().out
    assert out.startswith("PASS: resnet18 (7 classes)") and "64px" in out
    assert _rc([path, *cpu, "--tol", "0"]) == 1
    assert capsys.readouterr().out.startswith("FAIL")
    sd = torch.load(path)
    del sd["layer3.0.bn2.running_var"]
    torch.save(sd, str(tmp_path / "cut.pth"))
    assert _rc([str(tmp_path / "cut.pth"), *cpu]) == 2
    assert "layer3.0.bn2.running_var" in capsys.readouterr().err
    cpu_r50 = ["--arch", "resnet50", "--device", "cpu"]
    assert _rc([path, *cpu_r50]) == 2  # a resnet18 file under resnet50
    (tmp_path / "junk.pth").write_bytes(b"not a checkpoint")
    assert _rc([str(tmp_path / "junk.pth"), *cpu]) == 2
    assert _rc([path, "--arch", "vit_b16", "--device", "cpu"]) == 2
