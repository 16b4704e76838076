"""On-card tests of the torch port: K1's CUDA kernel against its plain
PyTorch version (which the CPU tests hold against the JAX package), the
wrapper's refusals and its launch count, and the served model on the card
against the same model on the CPU.

Marked `cuda`; each test skips (inside a fixture, never at import) where
`torch.cuda.is_available()` is false. On the card, without JAX installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: f32 1e-5; bf16 compared in f32 at 1e-2 (one bf16 ulp of slack:
the kernel may fuse x_hat * scale + bias into one FMA where the plain
version rounds twice, which moves a bf16 result across a tie).
"""

import pytest
import torch

from ddp_classification_pytorch_tpu_torch.ops import fused_abn

pytestmark = pytest.mark.cuda

# every distinct ABN input of TResNet-M at bucket 8, 224 px (N, C, H, W)
TRESNET_M_ABN = [(8, 64, 56, 56), (8, 128, 56, 56), (8, 128, 28, 28),
                 (8, 256, 28, 28), (8, 256, 14, 14), (8, 512, 14, 14),
                 (8, 512, 7, 7)]
RAGGED = [(393, 48), (1001, 37), (3, 48, 5, 7)]  # odd M, C off the vector width
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    if len(shape) == 4:
        n, _, h, w = shape
        x = torch.randn((n, h, w, c), device=device, generator=g)
        x = (x * 1.5 + 0.3).to(dtype).permute(0, 3, 1, 2)  # channels_last
    else:
        x = (torch.randn(shape, device=device, generator=g) * 1.5 + 0.3).to(dtype)
    vec = [torch.rand(c, device=device, generator=g) + 0.5 for _ in range(4)]
    vec[1] -= 1.0  # bias in [-0.5, 0.5)
    vec[2] -= 1.0  # mean in [-0.5, 0.5)
    return (x, *vec, 1e-5, 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", TRESNET_M_ABN + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_version(cuda, shape, dtype):
    args = _args(shape, dtype, cuda)
    y = fused_abn.fused_bn_leaky_relu(*args)
    ref = fused_abn.fused_bn_leaky_relu_ref(*args)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == args[0].shape
    if len(shape) == 4:
        assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_misaligned_input_takes_the_scalar_path(cuda):
    """A contiguous view whose start is not 16-byte aligned still computes
    the right result (the kernel drops to one element per access)."""
    m, c = 97, 64
    buf = torch.randn(m * c + 1, device=cuda)
    x = buf[1:].view(m, c)
    assert x.data_ptr() % 16 != 0
    args = _args((m, c), torch.float32, cuda)
    args = (x,) + args[1:]
    torch.testing.assert_close(fused_abn.fused_bn_leaky_relu(*args),
                               fused_abn.fused_bn_leaky_relu_ref(*args),
                               atol=1e-5, rtol=1e-5)


def test_refuses_non_channels_last(cuda):
    x, *rest = _args((2, 64, 4, 4), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="channels_last"):
        fused_abn.fused_bn_leaky_relu(x.contiguous(), *rest)
    with pytest.raises(ValueError, match=r"\(M, C\) x must be contiguous"):
        fused_abn.fused_bn_leaky_relu(torch.zeros(8, 4, device=cuda).t(),
                                      *[torch.zeros(8, device=cuda)] * 4)


def test_refuses_other_dtypes_and_bad_vectors(cuda):
    x, scale, bias, mean, var, eps, slope = _args((2, 64, 4, 4), torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_abn.fused_bn_leaky_relu(x.half(), scale, bias, mean, var)
    with pytest.raises(ValueError, match="scale must be"):
        fused_abn.fused_bn_leaky_relu(x, scale.double(), bias, mean, var)
    with pytest.raises(ValueError, match="var must be"):
        fused_abn.fused_bn_leaky_relu(x, scale, bias, mean, var.cpu())
    with pytest.raises(ValueError, match="mean must be"):
        fused_abn.fused_bn_leaky_relu(x, scale, bias, mean[:32], var)


def test_launch_count(cuda):
    args = _args((2, 64, 4, 4), torch.bfloat16, cuda)
    before = fused_abn.fused_bn_leaky_relu.launches
    for _ in range(3):
        fused_abn.fused_bn_leaky_relu(*args)
    fused_abn.fused_bn_leaky_relu_ref(*args)
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    fused_abn.fused_bn_leaky_relu(*cpu)  # CPU tensors: the plain version
    assert fused_abn.fused_bn_leaky_relu.launches == before + 3


def test_served_model_on_card_matches_cpu(cuda):
    """The reduced TResNet in f32 served on the card (convs on cuDNN, ABN on
    K1) against the same weights on the CPU (ABN on the plain version):
    top-5 agrees and the probabilities to 1e-4 (f32, no TF32; the two
    devices sum convolutions in different orders)."""
    from ddp_classification_pytorch_tpu_torch.config import get_preset
    from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel
    from ddp_classification_pytorch_tpu_torch.models.tresnet import TResNet
    from ddp_classification_pytorch_tpu_torch.train.state import init_weights_
    from ddp_classification_pytorch_tpu_torch.train.steps import (
        make_topk_predict_step,
    )

    model = ClassifierModel(TResNet(num_classes=10, stages=(1, 1, 1, 1),
                                    width=0.5, dtype=torch.float32))
    init_weights_(model, torch.Generator().manual_seed(0)).eval()
    predict = make_topk_predict_step(get_preset("baseline"), k=5)
    images = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    want_p, want_i = predict(model, images)
    gpu = model.to(device=cuda, memory_format=torch.channels_last)
    before = fused_abn.fused_bn_leaky_relu.launches
    got_p, got_i = predict(gpu, images.to(cuda))
    assert fused_abn.fused_bn_leaky_relu.launches == before + 7  # stem + 2 basic + 2 x 2 bottleneck
    torch.testing.assert_close(got_i.cpu(), want_i)
    torch.testing.assert_close(got_p.cpu(), want_p, atol=1e-4, rtol=1e-4)
