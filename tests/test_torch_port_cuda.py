"""On-card tests of the torch port: K1's CUDA kernel, its training passes
K1s/K1r/K1d and the flash attention kernels K2-K4 against their plain
PyTorch versions (which the CPU tests hold against the JAX package), the
bf16 comparisons' power to refuse near misses, the kernels' bitwise
determinism (K1s and K1r also interleaved over shapes and dtypes, their
per-card counters left at 0), the wrappers' refusals and launch counts,
K1 at every rows-per-thread on ragged row counts and its refusal of a
launch geometry it does not take, the reductions' refusal of K1's
geometry and of any other they do not take, the ABN and flash autograd Functions against the plain
versions' autograd, the served model on the card against the same
model on the CPU, and the serving engine's CUDA graphs (one a bucket at
warmup, replays bitwise the eager predict, the hot swap into the
captured weights, `--strict_compile` on a steady-state capture), and
the model axis's bodies over N shards in one process (chip_smoke.py's
phase 35 at reduced shapes): `flash_attention_with_lse` with an lse
cotangent, the flash ring against `flash_attention` on the whole T, the
EP combine against one shard, the partial-FC CE against the dense one;
and GPipe's stages in one process (chip_smoke.py's phase 36 (a) at a
reduced shape) against the sequential stack.

Marked `cuda`; each test skips (inside a fixture, never at import) where
`torch.cuda.is_available()` is false. On the card, without JAX installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances, K1: f32 1e-5; bf16 compared in f32 at 1e-2 (one bf16 ulp of
slack: the kernel may fuse x_hat * scale + bias into one FMA where the
plain version rounds twice, which moves a bf16 result across a tie).
K1s/K1r/K1d: at TRAIN_TOL and SUM_ULPS below. K2-K4: at FLASH_TOL below.
"""

import pytest
import torch

from ddp_classification_pytorch_tpu_torch.ops import fused_abn

pytestmark = pytest.mark.cuda

# every distinct ABN input of TResNet-M at bucket 8, 224 px (N, C, H, W)
TRESNET_M_ABN = [(8, 64, 56, 56), (8, 128, 56, 56), (8, 128, 28, 28),
                 (8, 256, 28, 28), (8, 256, 14, 14), (8, 512, 14, 14),
                 (8, 512, 7, 7)]
# the same sites at bucket 1, and the stem's at bucket 64: 200,704 rows,
# past the 65,535 row blocks the first version's grid could name
TRESNET_M_ABN_B1 = [(1,) + s[1:] for s in TRESNET_M_ABN]
BUCKET_64 = [(64, 64, 56, 56)]
RAGGED = [(393, 48), (1001, 37), (3, 48, 5, 7)]  # odd M, C off the vector width
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue


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
@pytest.mark.parametrize("shape", TRESNET_M_ABN + TRESNET_M_ABN_B1 + BUCKET_64
                         + RAGGED, ids=lambda s: "x".join(map(str, s)))
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,c", [(1001, 48), (393, 64), (77, 37)])
def test_rows_not_a_multiple_of_r(cuda, m, c, dtype):
    """Every R the kernel is built for, on M that no row tile divides: the
    masked tail is neither skipped nor written past, and each R gives the
    bits the wrapper's own choice gives."""
    args = _args((m, c), dtype, cuda)
    want = fused_abn.fused_bn_leaky_relu(*args)
    ref = fused_abn.fused_bn_leaky_relu_ref(*args)
    torch.testing.assert_close(want.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    x, scale, bias, mean, var, eps, slope = args
    sms = fused_abn.sm_count(x.get_device())
    for r in fused_abn.ROWS_PER_THREAD:
        g = fused_abn.geometry(m, c, sms, True, r)
        assert m % (g.ty * r) != 0
        guard = torch.full((m + 64, c), 7.0, device=cuda, dtype=dtype)
        y = guard[:m]
        fused_abn.launch(x, y, scale, bias, mean, var, eps, slope, g)
        torch.cuda.synchronize()
        assert torch.equal(y, want), f"R = {r}"
        assert (guard[m:] == 7.0).all(), f"R = {r} wrote past the last row"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_two_launches_give_the_same_bits(cuda, dtype):
    for shape in [(8, 256, 14, 14), (64, 64, 56, 56), (1001, 37)]:
        args = _args(shape, dtype, cuda, seed=3)
        a = fused_abn.fused_bn_leaky_relu(*args)
        b = fused_abn.fused_bn_leaky_relu(*args)
        torch.cuda.synchronize()
        assert torch.equal(a, b), shape


def test_refuses_a_geometry_the_kernel_does_not_take(cuda):
    """The C side checks the geometry the host hands it and refuses, with
    cudaErrorInvalidValue, one that would leave work undone, launch an
    idle block, exceed its block size, name an R it was not built for or
    take the vector path where C or a pointer does not allow it."""
    m, c = 1001, 48
    x, scale, bias, mean, var, eps, slope = _args((m, c), torch.float32, cuda)
    y = torch.empty_like(x)
    good = fused_abn.geometry(m, c, fused_abn.sm_count(x.get_device()))
    fused_abn.launch(x, y, scale, bias, mean, var, eps, slope, good)
    tiles = -(-m // (good.ty * good.rows))
    bad = {
        "a channel group uncovered": good._replace(tx=good.tx - 1),
        "idle block column": good._replace(gx=good.gx + 1),
        "idle block row": good._replace(gy=tiles + 1),
        "too many threads": good._replace(ty=good.ty * 2),
        "R not built": good._replace(rows=3),
        "vector width not built": good._replace(vec=8, tx=good.tx // 2),
        "no block": good._replace(gy=0),
    }
    for why, g in bad.items():
        with pytest.raises(RuntimeError,
                           match=f"CUDA error {CUDA_ERROR_INVALID_VALUE} "):
            fused_abn.launch(x, y, scale, bias, mean, var, eps, slope, g)
            pytest.fail(f"launched with {why}: {g}")
    # the vector path on a C it does not divide, and on a misaligned x
    x37, *v37 = _args((m, 37), torch.float32, cuda)[:5]
    with pytest.raises(RuntimeError,
                       match=f"CUDA error {CUDA_ERROR_INVALID_VALUE} "):
        fused_abn.launch(x37, torch.empty_like(x37), *v37, eps, slope,
                         fused_abn.geometry(m, 36, 132)._replace(tx=10))
    buf = torch.randn(m * c + 1, device=cuda)
    xm = buf[1:].view(m, c)
    with pytest.raises(RuntimeError,
                       match=f"CUDA error {CUDA_ERROR_INVALID_VALUE} "):
        fused_abn.launch(xm, torch.empty_like(xm), scale, bias, mean, var, eps,
                         slope, good)
    assert fused_abn.launch_geometry(
        xm, [xm.data_ptr(), y.data_ptr()]).vec == 1  # the wrapper's choice


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


# ------------------------------------ K1s, K1r, K1d: the training passes --
# three TResNet-M ABN shapes at the training batch (32 images, 224 px), and
# rows of an odd M and a C off every vector width (the scalar path)
TRAIN_ABN = [(32, 64, 56, 56), (32, 256, 14, 14), (32, 512, 7, 7), (1001, 37)]
# f32 sums over up to 1e5 rows in another order than the plain version's:
# per channel within SUM_ULPS f32 ulps (2^-24 each) of the sum of the
# terms' magnitudes (a row dropped or counted twice moves a sum by about
# that sum / M, more than this below M = 2^24 / SUM_ULPS ≈ 1e6)
SUM_ULPS = 16
# (statistics, dx): f32 1e-5 (sums in another order, then a few roundings);
# dx in bf16 compared in f32 at 1e-2, one bf16 ulp
TRAIN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 1e-2)}


def _train_args(shape, dtype, device, seed=0):
    """x, g (y's gradient, in y's layout), y = K1's plain version on x's
    batch statistics, scale, mean, inv_std."""
    x, scale, bias = _args(shape, dtype, device, seed)[:3]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    g = torch.empty_like(x).normal_(generator=gen)  # x's (and y's) layout
    mean, var, inv = fused_abn.bn_stats_ref(x)
    y = fused_abn.fused_bn_leaky_relu_ref(x, scale, bias, mean, var, 1e-5, 1e-3)
    return x, g, y, scale, mean, inv


def _assert_sums_close(got, want, terms, name):
    """Per channel: |got − want| <= SUM_ULPS · 2^-24 · Σ|term|."""
    atol = SUM_ULPS * 2.0 ** -24 * terms.abs().sum(0)
    err = (got - want).abs()
    assert (err <= atol).all(), (
        f"{name}: max |err| {err.max().item()}, where the limit is "
        f"{atol[err.argmax()].item()}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", TRAIN_ABN,
                         ids=lambda s: "x".join(map(str, s)))
def test_training_kernels_match_plain_versions(cuda, shape, dtype):
    stats_tol, dx_tol = TRAIN_TOL[dtype]
    x, g, y, scale, mean, inv = _train_args(shape, dtype, cuda)
    got = fused_abn.bn_stats(x)
    for a, b, name in zip(got, fused_abn.bn_stats_ref(x),
                          ("mean", "var", "inv_std")):
        torch.testing.assert_close(a, b, atol=stats_tol, rtol=stats_tol,
                                   msg=name)

    ds, db = fused_abn.abn_grad_sums(g, y, x, mean, inv, 1e-3)
    ds_ref, db_ref = fused_abn.abn_grad_sums_ref(g, y, x, mean, inv, 1e-3)
    rows = fused_abn._rows
    dy = fused_abn._gated(rows(g), rows(y), 1e-3)
    _assert_sums_close(db, db_ref, dy, "dbias")
    _assert_sums_close(ds, ds_ref, dy * (rows(x) - mean) * inv, "dscale")

    # K1d on K1r's sums, against its plain version on the same sums
    dx = fused_abn.abn_grad_input(g, y, x, scale, mean, inv, ds, db, 1e-3)
    dx_ref = fused_abn.abn_grad_input_ref(g, y, x, scale, mean, inv, ds, db,
                                          1e-3)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dx.stride() == x.stride()
    torch.testing.assert_close(dx.float(), dx_ref.float(), atol=dx_tol,
                               rtol=dx_tol)
    # and the pair against the line-for-line `_bwd` oracle
    want = fused_abn.fused_bn_leaky_relu_backward_ref(g, x, y, scale, mean,
                                                      inv, 1e-3)
    torch.testing.assert_close(dx.float(), want[0].float(), atol=dx_tol,
                               rtol=dx_tol)
    _assert_sums_close(ds, want[1], dy * (rows(x) - mean) * inv, "dscale")
    _assert_sums_close(db, want[2], dy, "dbias")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_training_kernels_give_the_same_bits(cuda, dtype):
    """No floating-point atomics: a second launch of K1s, K1r and K1d on
    the same inputs gives the same bits, also at the stem's (32, 64, 56,
    56), the shape with the most partials a channel tile (one a row block
    of `sums_geometry`, whose last block adds them)."""
    for shape in [(32, 128, 56, 56), (32, 64, 56, 56), (1001, 37)]:
        x, g, y, scale, mean, inv = _train_args(shape, dtype, cuda, seed=4)
        runs = []
        for _ in range(2):
            ds, db = fused_abn.abn_grad_sums(g, y, x, mean, inv, 1e-3)
            runs.append((*fused_abn.bn_stats(x), ds, db,
                         fused_abn.abn_grad_input(g, y, x, scale, mean, inv,
                                                  ds, db, 1e-3)))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs)), shape


def _counters_are_zero(device):
    counters, _ = fused_abn._scratch[device.index or 0]
    return not counters.any().item()


def test_reductions_interleaved_give_the_same_bits_and_leave_counters_zero(
        cuda):
    """K1s and K1r on several shapes and both dtypes, interleaved (each
    launch reuses the per-card counters and workspace the one before
    used), then the first calls again: the same bits; and the counters are
    all 0 after every launch."""
    shapes = [(32, 256, 14, 14), (1001, 37), (32, 64, 56, 56), (393, 48),
              (32, 512, 7, 7)]
    cases = [_train_args(s, d, cuda, seed=7)
             for s in shapes for d in (torch.bfloat16, torch.float32)]

    def both(x, g, y, scale, mean, inv):
        return (*fused_abn.bn_stats(x),
                *fused_abn.abn_grad_sums(g, y, x, mean, inv, 1e-3))

    first = [both(*t) for t in cases]
    torch.cuda.synchronize()
    assert _counters_are_zero(cuda)
    for t, want in zip(reversed(cases), reversed(first)):
        got = both(*t)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), t[0].shape
        assert _counters_are_zero(cuda)


def test_reductions_refuse_a_geometry_they_do_not_take(cuda):
    """The C side checks the reductions' geometry on its own and refuses,
    with cudaErrorInvalidValue, K1's geometry and any that would leave a
    row or a channel out, launch an idle row block, a block of another
    size, lanes shorter than SUM_MIN_ROWS rows, or the vector path on a
    misaligned input; nothing launches,
    the counters stay 0, and the wrapper's own geometry still works."""
    x, g, y, scale, mean, inv = _train_args((32, 128, 28, 28), torch.float32,
                                            cuda)
    m, c = x.numel() // 128, 128
    sms = fused_abn.sm_count(x.get_device())
    good = fused_abn.sums_geometry(m, c, sms)
    assert good.gy > 1 and good.gx > 1
    lanes = good.ty * good.gy
    bad = {
        "K1's geometry": fused_abn.geometry(m, c, sms, True, 1),
        "K1's geometry, one row block":
            fused_abn.geometry(m, c, sms, True, 1)._replace(gy=1),
        "a row left out": good._replace(rows=good.rows - 1),
        "a channel tile left out": good._replace(gx=good.gx - 1),
        "idle channel tile": good._replace(gx=good.gx + 1),
        "idle row block": good._replace(gy=-(-m // good.ty) + 1,
                                        rows=1),
        "another block size": good._replace(ty=good.ty // 2),
        "short lanes": good._replace(gy=good.gy * 2,
                                     rows=-(-m // (lanes * 2))),
        "no block": good._replace(gy=0),
    }
    want = (fused_abn.bn_stats(x),
            fused_abn.abn_grad_sums(g, y, x, mean, inv, 1e-3))
    for why, geo in bad.items():
        for call in (lambda: fused_abn.bn_stats(x, geometry=geo),
                     lambda: fused_abn.abn_grad_sums(g, y, x, mean, inv, 1e-3,
                                                     geometry=geo)):
            with pytest.raises(RuntimeError,
                               match=f"CUDA error {CUDA_ERROR_INVALID_VALUE} "):
                call()
                pytest.fail(f"launched with {why}: {geo}")
    buf = torch.randn(m * c + 1, device=cuda)
    xm = buf[1:].view(m, c)
    with pytest.raises(RuntimeError,
                       match=f"CUDA error {CUDA_ERROR_INVALID_VALUE} "):
        fused_abn.bn_stats(xm, geometry=fused_abn.sums_geometry(m, c, sms))
    assert fused_abn.bn_stats(xm)[0].shape == (c,)  # the scalar path
    torch.cuda.synchronize()
    assert _counters_are_zero(cuda)
    again = (fused_abn.bn_stats(x),
             fused_abn.abn_grad_sums(g, y, x, mean, inv, 1e-3))
    torch.cuda.synchronize()
    for a, b in zip(want, again):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_training_kernels_refuse_what_they_do_not_take(cuda):
    x, g, y, scale, mean, inv = _train_args((2, 64, 4, 4), torch.bfloat16, cuda)
    meta = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="bn_stats: no kernel"):
        fused_abn.bn_stats(meta)
    with pytest.raises(ValueError, match="channels_last"):
        fused_abn.bn_stats(x.contiguous())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_abn.bn_stats(x.half())
    with pytest.raises(ValueError, match="g must match x's"):  # layout
        fused_abn.abn_grad_sums(g.contiguous(), y, x, mean, inv)
    with pytest.raises(ValueError, match="y must match x's"):  # dtype
        fused_abn.abn_grad_sums(g, y.float(), x, mean, inv)
    with pytest.raises(ValueError, match="inv_std must be"):
        fused_abn.abn_grad_sums(g, y, x, mean, inv[:32])
    ds, db = fused_abn.abn_grad_sums(g, y, x, mean, inv)
    with pytest.raises(ValueError, match="g must match x's"):
        fused_abn.abn_grad_input(g.contiguous(), y, x, scale, mean, inv, ds, db)
    with pytest.raises(ValueError, match="dbias must be"):
        fused_abn.abn_grad_input(g, y, x, scale, mean, inv, ds, db.cpu())


def test_training_launch_counts(cuda):
    x, g, y, scale, mean, inv = _train_args((2, 64, 4, 4), torch.bfloat16, cuda)
    counters = (fused_abn.bn_stats, fused_abn.abn_grad_sums,
                fused_abn.abn_grad_input)
    before = [f.launches for f in counters]
    fused_abn.bn_stats(x)
    ds, db = fused_abn.abn_grad_sums(g, y, x, mean, inv)
    fused_abn.abn_grad_input(g, y, x, scale, mean, inv, ds, db)
    fused_abn.abn_grad_input(g, y, x, scale, mean, inv, ds, db)
    fused_abn.bn_stats_ref(x)  # the plain versions count nothing
    fused_abn.bn_stats(x.cpu())  # CPU tensors: the plain version
    assert [f.launches for f in counters] == [before[0] + 1, before[1] + 1,
                                              before[2] + 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_abn_autograd_matches_the_plain_versions_autograd(cuda, monkeypatch,
                                                          dtype):
    """`batch_norm_leaky_relu` forward and gradients through K1s, K1, K1r
    and K1d against the same autograd Function with the four wrappers
    swapped for their plain versions, on the same CUDA tensors, at
    (32, 128, 28, 28); then the layout copy is not needed."""
    stats_tol, dx_tol = TRAIN_TOL[dtype]
    x0, scale0, bias0 = _args((32, 128, 28, 28), dtype, cuda, seed=5)[:3]
    gen = torch.Generator(device=cuda).manual_seed(6)
    weight = torch.randn((32, 28, 28, 128), device=cuda,
                         generator=gen).permute(0, 3, 1, 2)

    def run():
        x, scale, bias = (t.clone().requires_grad_() for t in (x0, scale0, bias0))
        y, mean, var = fused_abn.batch_norm_leaky_relu(x, scale, bias, 1e-5, 1e-3)
        (y.float() * weight).sum().backward()
        return [y.detach(), mean, var, x.grad, scale.grad, bias.grad]

    wrappers = [getattr(fused_abn, n) for n in (
        "fused_bn_leaky_relu", "bn_stats", "abn_grad_sums", "abn_grad_input")]
    before = [f.launches for f in wrappers]
    copies = fused_abn.FusedBNLeakyReLU.layout_copies
    got = run()
    assert [f.launches for f in wrappers] == [b + 1 for b in before]
    assert fused_abn.FusedBNLeakyReLU.layout_copies == copies
    for f in wrappers:
        monkeypatch.setattr(fused_abn, f.__name__,
                            getattr(fused_abn, f.__name__ + "_ref"))
    want = run()
    assert [f.launches for f in wrappers] == [b + 1 for b in before]
    for i, (a, b) in enumerate(zip(got, want)):
        tol = dx_tol if i in (0, 3) else stats_tol
        if i in (4, 5):  # dscale and dbias: sums over 25,088 rows
            tol = 1e-3
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=f"output {i}")


# ----------------------------------------------- K2-K4: flash attention --
# (B·H, T, causal): the ViT-B/16 slice shape, a ragged single tile, one
# aligned tile pair, causal over four tiles; for the edges of the bf16
# pipelines (TMA rings, causal skipping; K2 streams 128-row kv tiles to
# 128-row q blocks, K3/K4 64-row tiles): causal over five 64-row tiles (an
# odd count of streamed tiles), a single row, a single whole tile of one
# head, T = 1000, ragged across sixteen tiles, and T = 200 causal, where
# K2's diagonal tile also crosses T
FLASH_SHAPES = [(384, 1024, False), (24, 196, False), (24, 128, False),
                (24, 256, True), (2, 320, True), (1, 1, False), (1, 64, False),
                (4, 1000, False), (3, 200, True)]
# (O atol, gradient atol, rtol): f32 1e-4 (sums in another order); bf16
# compared in f32 at 1e-2 and 2e-2, a few times the kernels' largest error
# (one bf16 ulp of the output; P and dS are rounded to bf16 at the points
# the kernel and the plain version share)
FLASH_TOL = {torch.float32: (1e-4, 1e-4, 1e-4),
             torch.bfloat16: (1e-2, 1e-2, 2e-2)}
# (O, gradients): over each whole tensor, RMS(kernel - plain) stays within
# this share of RMS(plain), plus 1e-6 for references that are all but zero
# (T = 1's gradients). bf16: the kernels' gradients sit near 2e-4 (as
# chip_smoke.py logs), while the near misses of
# test_flash_comparison_rejects_a_wrong_dq exceed 1e-3; O sits near 2e-3,
# as K2's running max rounds P against another offset than the plain
# version's, while the near misses of
# test_flash_comparison_rejects_a_wrong_forward exceed 5e-3
FLASH_RMS_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (5e-3, 1e-3)}


def _assert_flash_close(got, want, atol, rtol, rms_tol):
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    err = (got - want).pow(2).mean().sqrt().item()
    ref = want.pow(2).mean().sqrt().item()
    assert err <= rms_tol * ref + 1e-6, f"RMS error {err} > {rms_tol} x RMS {ref}"


def _flash_inputs(bh, t, dtype, device, seed=0):
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(bh, t, fa.HEAD_DIM, device=device,
                               generator=g).to(dtype) for _ in range(4))
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bh,t,causal", FLASH_SHAPES,
                         ids=lambda x: str(x))
def test_flash_kernels_match_plain_versions(cuda, bh, t, causal, dtype):
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(bh, t, dtype, cuda)
    scale = fa.HEAD_DIM ** -0.5
    o_tol, g_tol, rtol = FLASH_TOL[dtype]
    out, lse = fa.flash_forward(q, k, v, scale, causal)
    ref_out, ref_lse = fa.flash_forward_ref(q, k, v, scale, causal)
    dsum = (do.float() * out.float()).sum(-1, keepdim=True)
    dq = fa.flash_dq(q, k, v, do, lse, dsum, scale, causal)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, dsum, scale, causal)
    ref_dq = fa.flash_dq_ref(q, k, v, do, lse, dsum, scale, causal)
    ref_dk, ref_dv = fa.flash_dkv_ref(q, k, v, do, lse, dsum, scale, causal)
    torch.cuda.synchronize()
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    assert lse.dtype == torch.float32 and lse.shape == (bh, t, 1)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    o_rms, g_rms = FLASH_RMS_TOL[dtype]
    _assert_flash_close(out, ref_out, o_tol, rtol, o_rms)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        _assert_flash_close(got, want, g_tol, rtol, g_rms)


@pytest.mark.parametrize("wrong", ["scale off by 1%", "one kv tile dropped",
                                   "dS not rounded"])
def test_flash_comparison_rejects_a_wrong_dq(cuda, wrong):
    """The bf16 comparison passes K3's dQ and refuses near misses of the
    plain version: dQ 1% too large, one 64-row kv tile left out of the sum
    over 16 tiles, or dS kept in f32 for its product with K (24 heads,
    T 1024)."""
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(24, 1024, torch.bfloat16, cuda, seed=7)
    scale = fa.HEAD_DIM ** -0.5
    out, lse = fa.flash_forward(q, k, v, scale)
    dsum = (do.float() * out.float()).sum(-1, keepdim=True)
    want = fa.flash_dq_ref(q, k, v, do, lse, dsum, scale)
    _, g_tol, rtol = FLASH_TOL[torch.bfloat16]
    g_rms = FLASH_RMS_TOL[torch.bfloat16][1]
    _assert_flash_close(fa.flash_dq(q, k, v, do, lse, dsum, scale), want,
                        g_tol, rtol, g_rms)
    _, ds = fa._p_ds(q, k, v, do, lse, dsum, scale, False)
    if wrong == "scale off by 1%":
        bad = want.float() * 1.01
    elif wrong == "one kv tile dropped":
        ds[:, :, 512:576] = 0
        bad = torch.matmul(ds.bfloat16().float(), k.float()) * scale
    else:
        bad = torch.matmul(ds, k.float()) * scale
    with pytest.raises(AssertionError):
        _assert_flash_close(bad.bfloat16(), want, g_tol, rtol, g_rms)


def _online_forward_without_rescale(q, k, v, scale, tile=64):
    """K2's online softmax over kv tiles of `tile` rows with the exp(m -
    m_new) rescale of the running sums left out: each tile's P·V and row
    sum keep the offset of the running max they were computed at."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    m = torch.full(s.shape[:2] + (1,), -1e30, device=s.device)
    acc = torch.zeros(q.shape, device=s.device)
    l = torch.zeros_like(m)
    for k0 in range(0, s.shape[-1], tile):
        st = s[:, :, k0:k0 + tile]
        m = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.exp(st - m)
        l = l + p.sum(-1, keepdim=True)
        acc = acc + torch.matmul(p.to(v.dtype).float(), v[:, k0:k0 + tile].float())
    return acc / l


@pytest.mark.parametrize("wrong", ["O 1% too large", "one kv tile dropped",
                                   "rescale left out"])
def test_flash_comparison_rejects_a_wrong_forward(cuda, wrong):
    """The bf16 O comparison passes K2's output and refuses near misses made
    from the plain math (24 heads, T 1024): O 1% too large, one 64-row kv
    tile left out of the softmax (of both l and P·V), and the online
    softmax over 64-row tiles with the exp(m - m_new) rescale of acc and l
    left out. What the O limit cannot see: P left unrounded (kept in f32
    for P·V) moves O by about a tenth of bf16's ulp and sits inside it, so
    this comparison does not show that K2 rounds P where the Pallas kernel
    does."""
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_inputs(24, 1024, torch.bfloat16, cuda, seed=11)
    scale = fa.HEAD_DIM ** -0.5
    want, want_lse = fa.flash_forward_ref(q, k, v, scale)
    o_tol, _, rtol = FLASH_TOL[torch.bfloat16]
    o_rms = FLASH_RMS_TOL[torch.bfloat16][0]
    out, lse = fa.flash_forward(q, k, v, scale)
    _assert_flash_close(out, want, o_tol, rtol, o_rms)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    if wrong == "O 1% too large":
        bad = want.float() * 1.01
    elif wrong == "one kv tile dropped":
        s = fa._scores(q, k, scale, False)
        s[:, :, 512:576] = -1e30
        p = torch.exp(s - s.amax(-1, keepdim=True))
        bad = torch.matmul(p.bfloat16().float(), v.float()) / p.sum(-1, keepdim=True)
    else:
        bad = _online_forward_without_rescale(q, k, v, scale)
    with pytest.raises(AssertionError):
        _assert_flash_close(bad.bfloat16(), want, o_tol, rtol, o_rms)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(4, 64, torch.bfloat16, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_forward(q.half(), k.half(), v.half(), 0.125)
    with pytest.raises(ValueError, match=r"\(BH, T, 64\)"):
        x = torch.zeros(4, 64, 32, device=cuda, dtype=torch.bfloat16)
        fa.flash_forward(x, x, x, 0.125)
    with pytest.raises(ValueError, match="k must be"):
        fa.flash_forward(q, k[:, :32].contiguous(), v, 0.125)
    with pytest.raises(ValueError, match="v must be"):
        fa.flash_forward(q, k, v.cpu(), 0.125)
    with pytest.raises(ValueError, match="k must be"):
        fa.flash_forward(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, 0.125)
    lse = torch.zeros(4, 64, 1, device=cuda)
    with pytest.raises(ValueError, match="dsum must be"):
        fa.flash_dq(q, k, v, do, lse, lse.bfloat16(), 0.125)


def test_flash_backward_is_bitwise_deterministic(cuda):
    """K3 and K4 write every output element from one block, with no
    atomics: two launches on the same inputs at the ViT-B/16 slice shape
    (bf16) give the same bits."""
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(384, 1024, torch.bfloat16, cuda, seed=5)
    scale = fa.HEAD_DIM ** -0.5
    out, lse = fa.flash_forward(q, k, v, scale)
    dsum = (do.float() * out.float()).sum(-1, keepdim=True)
    first = (fa.flash_dq(q, k, v, do, lse, dsum, scale),
             *fa.flash_dkv(q, k, v, do, lse, dsum, scale))
    second = (fa.flash_dq(q, k, v, do, lse, dsum, scale),
              *fa.flash_dkv(q, k, v, do, lse, dsum, scale))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_forward_is_bitwise_deterministic(cuda):
    """K2 writes every output row from one block, with no atomics: two
    launches on the same inputs at the ViT-B/16 slice shape (bf16) give the
    same bits in O and lse."""
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_inputs(384, 1024, torch.bfloat16, cuda, seed=6)
    scale = fa.HEAD_DIM ** -0.5
    first = fa.flash_forward(q, k, v, scale)
    second = fa.flash_forward(q, k, v, scale)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bf16_forward_refuses_what_the_kernel_does_not_take(cuda):
    """The bf16 K2 reads q, k and v through TMA maps of contiguous
    (BH, T, 64) rows at 16-byte aligned addresses; the wrapper refuses
    anything else before a launch."""
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    bh, t = 4, 128
    q, k, v, _ = _flash_inputs(bh, t, torch.bfloat16, cuda)
    narrow = torch.zeros(bh, t, 32, device=cuda, dtype=torch.bfloat16)
    strided = torch.zeros(bh, t, 128, device=cuda, dtype=torch.bfloat16)[..., :64]
    buf = torch.zeros(bh * t * 64 + 8, device=cuda, dtype=torch.bfloat16)
    shifted = buf[1:1 + bh * t * 64].view(bh, t, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    before = fa.flash_forward.launches
    with pytest.raises(ValueError, match=r"\(BH, T, 64\)"):
        fa.flash_forward(narrow, narrow, narrow, 0.125)
    with pytest.raises(ValueError, match="k must be"):
        fa.flash_forward(q, strided, v, 0.125)
    with pytest.raises(ValueError, match="v must be"):
        fa.flash_forward(q, k, shifted, 0.125)
    with pytest.raises(ValueError, match="q must be"):
        fa.flash_forward(shifted, k, v, 0.125)
    with pytest.raises(ValueError, match="k must be"):
        fa.flash_forward(q, shifted, v, 0.125)
    assert fa.flash_forward.launches == before


def test_bf16_backward_refuses_what_the_kernels_do_not_take(cuda):
    """The bf16 K3/K4 read their operands through TMA maps of contiguous
    (BH, T, 64) rows at 16-byte aligned addresses; the wrappers refuse
    anything else before a launch."""
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    bh, t = 4, 128
    q, k, v, do = _flash_inputs(bh, t, torch.bfloat16, cuda)
    lse = torch.zeros(bh, t, 1, device=cuda)
    dsum = torch.zeros(bh, t, 1, device=cuda)
    narrow = torch.zeros(bh, t, 32, device=cuda, dtype=torch.bfloat16)
    strided = torch.zeros(bh, t, 128, device=cuda, dtype=torch.bfloat16)[..., :64]
    buf = torch.zeros(bh * t * 64 + 8, device=cuda, dtype=torch.bfloat16)
    shifted = buf[1:1 + bh * t * 64].view(bh, t, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    lse_buf = torch.zeros(bh * t + 4, device=cuda)
    lse_shifted = lse_buf[1:1 + bh * t].view(bh, t, 1)
    for fn in (fa.flash_dq, fa.flash_dkv):
        with pytest.raises(ValueError, match=r"\(BH, T, 64\)"):
            fn(narrow, narrow, narrow, narrow, lse, dsum, 0.125)
        with pytest.raises(ValueError, match="v must be"):
            fn(q, k, strided, do, lse, dsum, 0.125)
        with pytest.raises(ValueError, match="do must be"):
            fn(q, k, v, shifted, lse, dsum, 0.125)
        with pytest.raises(ValueError, match="lse must be"):
            fn(q, k, v, do, lse_shifted, dsum, 0.125)
        with pytest.raises(ValueError, match="q must be|operands must be"):
            fn(shifted, k, v, do, lse, dsum, 0.125)


def test_flash_launch_counts(cuda):
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(4, 128, torch.bfloat16, cuda)
    before = (fa.flash_forward.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    out, lse = fa.flash_forward(q, k, v, 0.125)
    dsum = (do.float() * out.float()).sum(-1, keepdim=True)
    fa.flash_dq(q, k, v, do, lse, dsum, 0.125)
    fa.flash_dkv(q, k, v, do, lse, dsum, 0.125)
    fa.flash_dkv(q, k, v, do, lse, dsum, 0.125)
    fa.flash_forward_ref(q, k, v, 0.125)  # the plain version counts nothing
    fa.flash_forward(q.cpu(), k.cpu(), v.cpu(), 0.125)  # CPU: the plain version
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == (before[0] + 1, before[1] + 1, before[2] + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_autograd_matches_the_plain_versions_autograd(cuda, monkeypatch, dtype):
    """flash_attention's forward and gradients through K2-K4 against the
    same autograd Function with the three wrappers swapped for their plain
    versions, on the same CUDA tensors, (B, T, H, D) = (2, 256, 3, 64). The
    loss weighs the output by seeded N(0, 1) values, so dO and the
    gradients are of order one, where the tolerances mean something."""
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(3)
    base = [torch.randn(2, 256, 3, 64, device=cuda, generator=g).to(dtype)
            for _ in range(3)]
    weight = torch.randn(2, 256, 3, 64, device=cuda, generator=g)

    def run():
        q, k, v = (x.clone().requires_grad_() for x in base)
        out = fa.flash_attention(q, k, v, causal=True)
        (out.float() * weight).sum().backward()
        return [out.detach()] + [x.grad for x in (q, k, v)]

    before = fa.flash_forward.launches, fa.flash_dq.launches, fa.flash_dkv.launches
    got = run()
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 1 for n in before)
    monkeypatch.setattr(fa, "flash_forward", fa.flash_forward_ref)
    monkeypatch.setattr(fa, "flash_dq", fa.flash_dq_ref)
    monkeypatch.setattr(fa, "flash_dkv", fa.flash_dkv_ref)
    want = run()
    o_tol, g_tol, rtol = FLASH_TOL[dtype]
    o_rms, g_rms = FLASH_RMS_TOL[dtype]
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_flash_close(a, b, o_tol if i == 0 else g_tol, rtol,
                            o_rms if i == 0 else g_rms)


def test_accumulated_step_launches_the_abn_family_once_a_microbatch(cuda):
    """A TResNet-M train step at `grad_accum` 4 (64 px, batch 8: four
    microbatches of 2) launches K1, K1s, K1r and K1d at each of the 36
    ABN sites once a microbatch: 36 × 4 each; the step is not skipped."""
    from ddp_classification_pytorch_tpu_torch.config import get_preset
    from ddp_classification_pytorch_tpu_torch.train.state import create_train_state
    from ddp_classification_pytorch_tpu_torch.train.steps import make_train_step

    cfg = get_preset("baseline")
    cfg.model.arch, cfg.model.dtype = "tresnet_m", "bfloat16"
    cfg.data.dataset, cfg.data.image_size, cfg.data.num_classes = (
        "synthetic", 64, 10)
    cfg.data.batch_size, cfg.parallel.grad_accum = 8, 4
    state = create_train_state(cfg, cuda, 1)
    step = make_train_step(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    images = torch.randint(0, 256, (8, 64, 64, 3), device=cuda, generator=g,
                           dtype=torch.uint8)
    labels = torch.randint(0, 10, (8,), device=cuda, generator=g,
                           dtype=torch.int32)
    wrappers = (fused_abn.fused_bn_leaky_relu, fused_abn.bn_stats,
                fused_abn.abn_grad_sums, fused_abn.abn_grad_input)
    for f in wrappers:
        f.launches = 0
    m = step(state, images, labels)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [36 * 4] * 4
    assert float(m["step_ok"]) == 1.0 and state.opt_count == 1


@pytest.mark.parametrize("depth", [1, 2])
def test_overlap_prefetcher_on_the_card_matches_the_synchronous_path(cuda,
                                                                     depth):
    """`data.h2d_overlap`'s fetcher thread beside the stager: the batches
    on the card, in order, bitwise those of depth 0 (the synchronous
    copy), over a shuffled loader."""
    from ddp_classification_pytorch_tpu_torch.data.device_prefetch import (
        DevicePrefetcher)
    from ddp_classification_pytorch_tpu_torch.data.loader import Loader
    from ddp_classification_pytorch_tpu_torch.data.synthetic import (
        SyntheticDataset)

    ld = Loader(SyntheticDataset(96, 32, 10, seed=4, out_dtype="uint8"), 8,
                shuffle=True, seed=4, num_workers=2)
    ld.set_epoch(1)
    want = [tuple(t.cpu() for t in b)
            for b in DevicePrefetcher(ld, cuda, depth=0)]
    pf = DevicePrefetcher(ld, cuda, depth=depth, overlap=True)
    got = [tuple(t.cpu() for t in b) for b in pf]
    assert pf.fetch_thread is not None and len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert all(a.device.type == "cpu" and torch.equal(a, b)
                   for a, b in zip(g, w))


GRAPH_SERVE = ["baseline", "--model", "tresnet_m", "--image_size", "64",
               "--num_classes", "10", "--dtype", "bfloat16", "--max_batch",
               "4", "--buckets", "1,2,4", "--batch_timeout_ms", "0",
               "--device", "cuda", "--selfcheck", "1"]


def _graph_engine(extra=()):
    from ddp_classification_pytorch_tpu_torch.cli import serve as serve_cli

    cfg = serve_cli.config_from_args(serve_cli.build_parser().parse_args(
        GRAPH_SERVE + list(extra)))
    return cfg, serve_cli.build_engine(cfg, torch.device("cuda"))


def _serve(engine, imgs):
    futures = [engine.submit(im) for im in imgs]
    assert engine.process_once() == len(imgs)
    return [f.result(timeout=60) for f in futures]


def _imgs(n, seed=0):
    import numpy as np

    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3)).astype(
        np.uint8)


def test_graph_engine_captures_a_graph_a_bucket_and_replays_eager_bits(cuda):
    """warmup() captures one CUDA graph per bucket (and builds nothing once
    K1 is built); each batch is a replay whose top-k is bitwise the eager
    predict's, and K1's counter rises 36 a replay."""
    import numpy as np

    fused_abn.build()
    _, engine = _graph_engine()
    fused_abn.fused_bn_leaky_relu.launches = 0
    engine.warmup()
    assert engine.graph_mode and engine.boot["captures"] == 3
    assert engine.boot["builds"] == 0
    assert sorted(engine._graphs) == [(0, 1), (0, 2), (0, 4)]
    assert fused_abn.fused_bn_leaky_relu.launches == 36 * 3  # eager passes
    for b in engine.buckets:
        imgs = _imgs(b, seed=b)
        before = fused_abn.fused_bn_leaky_relu.launches
        got = _serve(engine, imgs)
        assert fused_abn.fused_bn_leaky_relu.launches == before + 36
        p, i = engine._predict(engine._state, torch.from_numpy(imgs).to(cuda))
        np.testing.assert_array_equal(np.stack([g.indices for g in got]),
                                      i.cpu().numpy())
        np.testing.assert_array_equal(np.stack([g.scores for g in got]),
                                      p.cpu().numpy())
    assert engine.metrics.recompiles == 0
    engine.drain()


def test_graph_engine_hot_swap_copies_into_the_captured_weights(cuda):
    """A swap copies the new weights into the captured tensors at the batch
    boundary: the same model object, no capture, the new answers."""
    import numpy as np

    from ddp_classification_pytorch_tpu_torch.train.state import (
        create_served_model,
    )

    cfg, engine = _graph_engine()
    engine.warmup()
    served, total = engine._state, engine.compile_sentinel.total
    new = create_served_model(cfg, cuda)
    with torch.no_grad():
        for t in new.parameters():
            t.mul_(1.5)
    engine.swap_state(new, digest="d", generation=2)
    imgs = _imgs(4, seed=9)
    got = _serve(engine, imgs)
    assert engine._state is served and engine.compile_sentinel.total == total
    p, i = engine._predict(new, torch.from_numpy(imgs).to(cuda))
    np.testing.assert_array_equal(np.stack([g.scores for g in got]),
                                  p.cpu().numpy())
    assert all(g.digest == "d" and g.generation == 2 for g in got)
    with pytest.raises(ValueError, match="captured"):  # other shapes
        engine.swap_state(torch.nn.Linear(2, 2).to(cuda))
    engine.drain()


def test_graph_engine_strict_compile_on_a_steady_state_capture(cuda):
    from ddp_classification_pytorch_tpu_torch.analysis.compile_sentinel import (
        SteadyStateRecompile,
    )

    _, engine = _graph_engine(["--strict_compile"])
    engine.warmup()
    engine.drop_graph(2)
    futures = [engine.submit(im) for im in _imgs(2)]
    with pytest.raises(SteadyStateRecompile, match="capture:b2@cuda"):
        engine.process_once()
    assert engine.fatal_error is not None and engine.closed
    assert all(f.result(timeout=0).indices.shape == (5,) for f in futures)
    engine.drain()


# -------------------------------------------------- the model axis (35) --
# the ring against flash_attention on the whole T: each rounds its output
# and gradients to bf16 once, at different points of the sum (chip_smoke.py
# RING_TOL): (atol, RMS share)
RING_TOL = {torch.float32: ((1e-4, 1e-5), (1e-4, 1e-5)),
            torch.bfloat16: ((1e-2, 5e-3), (2e-2, 5e-3))}
# the gradients against the plain versions forwards included, bf16: the
# plain forward's own out feeds Δ, and the bf16 roundings of dS that the
# two sides' f32 dS straddle spread to an RMS share near 1.2e-3
# (chip_smoke.py LSE_GRAD_TOL); against K2 with the plain backwards they
# keep FLASH_RMS_TOL's 1e-3; f32 keeps FLASH_RMS_TOL's
LSE_GRAD_RMS = {torch.float32: 1e-5, torch.bfloat16: 2e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_with_lse_matches_the_plain_versions_autograd(cuda, monkeypatch,
                                                            dtype):
    """`flash_attention_with_lse` through K2-K4 under nonzero out and lse
    cotangents against the same Function on the plain versions, (2, 256,
    3, 64); its out bitwise `flash_attention`'s."""
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(35)
    base = [torch.randn(2, 256, 3, 64, device=cuda, generator=g).to(dtype)
            for _ in range(3)]
    w_out = torch.randn(2, 256, 3, 64, device=cuda, generator=g)
    w_lse = torch.randn(2, 3, 256, device=cuda, generator=g)

    def run():
        q, k, v = (x.clone().requires_grad_() for x in base)
        out, lse = fa.flash_attention_with_lse(q, k, v)
        ((out.float() * w_out).sum() + (lse * w_lse).sum()).backward()
        return [out.detach(), lse.detach()] + [x.grad for x in (q, k, v)]

    before = fa.flash_forward.launches, fa.flash_dq.launches, fa.flash_dkv.launches
    got = run()
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 1 for n in before)
    assert torch.equal(got[0], fa.flash_attention(*base))
    o_tol, g_tol, rtol = FLASH_TOL[dtype]
    # K2 with the plain backwards: K3/K4 and theirs on the same out, lse, Δ
    monkeypatch.setattr(fa, "flash_dq", fa.flash_dq_ref)
    monkeypatch.setattr(fa, "flash_dkv", fa.flash_dkv_ref)
    plain_bwd = run()
    assert torch.equal(got[0], plain_bwd[0])
    for a, b in zip(got[2:], plain_bwd[2:]):
        _assert_flash_close(a, b, g_tol, rtol, FLASH_RMS_TOL[dtype][1])
    monkeypatch.setattr(fa, "flash_forward", fa.flash_forward_ref)
    want = run()
    _assert_flash_close(got[0], want[0], o_tol, rtol, FLASH_RMS_TOL[dtype][0])
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-4)
    for a, b in zip(got[2:], want[2:]):
        _assert_flash_close(a, b, g_tol, rtol, LSE_GRAD_RMS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_shards_match_flash_attention(cuda, monkeypatch, n, causal,
                                                 dtype):
    """The flash ring's forward and backward over N token shards in one
    process (K2 N² times, K3 and K4 N² times; the causal ring skips the
    N(N−1)/2 future visits) against the same ring on the plain versions
    within the kernels' own limits (FLASH_TOL, FLASH_RMS_TOL: out against
    the plain forwards, the gradients against K2 with the plain
    backwards), and
    against `flash_attention` on the whole T (RING_TOL), (2, 512, 3,
    64)."""
    from ddp_classification_pytorch_tpu_torch.ops import attention as att
    from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(36)
    q, k, v, do = (torch.randn(2, 512, 3, 64, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*xs, causal=causal)
    out.backward(do)
    want = [out.detach()] + [x.grad for x in xs]
    before = fa.flash_forward.launches, fa.flash_dq.launches, fa.flash_dkv.launches

    def ring():
        outs, grads = att.ring_attention_shards(
            *(list(x.chunk(n, dim=1)) for x in (q, k, v, do)), causal=causal,
            use_flash=True)
        return [torch.cat(outs, 1)] + [torch.cat(x, 1) for x in grads]

    got = ring()
    visits = n * (n + 1) // 2 if causal else n * n
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(b + visits for b in before)
    # the gradients against K2 with the plain backwards (K3/K4 and theirs
    # on the same out, lse and Δ), out against the plain forwards
    monkeypatch.setattr(fa, "flash_dq", fa.flash_dq_ref)
    monkeypatch.setattr(fa, "flash_dkv", fa.flash_dkv_ref)
    plain = ring()[1:]
    monkeypatch.setattr(fa, "flash_forward", fa.flash_forward_ref)
    plain = ring()[:1] + plain
    o_tol, g_tol, rtol = FLASH_TOL[dtype]
    for i, (a, b, c) in enumerate(zip(got, plain, want)):
        _assert_flash_close(a, b, g_tol if i else o_tol, rtol,
                            FLASH_RMS_TOL[dtype][i > 0])
        atol, rms = RING_TOL[dtype][i > 0]
        _assert_flash_close(a, c, atol, rtol, rms)


@pytest.mark.parametrize("n", [2, 4])
def test_expert_shards_match_one_shard(cuda, n):
    """The EP combine over N expert shards in one process against the
    one-shard `moe_mlp`, bf16 (8 experts of 96, top-2, (2, 64, 192)):
    within 1e-2 of the largest output (chip_smoke.py MOE_ROUTE_TOL)."""
    from ddp_classification_pytorch_tpu_torch.models.vit import xavier_uniform_
    from ddp_classification_pytorch_tpu_torch.ops import moe

    g = torch.Generator(device=cuda).manual_seed(37)
    x = torch.randn(2, 64, 192, device=cuda, generator=g).to(torch.bfloat16)
    banks = [xavier_uniform_(torch.empty(8, 192, 96, device=cuda)),
             torch.randn(8, 96, device=cuda, generator=g) * 0.1,
             xavier_uniform_(torch.empty(8, 96, 192, device=cuda)),
             torch.randn(8, 192, device=cuda, generator=g) * 0.1]
    gates = moe.topk_gates(torch.randn(2, 64, 8, device=cuda, generator=g), 2)
    one = moe.moe_mlp(x, gates, *banks).float()
    got = moe.moe_mlp_shards(
        x, gates, [tuple(b.chunk(n)[i] for b in banks) for i in range(n)])
    assert got.dtype == torch.bfloat16
    assert (got.float() - one).abs().max() <= 1e-2 * one.abs().max()


def test_partial_fc_shards_match_the_dense_margin_ce(cuda):
    """The partial-FC CE over 4 class shards in one process against the
    dense margin + CE in f32 (B 64, D 64, C 1000; each feature near its
    label's weight row, so that the top-1 and top-3 counts are nonzero
    and differ): loss, counts, and the features' and weight's gradients
    within 1e-4, their RMS shares (and that of the weight rows no label
    names) within 1e-5 (chip_smoke.py CE_RMS_TOL)."""
    from ddp_classification_pytorch_tpu_torch.ops import arcface
    from ddp_classification_pytorch_tpu_torch.ops import sharded_head as sh

    g = torch.Generator(device=cuda).manual_seed(38)
    weight = torch.randn(1000, 64, device=cuda, generator=g)
    labels = torch.randint(0, 1000, (64,), device=cuda, generator=g)
    sigma = torch.linspace(0.5, 1.5, 64, device=cuda)[:, None]
    feats = (torch.nn.functional.normalize(weight[labels], dim=1)
             + sigma * torch.randn(64, 64, device=cuda, generator=g) / 8)
    f, w = feats.clone().requires_grad_(), weight.clone().requires_grad_()
    logits = arcface.arc_margin_logits(f, w, labels)
    loss = torch.nn.functional.cross_entropy(logits, labels)
    loss.backward()
    top = torch.topk(logits.detach(), 3, dim=1).indices == labels[:, None]
    f2, w2 = feats.clone().requires_grad_(), weight.clone().requires_grad_()
    got, t1, t3 = sh.arc_margin_ce_shards(f2, list(w2.chunk(4)), labels)
    got.backward()
    torch.testing.assert_close(got, loss.detach(), atol=1e-4, rtol=1e-4)
    want_t1, want_t3 = int(top[:, 0].sum()), int(top.any(1).sum())
    assert 0 < want_t1 < want_t3 < 64, (want_t1, want_t3)
    assert (int(t1), int(t3)) == (want_t1, want_t3)
    other = torch.ones(1000, dtype=torch.bool, device=cuda)
    other[labels] = False
    for a, b in ((f2.grad, f.grad), (w2.grad, w.grad),
                 (w2.grad[other], w.grad[other])):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        err = (a - b).pow(2).mean().sqrt().item()
        assert err <= 1e-5 * b.pow(2).mean().sqrt().item(), err


@pytest.mark.parametrize("stages,micro", [(2, 4), (4, 8)])
def test_gpipe_shards_match_the_sequential_stack(cuda, stages, micro):
    """`gpipe_shards` over S stages of ViT-B/16-width blocks (depth 4,
    dim 768, 12 heads, 196 tokens, batch 8, bf16) against the same blocks
    in order, forward and backward: out, the input's gradient and every
    parameter's within chip_smoke.py's PIPE_TOL (max |err| ≤ 6e-2 of the
    largest, RMS ≤ 1e-2 of the RMS; out 3e-2 / 5e-3), M + S − 1 ticks."""
    from ddp_classification_pytorch_tpu_torch.models.vit import Block
    from ddp_classification_pytorch_tpu_torch.ops import pipeline

    torch.manual_seed(39)
    blocks = [Block(768, 12, torch.bfloat16).to(cuda) for _ in range(4)]
    params = [p for b in blocks for p in b.parameters()]
    g = torch.Generator(device=cuda).manual_seed(39)
    x = torch.randn(8, 196, 768, device=cuda, generator=g).to(torch.bfloat16)
    dout = torch.randn(8, 196, 768, device=cuda, generator=g).to(torch.bfloat16)

    def fn(block, h):
        return block(h)[0]

    h = x.clone().requires_grad_()
    out = pipeline.stage_apply(fn, blocks, h)
    out.backward(dout)
    n = 4 // stages
    got = pipeline.gpipe_shards(
        fn, [blocks[i * n:(i + 1) * n] for i in range(stages)], x, micro, dout)
    assert got.ticks == micro + stages - 1

    def close(a, b, tol):
        d = (a.float() - b.float())
        assert d.abs().max() <= tol[0] * b.float().abs().max()
        assert d.pow(2).mean().sqrt() <= tol[1] * b.float().pow(2).mean().sqrt()

    close(got.out, out.detach(), (3e-2, 5e-3))
    close(got.dx, h.grad, (6e-2, 1e-2))
    grads = [gr for stage in got.grads for gr in stage]
    assert len(grads) == len(params)
    for a, p in zip(grads, params):
        close(a, p.grad, (6e-2, 1e-2))
