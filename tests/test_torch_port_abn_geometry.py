"""K1's launch geometry (`ops/fused_abn.py::geometry`) and that of the
reductions K1s and K1r (`sums_geometry`), held on the CPU: the kernels
cannot run here, but the arithmetic that decides which rows and channels
each thread of `fused_abn.cu` and `fused_abn_train.cu` touches is computed
in Python and checked against a model of the kernels' loops.

The model (`_rows_visited`, `_groups_visited`) restates
`fused_abn_fwd_kernel`: thread (tx_i, ty_i) of block (bx, by) takes the
channel group g = bx * tx + tx_i (it returns at once unless g * vec < C)
and, for k = 0, 1, ... while its base row r = by * ty * R + ty_i +
k * gy * ty * R is below M (always for k = 0), rows r + j * ty for j < R,
each masked unless below M.

The reductions' model (`_lane_rows`, `_finalize_reads`) restates
`column_sums`: lane ty_i of row block by sums rows by * ty + ty_i +
k * ty * gy for k < rows, each masked unless below M; the last block of a
channel tile to finish adds the tile's gy partials, lane l those of
[l * run, (l + 1) * run) with run = ceil(gy / ty), in order.

The geometries are the same for both dtypes: a vector access is 4 channels,
16 bytes of f32 or 8 of bf16 (`fused_abn.VEC`), so bf16 and f32 inputs of
one shape launch alike.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ddp_classification_pytorch_tpu_torch.ops import fused_abn
from ddp_classification_pytorch_tpu_torch.ops.fused_abn import geometry

# every distinct ABN input of TResNet-M at 224 px, per image: (C, H, W)
TRESNET_M_ABN = [(64, 56, 56), (128, 56, 56), (128, 28, 28), (256, 28, 28),
                 (256, 14, 14), (512, 14, 14), (512, 7, 7)]
CHANNELS = [37, 48, 64, 128, 256, 512]
H100_SMS = 132
CUDA_MAX_BLOCK = 1024  # threads per block
CUDA_MAX_GRID_X, CUDA_MAX_GRID_Y = 2 ** 31 - 1, 65535


def _rows_visited(g, m):
    """(rows read and written, rows masked) by the threads of one channel
    group over the whole grid, as the kernel's row loop visits them."""
    tile = g.ty * g.rows
    step = tile * g.gy
    iters = -(-m // step) + 1
    by, ty_i, j, k = np.meshgrid(np.arange(g.gy), np.arange(g.ty),
                                 np.arange(g.rows), np.arange(iters),
                                 indexing="ij", sparse=True)
    base = by * tile + ty_i + k * step
    executed = (k == 0) | (base < m)
    row = np.broadcast_to(base + j * g.ty, np.broadcast_shapes(
        base.shape, j.shape))
    executed = np.broadcast_to(executed, row.shape)
    return row[executed & (row < m)], row[executed & (row >= m)]


def _groups_visited(g, c):
    bx, tx_i = np.meshgrid(np.arange(g.gx), np.arange(g.tx), indexing="ij")
    group = (bx * g.tx + tx_i).ravel()
    return group[group * g.vec < c]


def _check_geometry(m, c, sms, aligned=True):
    g = geometry(m, c, sms, aligned)
    # the vector path only where C divides into 4-channel groups and every
    # pointer is aligned
    assert g.vec in (1, fused_abn.VEC)
    if g.vec > 1:
        assert aligned and c % fused_abn.VEC == 0
    else:
        assert not aligned or c % fused_abn.VEC != 0
    assert g.rows in fused_abn.ROWS_PER_THREAD
    # CUDA's limits, and the card's: at most SMs x resident blocks
    assert 1 <= g.tx * g.ty <= fused_abn.MAX_THREADS <= CUDA_MAX_BLOCK
    assert 1 <= g.gx <= CUDA_MAX_GRID_X and 1 <= g.gy <= CUDA_MAX_GRID_Y
    assert g.gx * g.gy <= max(g.gx, sms * fused_abn.RESIDENT_BLOCKS)
    # every channel group once, none straddling C, no idle block column
    groups = _groups_visited(g, c)
    np.testing.assert_array_equal(np.sort(groups), np.arange(-(-c // g.vec)))
    assert (groups * g.vec + g.vec <= c).all()
    assert all(bx * g.tx * g.vec < c for bx in range(g.gx))
    # every row once, no idle block row, a ragged tail masked
    rows, masked = _rows_visited(g, m)
    np.testing.assert_array_equal(np.sort(rows), np.arange(m))
    assert (g.gy - 1) * g.ty * g.rows < m
    if m % (g.ty * g.rows):
        assert masked.size > 0 and (masked >= m).all()
    return g


@pytest.mark.parametrize("sms", [1, H100_SMS])
@pytest.mark.parametrize("bucket", [1, 8, 64])
@pytest.mark.parametrize("chw", TRESNET_M_ABN, ids=lambda s: "x".join(map(str, s)))
def test_tresnet_m_shapes_cover_every_element_once(chw, bucket, sms):
    c, h, w = chw
    g = _check_geometry(bucket * h * w, c, sms)
    assert g.vec == fused_abn.VEC  # every TResNet-M width takes the vector path


def test_bucket_64_stem_strides_past_the_old_clamp():
    """(64, 64, 56, 56): 200,704 rows, more row blocks than the 65,535 the
    first version's grid could name; the grid stays within the card and
    the row loop covers the rest."""
    m = 64 * 56 * 56
    g = _check_geometry(m, 64, H100_SMS)
    assert g.gy <= H100_SMS * fused_abn.RESIDENT_BLOCKS
    assert g.gy * g.ty * g.rows < m  # the row-stride loop runs


@pytest.mark.parametrize("m", [1, 7, 393, 1001])
@pytest.mark.parametrize("c", CHANNELS)
def test_ragged_rows_and_channels(m, c):
    _check_geometry(m, c, H100_SMS)


@pytest.mark.parametrize("c", CHANNELS)
def test_misaligned_pointers_take_the_scalar_path(c):
    assert _check_geometry(97, c, H100_SMS, aligned=False).vec == 1


@pytest.mark.parametrize("c,vec", [(48, 4), (37, 1), (44, 4), (6, 1), (8, 4),
                                   (1, 1), (4, 4), (1002, 1)])
def test_vector_width_follows_c(c, vec):
    assert geometry(100, c, H100_SMS).vec == vec
    assert geometry(100, c, H100_SMS, aligned=False).vec == 1


def test_rows_per_thread_grow_with_m():
    """Small launches spread over the SMs with one row a thread; large ones
    take the most rows a thread while every SM keeps TILES_PER_SM tiles."""
    small = geometry(8 * 7 * 7, 512, H100_SMS)
    large = geometry(64 * 56 * 56, 64, H100_SMS)
    assert small.rows == fused_abn.ROWS_PER_THREAD[0]
    assert large.rows == fused_abn.ROWS_PER_THREAD[-1]
    for m, c in [(8 * 56 * 56, 64), (8 * 14 * 14, 256), (8 * 28 * 28, 128)]:
        g = geometry(m, c, H100_SMS)
        tiles = -(-m // (g.ty * g.rows))
        assert tiles >= fused_abn.TILES_PER_SM * H100_SMS or g.rows == 1
        if g.rows < fused_abn.ROWS_PER_THREAD[-1]:
            more = -(-m // (g.ty * g.rows * 2))
            assert more < fused_abn.TILES_PER_SM * H100_SMS


def test_wide_scalar_rows_take_several_channel_tiles():
    """C = 1001 on the scalar path: 1001 groups need four blocks across a
    row, the last one partly idle but never empty."""
    g = _check_geometry(50, 1001, H100_SMS)
    assert (g.vec, g.tx, g.gx) == (1, fused_abn.MAX_THREADS, 4)


@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_forced_rows_are_kept(r):
    g = geometry(1001, 48, H100_SMS, True, r)
    assert g.rows == r
    rows, _ = _rows_visited(g, 1001)
    np.testing.assert_array_equal(np.sort(rows), np.arange(1001))


def test_geometry_is_cached_per_shape():
    assert geometry(1568, 256, H100_SMS) is geometry(1568, 256, H100_SMS)


@settings(max_examples=60, deadline=None)
@given(m=st.integers(1, 2_000_000), c=st.sampled_from(CHANNELS),
       sms=st.sampled_from([1, H100_SMS]), aligned=st.booleans())
def test_any_shape_covers_every_element_once(m, c, sms, aligned):
    _check_geometry(m, c, sms, aligned)


# ------------------------------------------ K1s and K1r: sums_geometry --
SUMS = fused_abn.sums_geometry
TRAIN_BATCH = 32


def _lane_rows(g, m):
    """(rows, lanes, masked): the rows every (row block, lane) pair of one
    channel group sums over the grid, as `column_sums` visits them, their
    flat lane index by * ty + ty_i, and the count of masked visits."""
    by, ty_i, k = np.meshgrid(np.arange(g.gy), np.arange(g.ty),
                              np.arange(g.rows), indexing="ij", sparse=True)
    row = by * g.ty + ty_i + k * g.ty * g.gy
    lane = np.broadcast_to(by * g.ty + ty_i, row.shape)
    live = row < m
    return row[live], lane[live], int((~live).sum())


def _finalize_reads(g):
    """The partials the finalize's lanes read, lane by lane in lane order."""
    run = -(-g.gy // g.ty)
    return [p for lane in range(g.ty)
            for p in range(lane * run, min(g.gy, (lane + 1) * run))]


def _check_sums_geometry(m, c, sms, aligned=True):
    g = SUMS(m, c, sms, aligned)
    assert _sums_takes(g, m, c)
    assert g.vec == geometry(m, c, sms, aligned).vec  # K1's vector rule
    # the block the kernels are built for, CUDA's limits and the card's
    assert g.ty == fused_abn.SUM_THREADS // g.tx
    assert 2 * g.vec <= g.ty  # the block holds its tile's 2 * tx * vec sums
    assert 1 <= g.tx * g.ty <= fused_abn.SUM_THREADS <= CUDA_MAX_BLOCK
    assert g.tx * g.vec <= fused_abn.SUM_TILE
    assert 1 <= g.gx <= CUDA_MAX_GRID_X and 1 <= g.gy <= CUDA_MAX_GRID_Y
    assert g.gx * g.gy <= max(g.gx, sms * fused_abn.SUM_BLOCKS_PER_SM)
    assert g.gx <= fused_abn.SUM_COUNTERS or c > 4 * fused_abn.SUM_COUNTERS
    # every channel group once, none straddling C, no idle channel tile
    groups = _groups_visited(g, c)
    np.testing.assert_array_equal(np.sort(groups), np.arange(-(-c // g.vec)))
    assert (groups * g.vec + g.vec <= c).all()
    assert all(bx * g.tx * g.vec < c for bx in range(g.gx))
    # every row once, and no row block without a row
    rows, lanes, _ = _lane_rows(g, m)
    np.testing.assert_array_equal(np.sort(rows), np.arange(m))
    per_block = np.bincount(lanes // g.ty, minlength=g.gy)
    assert (per_block > 0).all()
    # `rows` is the longest lane's count, exactly
    per_lane = np.bincount(lanes, minlength=g.gy * g.ty)
    assert per_lane.max() == g.rows
    # long partials: every lane sums SUM_MIN_ROWS rows where M allows,
    # else one row block takes them all
    if m >= fused_abn.SUM_MIN_ROWS * g.ty:
        assert per_lane.min() >= fused_abn.SUM_MIN_ROWS
    else:
        assert g.gy == 1
    # gy partials a channel tile, read by the finalize once each, in order
    assert _finalize_reads(g) == list(range(g.gy))
    return g


@pytest.mark.parametrize("sms", [1, H100_SMS])
@pytest.mark.parametrize("chw", TRESNET_M_ABN, ids=lambda s: "x".join(map(str, s)))
def test_sums_cover_every_element_once_at_the_train_step_shapes(chw, sms):
    c, h, w = chw
    g = _check_sums_geometry(TRAIN_BATCH * h * w, c, sms)
    assert g.vec == fused_abn.VEC


@pytest.mark.parametrize("m", [1, 7, 393, 1001])
@pytest.mark.parametrize("c", [37, 48, 512])
def test_sums_ragged_rows_and_channels(m, c):
    _check_sums_geometry(m, c, H100_SMS)
    _check_sums_geometry(m, c, H100_SMS, aligned=False)


def test_sums_train_step_partials_are_few_and_long():
    """At the batch-32 shapes, each channel tile has at most a block per SM
    of partials (PR 6's rule gave 528 per channel), and the grid holds at
    most one block an SM; the small 7 x 7 site narrows its tile (sixteen
    32-channel tiles of 512) and keeps its rows long."""
    for c, h, w in TRESNET_M_ABN:
        m = TRAIN_BATCH * h * w
        g = SUMS(m, c, H100_SMS)
        assert g.gx * g.gy <= H100_SMS and g.gy <= H100_SMS
        assert g.tx * g.vec == min(c, fused_abn.SUM_TILE)
        assert g.rows >= fused_abn.SUM_MIN_ROWS
    small = SUMS(TRAIN_BATCH * 7 * 7, 512, H100_SMS)
    assert (small.gx, small.gy, small.rows) == (16, 3, 17)


def _sums_takes(g, m, c):
    """A model of `sums_takes` in fused_abn_train.cu (aligned pointers):
    the block the kernels are built for, every channel group and row
    covered in `rows` steps, no idle tile or row block, long partials."""
    groups = -(-c // g.vec)
    lanes = g.ty * g.gy
    return ((g.vec == 1 or (g.vec == fused_abn.VEC and c % g.vec == 0))
            and 1 <= g.tx <= fused_abn.SUM_THREADS
            and g.ty == fused_abn.SUM_THREADS // g.tx and 2 * g.vec <= g.ty
            and 1 <= g.gy <= CUDA_MAX_GRID_Y
            and g.gx * g.tx >= groups > (g.gx - 1) * g.tx
            and (g.gy - 1) * g.ty < m
            and g.rows >= 1 and lanes * g.rows >= m > lanes * (g.rows - 1)
            and (g.gy == 1 or lanes * fused_abn.SUM_MIN_ROWS <= m))


def test_k1_geometry_is_refused_by_the_sums_check():
    """At every TResNet-M ABN shape (batch 1, 8 and 32) and the ragged ones,
    the reductions' check takes their own geometry and refuses K1's: its
    one row a lane over many row blocks leaves rows uncovered."""
    for c, h, w in TRESNET_M_ABN:
        for m in (h * w, 8 * h * w, TRAIN_BATCH * h * w):
            assert _sums_takes(SUMS(m, c, H100_SMS), m, c)
            assert not _sums_takes(geometry(m, c, H100_SMS, True, 1), m, c)
    for m, c in [(393, 48), (1001, 37)]:
        assert _sums_takes(SUMS(m, c, H100_SMS), m, c)
        assert not _sums_takes(geometry(m, c, H100_SMS, True, 1), m, c)


def test_sums_geometry_is_cached_per_shape():
    assert SUMS(6272, 256, H100_SMS) is SUMS(6272, 256, H100_SMS)


@settings(max_examples=60, deadline=None)
@given(m=st.integers(1, 2_000_000), c=st.sampled_from(CHANNELS + [1001]),
       sms=st.sampled_from([1, H100_SMS]), aligned=st.booleans())
def test_sums_any_shape_covers_every_element_once(m, c, sms, aligned):
    _check_sums_geometry(m, c, sms, aligned)
