"""The port's data path against the JAX package, on the CPU: transforms,
CIFAR, the folder scan, the native dataplane's batcher, the loader with
worker threads, the device prefetcher, the train-time flip, and one train
step of the reduced TResNet on a uint8 image batch with the flip; the
item route that stands in for the JAX package's PIL route (the native
decoder, PIL's BILINEAR resize and rotate in numpy, the four `Transform`
kinds on decoded files, `cli/train.py cdr` and `--transform cifar` on
folders).

All bitwise, except the train step: there f32 with the tolerances of the
TResNet slice's checks (loss 1e-5, grad norm 1e-2 relative, running
statistics 1e-3 relative to their largest value), weights carried by
`tresnet_from_jax`. The item route is bitwise on arrays PIL decoded; from
the file (libjpeg here, PIL's decoder there) it is held to PIXELS: at
most 2 grey levels apart on at least 99% of the pixel values (the two
decoders may round an IDCT differently).
"""

import copy
import functools
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ddp_classification_pytorch_tpu.config import get_preset as jax_preset
from ddp_classification_pytorch_tpu.data import cifar as jax_cifar
from ddp_classification_pytorch_tpu.data import imagefolder as jax_folder
from ddp_classification_pytorch_tpu.data import loader as jax_loader
from ddp_classification_pytorch_tpu.data import native as jax_native
from ddp_classification_pytorch_tpu.data import transforms as jax_tf
from ddp_classification_pytorch_tpu.models.factory import ClassifierModel as JaxClassifier
from ddp_classification_pytorch_tpu.models.tresnet import TResNet as JaxTResNet
from ddp_classification_pytorch_tpu.train import schedule as jax_schedule
from ddp_classification_pytorch_tpu.train import steps as jax_steps
from ddp_classification_pytorch_tpu.train.state import TrainState as JaxTrainState
from ddp_classification_pytorch_tpu_torch.config import get_preset
from ddp_classification_pytorch_tpu_torch.data import cifar, imagefolder, native
from ddp_classification_pytorch_tpu_torch.data import transforms as tf
from ddp_classification_pytorch_tpu_torch.data.device_prefetch import DevicePrefetcher
from ddp_classification_pytorch_tpu_torch.data.loader import Loader
from ddp_classification_pytorch_tpu_torch.data.synthetic import SyntheticDataset
from ddp_classification_pytorch_tpu_torch.models import tresnet
from ddp_classification_pytorch_tpu_torch.models.convert import tresnet_from_jax
from ddp_classification_pytorch_tpu_torch.models.factory import ClassifierModel
from ddp_classification_pytorch_tpu_torch.train import loop, schedule, steps
from ddp_classification_pytorch_tpu_torch.train.state import TrainState

from torch_port_helpers import OPTIM, REDUCED, init_variables, randomize_bn
from torch_port_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
JPEGS = [f"tests/data/torch_port_jpeg/img{i}.jpg" for i in range(8)]
PIXELS = dict(levels=2, share=0.99)


def _assert_pixels_close(got, want, msg=""):
    """Within PIXELS of each other (same shape and dtype)."""
    assert got.shape == want.shape and got.dtype == want.dtype, msg
    off = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert (off <= PIXELS["levels"]).mean() >= PIXELS["share"], (
        msg, int(off.max()), float((off > 0).mean()))


# -------------------------------------------------------------- transforms --

@pytest.mark.parametrize("wire", ["uint8", "float32"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_cifar_transform_matches_jax(train, wire):
    """Equal generators give equal pixels: the crop's two draws, then the
    host flip on the float32 wire only."""
    imgs = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3),
                                             dtype=np.uint8)
    mine = tf.build_transform("cifar", train, 32, out_dtype=wire)
    theirs = jax_tf.build_transform("cifar", train, 32, out_dtype=wire)
    for i, img in enumerate(imgs):
        a = mine(img, np.random.default_rng(i))
        b = theirs(Image.fromarray(img), np.random.default_rng(i))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_normalize_and_presets_match_jax():
    img = np.random.default_rng(1).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tf.normalize(img), jax_tf.normalize(img))
    np.testing.assert_array_equal(tf.IMAGENET_MEAN, jax_tf.IMAGENET_MEAN)
    np.testing.assert_array_equal(tf.IMAGENET_STD, jax_tf.IMAGENET_STD)
    for ds in ("imagefolder", "plc", "cifar10", "cifar100", "synthetic"):
        for t in jax_tf.TRANSFORM_PRESETS:
            assert tf.preset_for_dataset(ds, t) == jax_tf.preset_for_dataset(ds, t)
    for preset in jax_tf.TRANSFORM_PRESETS:
        for train in (True, False):
            a = tf.build_transform(preset, train, 224, 256, "uint8")
            b = jax_tf.build_transform(preset, train, 224, 256, "uint8")
            assert (a.kind, a.train, a.crop_size, a.out_size, a.out_dtype) == (
                b.kind, b.train, b.crop_size, b.out_size, b.out_dtype)
    # every kind runs on a decoded array now (the cdr rotation included)
    big = np.random.default_rng(2).integers(0, 256, (60, 80, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        tf.build_transform("cdr", True, 32, 40)(big, np.random.default_rng(0)),
        jax_tf.build_transform("cdr", True, 32, 40)(Image.fromarray(big),
                                                    np.random.default_rng(0)))


# ------------------------------------------- PIL's geometry, in numpy --

@pytest.mark.parametrize("size,box", [
    ((224, 224), None), ((256, 300), None), ((600, 500), None),
    ((224, 224), (10, 20, 300, 260)), ((64, 64), (3.5, 2.25, 200.5, 170.75)),
    ((500, 90), (0, 0, 375, 333))], ids=lambda v: str(v))
def test_resize_matches_pil(size, box):
    for path in JPEGS[:4]:
        with Image.open(path) as im:
            im = im.convert("RGB")
            want = np.asarray(im.resize(size, Image.BILINEAR, box=box))
            got = tf.resize(np.asarray(im), size, box)
        np.testing.assert_array_equal(got, want, err_msg=path)
        _assert_pixels_close(tf.resize(native.decode_image(path), size, box),
                             want, path)


@pytest.mark.parametrize("angle", [-14.3, 7.7, 0.01, 12.0])
def test_rotate_matches_pil(angle):
    for path in JPEGS[4:]:
        with Image.open(path) as im:
            im = im.convert("RGB")
            want = np.asarray(im.rotate(angle, Image.BILINEAR))
            np.testing.assert_array_equal(tf.rotate(np.asarray(im), angle),
                                          want, err_msg=path)
        _assert_pixels_close(tf.rotate(native.decode_image(path), angle),
                             want, path)


def test_random_resized_crop_boxes_are_bitwise_jax(monkeypatch):
    """The same generator gives the JAX function's box (PIL's resize is
    spied on) and the same pixels; the generators end in the same state."""
    boxes = []
    real = Image.Image.resize
    monkeypatch.setattr(Image.Image, "resize", lambda self, size, resample,
                        box=None: boxes.append(box) or real(self, size,
                                                            resample, box=box))
    for i, path in enumerate(JPEGS):
        for scale in ((0.08, 1.0), (0.8, 1.0), (1.5, 2.0)):  # the last: fallback
            with Image.open(path) as im:
                im = im.convert("RGB")
                r1, r2, r3 = (np.random.default_rng(i) for _ in range(3))
                want = np.asarray(jax_tf.random_resized_crop(im, r1, 48, scale))
                got = tf.random_resized_crop(np.asarray(im), r2, 48, scale)
                assert tf.crop_box(im.width, im.height, r3, scale) == boxes[-1]
            np.testing.assert_array_equal(got, want)
            assert r1.random() == r2.random() == r3.random()


@pytest.mark.parametrize("wire", ["uint8", "float32"])
@pytest.mark.parametrize("kind", ["cdr", "cifar", "baseline", "clothing1m"])
def test_item_route_transforms_match_jax_on_folders(tree, kind, wire):
    """Folder items through each kind, train and eval, decoded natively,
    against the JAX dataset's PIL route with the same generators."""
    for train in (True, False):
        mine = imagefolder.ImageFolderDataset.from_root(
            str(tree / "train"), transform=tf.build_transform(kind, train, 32, 40, wire))
        theirs = jax_folder.ImageFolderDataset.from_root(
            str(tree / "train"), jax_tf.build_transform(kind, train, 32, 40, wire))
        for i in range(len(mine)):
            a, la = mine.__getitem__(i, np.random.default_rng(i))
            b, lb = theirs.__getitem__(i, np.random.default_rng(i))
            assert la == lb
            if wire == "uint8":
                _assert_pixels_close(a, b, (kind, train, i))
            else:  # normalized: 2 levels of 255 over the smallest σ
                np.testing.assert_allclose(a, b, atol=2 / 255 / 0.224 + 1e-6)


# ------------------------------------------------------------------- CIFAR --

def _write_cifar(root, kind, rng):
    if kind == "cifar10":
        root = root / "cifar-10-batches-py"
        root.mkdir()
        for name, n in [(f"data_batch_{i}", 6) for i in range(1, 6)] + [
                ("test_batch", 4)]:
            with open(root / name, "wb") as f:
                pickle.dump({"data": rng.integers(0, 256, (n, 3072)).astype(np.uint8),
                             "labels": rng.integers(0, 10, n).tolist()}, f)
    else:
        root = root / "cifar-100-python"
        root.mkdir()
        for name, n in (("train", 12), ("test", 4)):
            with open(root / name, "wb") as f:
                pickle.dump({"data": rng.integers(0, 256, (n, 3072)).astype(np.uint8),
                             "fine_labels": rng.integers(0, 100, n).tolist()}, f)
    return str(root.parent)  # the parent: _find_root must descend


@pytest.mark.parametrize("kind", ["cifar10", "cifar100"])
def test_cifar_dataset_matches_jax(tmp_path, kind):
    root = _write_cifar(tmp_path, kind, np.random.default_rng(2))
    for train in (True, False):
        mine = cifar.CIFARDataset(root, train, tf.build_transform(
            "cifar", train, 32, out_dtype="uint8"), kind=kind)
        theirs = jax_cifar.CIFARDataset(root, train, jax_tf.build_transform(
            "cifar", train, 32, out_dtype="uint8"), kind=kind)
        np.testing.assert_array_equal(mine.images, theirs.images)
        np.testing.assert_array_equal(mine.labels, theirs.labels)
        assert mine.num_classes == theirs.num_classes
        for i in range(len(mine)):
            a = mine.__getitem__(i, np.random.default_rng(i))
            b = theirs.__getitem__(i, np.random.default_rng(i))
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]


def test_cifar_missing_files_error_matches_jax(tmp_path):
    errs = []
    for mod, tmod in ((cifar, tf), (jax_cifar, jax_tf)):
        with pytest.raises(FileNotFoundError, match="cannot download") as e:
            mod.CIFARDataset(str(tmp_path), True,
                             tmod.build_transform("cifar", True, 32))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ------------------------------------------------------------ image folder --

def _jpeg(path, rng, w, h):
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        path, quality=90)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """train/{a,b,c}/ and val/{a,b,c}/ of small JPEGs and PNGs (one RGBA,
    one grayscale), plus a file the scan must skip."""
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(3)
    for split, n in (("train", 5), ("val", 2)):
        for c, cls in enumerate("abc"):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n + c):
                w, h = int(rng.integers(40, 90)), int(rng.integers(40, 90))
                if i == 1:
                    mode = "RGBA" if c == 0 else "L"
                    arr = rng.integers(0, 256, (h, w, 4 if mode == "RGBA" else 1),
                                       dtype=np.uint8)
                    Image.fromarray(arr.squeeze(-1) if mode == "L" else arr,
                                    mode).save(d / f"{i}.png")
                else:
                    _jpeg(d / f"{i}.JPG" if i == 2 else d / f"{i}.jpg", rng, w, h)
            (d / "notes.txt").write_text("not an image")
    return root


@pytest.mark.parametrize("caps", [(0, 0), (3, 0), (0, 2), (2, 2)])
def test_scan_image_folder_matches_jax(tree, caps):
    assert (imagefolder.scan_image_folder(str(tree / "train"), *caps)
            == jax_folder.scan_image_folder(str(tree / "train"), *caps))


def _batchers(tree, split, train, wire, preset="baseline"):
    mine = imagefolder.ImageFolderDataset.from_root(str(tree / split))
    theirs = jax_folder.ImageFolderDataset.from_root(
        str(tree / split), jax_tf.build_transform(preset, train, 32, 40, wire))
    return (native.NativeBatcher(mine, preset, train, 32, 40, seed=7,
                                 num_threads=3, out_dtype=wire),
            jax_native.NativeBatcher(theirs, preset, train, 32, 40, seed=7,
                                     num_threads=3, out_dtype=wire))


@pytest.mark.parametrize("wire", ["uint8", "float32"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_native_batcher_matches_jax(tree, train, wire):
    mine, theirs = _batchers(tree, "train", train, wire)
    assert mine.out_size == theirs.out_size == (40 if train else 32)
    idx = np.array([0, 4, 5, 11, 13, 1, 6, 2])  # JPEGs and PNGs
    for epoch, b in ((0, 0), (0, 3), (2, 1)):
        a_img, a_lab = mine(idx, epoch, b)
        b_img, b_lab = theirs(idx, epoch, b)
        assert a_img.dtype == b_img.dtype == np.dtype(wire)
        np.testing.assert_array_equal(a_img, b_img)
        np.testing.assert_array_equal(a_lab, b_lab)
    # the seed moves with the epoch and the batch index (train crops)
    assert train == (not np.array_equal(mine(idx, 0, 0)[0], mine(idx, 1, 0)[0]))


def test_native_batcher_names_a_corrupt_file_and_takes_a_black_one(tmp_path):
    d = tmp_path / "train" / "x"
    d.mkdir(parents=True)
    rng = np.random.default_rng(4)
    _jpeg(d / "0.jpg", rng, 50, 40)
    Image.fromarray(np.zeros((40, 50, 3), np.uint8)).save(d / "1.png")
    (d / "2.jpg").write_bytes(b"\xff\xd8\xff\xe0 torn")
    ds = imagefolder.ImageFolderDataset.from_root(str(tmp_path / "train"))
    b = native.NativeBatcher(ds, "baseline", False, 32, 40, seed=0,
                             out_dtype="uint8")
    images, _ = b(np.array([0, 1]), 0, 0)  # the black image is no failure
    assert not images[1].any() and images[0].any()
    with pytest.raises(native.DataplaneDecodeError, match="2.jpg") as e:
        b(np.array([0, 1, 2]), 0, 0)
    assert "1.png" not in str(e.value)
    assert native.probe_image(str(d / "0.jpg")) == (50, 40)
    assert native.probe_image(str(d / "2.jpg")) is None


@pytest.mark.parametrize("fault", ["build", "load"])
def test_dataplane_build_failure_raises_with_the_compiler_output(
        monkeypatch, tmp_path, fault):
    """No build succeeds, or a library left by another machine does not
    load: the error says why, with the probe's findings; nothing falls
    back."""
    monkeypatch.setattr(native, "_lib", None)
    if fault == "build":
        monkeypatch.setattr(native, "LINK_VARIANTS", (("-lno_such_library_x",),))
        match = "no_such_library_x"
    else:
        stale = tmp_path / "libdataplane-stale.so"
        stale.write_bytes(b"not an ELF file")
        monkeypatch.setattr(native, "library_path", lambda variant: str(stale))
        match = "does not load"
    with pytest.raises(native.DataplaneUnavailable, match=match):
        native.get_lib()


# ------------------------------------------------------------------ loader --

def _synthetic(n):
    return SyntheticDataset(n, 8, 10, seed=5, out_dtype="uint8")


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_threaded_loader_matches_sync_and_jax(workers, shuffle):
    from ddp_classification_pytorch_tpu.data.synthetic import (
        SyntheticDataset as JaxSynthetic,
    )

    sync = Loader(_synthetic(37), 8, shuffle=shuffle, seed=999)
    threaded = Loader(_synthetic(37), 8, shuffle=shuffle, seed=999,
                      num_workers=workers, prefetch=2)
    theirs = jax_loader.ShardedLoader(
        JaxSynthetic(37, 8, 10, seed=5, out_dtype="uint8"), 8,
        shuffle=shuffle, seed=999, num_workers=workers, host_id=0, num_hosts=1)
    for epoch in (0, 1):
        for ld in (sync, threaded, theirs):
            ld.set_epoch(epoch)
        want = list(sync)
        for got in (list(threaded), list(theirs)):
            assert len(got) == len(want) == 5
            for (a, la), (b, lb) in zip(got, want):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(la, lb)
    threaded.close()
    theirs.close()


def test_loader_with_the_native_batcher_matches_jax(tree):
    mine_b, theirs_b = _batchers(tree, "train", True, "uint8")
    mine = Loader(mine_b.dataset, 4, shuffle=True, seed=11, num_workers=2,
                  batcher=mine_b)
    theirs = jax_loader.ShardedLoader(theirs_b.dataset, 4, shuffle=True,
                                      seed=11, num_workers=2,
                                      batcher=theirs_b, host_id=0, num_hosts=1)
    mine.set_epoch(3)
    theirs.set_epoch(3)
    got, want = list(mine), list(theirs)
    assert len(got) == len(want) == 5
    for (a, la), (b, lb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    theirs.close()


class _Boom:
    """A dataset whose item 3 raises."""

    def __len__(self):
        return 16

    def __getitem__(self, i, rng=None):
        if i == 3:
            raise OSError("item 3 is unreadable")
        return np.full((2, 2, 3), i, np.uint8), i % 2


def _alive(name):
    return [t for t in threading.enumerate() if t.name == name]


def test_loader_reraises_a_worker_error_and_stops_its_thread():
    ld = Loader(_Boom(), 4, shuffle=False, num_workers=2)
    with pytest.raises(OSError, match="item 3"):
        list(ld)
    ld.close()
    ld = Loader(_synthetic(64), 4, shuffle=False, num_workers=2, prefetch=1)
    it = iter(ld)
    next(it)
    assert _alive("loader")
    it.close()  # the consumer stops early: the producer is joined
    ld.close()
    assert not _alive("loader")


@pytest.mark.parametrize("depth", [0, 2])
def test_device_prefetcher_on_the_cpu_yields_the_loader_batches(depth):
    ld = Loader(_synthetic(20), 6, shuffle=False, seed=1, num_workers=2)
    pf = DevicePrefetcher(ld, CPU, depth=depth,
                          assemble=lambda b, hb: (*hb, ld.valid_mask(b)))
    for _ in range(2):  # one prefetcher serves every pass
        got = list(pf)
        want = list(ld)
        assert len(got) == len(want) == 4
        for b, (g, (images, labels)) in enumerate(zip(got, want)):
            assert all(isinstance(t, torch.Tensor) and t.device == CPU for t in g)
            np.testing.assert_array_equal(g[0].numpy(), images)
            np.testing.assert_array_equal(g[1].numpy(), labels)
            np.testing.assert_array_equal(g[2].numpy(), ld.valid_mask(b))
    assert pf.batches == 8 and pf.waited_s >= 0.0


def test_device_prefetcher_reraises_and_joins_on_early_stop():
    pf = DevicePrefetcher(Loader(_Boom(), 4, shuffle=False), CPU, depth=2)
    with pytest.raises(OSError, match="item 3"):
        list(pf)
    ld = Loader(_synthetic(64), 4, shuffle=False, num_workers=2)
    it = iter(DevicePrefetcher(ld, CPU, depth=1))
    next(it)
    assert _alive("device-stager") and _alive("loader")
    it.close()  # joins the stager, which closed the loader's pass
    ld.close()
    assert not _alive("device-stager") and not _alive("loader")


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_device_prefetcher_overlap_keeps_the_order_as_jax(depth):
    """`overlap` (the fetcher thread beside the stager, `data.h2d_overlap`)
    hands out the batches of the synchronous path in its order, as the
    JAX prefetcher's overlap mode does over the same loader; depth 0
    ignores the flag."""
    from ddp_classification_pytorch_tpu.data.device_prefetch import (
        DevicePrefetcher as JaxPrefetcher)

    ld = Loader(_synthetic(20), 6, shuffle=True, seed=3, num_workers=2)
    ld.set_epoch(1)
    want = list(DevicePrefetcher(ld, CPU, depth=0))
    pf = DevicePrefetcher(ld, CPU, depth=depth, overlap=True,
                          assemble=lambda b, hb: (*hb, np.array([b])))
    got = list(pf)
    jax_got = list(JaxPrefetcher(ld, depth=depth, overlap=True,
                                 assemble=lambda b, hb: hb))
    assert len(got) == len(want) == len(jax_got) == 4
    for b, (g, w, j) in enumerate(zip(got, want, jax_got)):
        for x, y, z in zip(g, w, j):
            assert torch.equal(x, y)
            np.testing.assert_array_equal(x.numpy(), z)
        assert int(g[2]) == b  # assemble saw the batches in order
    if depth:
        assert pf.fetch_thread and pf.stager_thread != pf.fetch_thread
    else:
        assert pf.fetch_thread is None and pf.stager_thread is None
    assert pf.batches == 4


def test_device_prefetcher_overlap_reraises_and_joins_both_threads():
    pf = DevicePrefetcher(Loader(_Boom(), 4, shuffle=False), CPU, depth=2,
                          overlap=True)
    with pytest.raises(OSError, match="item 3"):  # a loader error
        list(pf)

    def explode(b, hb):
        if b == 2:
            raise ValueError("bad batch 2")
        return hb

    ld = Loader(_synthetic(64), 4, shuffle=False, num_workers=2)
    with pytest.raises(ValueError, match="bad batch 2"):  # the fetcher's
        list(DevicePrefetcher(ld, CPU, depth=2, overlap=True,
                              assemble=explode))
    it = iter(DevicePrefetcher(ld, CPU, depth=1, overlap=True))
    next(it)
    assert _alive("device-stager") and _alive("host-fetcher")
    it.close()  # the consumer stops early: both threads joined
    ld.close()
    assert not (_alive("device-stager") or _alive("host-fetcher")
                or _alive("loader"))


# -------------------------------------------------------------------- flip --

def _jax_flip_mask(seed, step, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed + 1), step)
    return np.array(jax.random.bernoulli(
        jax.random.fold_in(key, jax_steps._FLIP_FOLD), 0.5, (n,)))


def test_device_flip_matches_jax_with_its_mask():
    imgs = np.random.default_rng(6).integers(0, 256, (8, 6, 10, 3), dtype=np.uint8)
    seed, step = 999, 5
    want = jax_steps.device_input_epilogue(
        jnp.asarray(imgs),
        jax.random.fold_in(jax.random.PRNGKey(seed + 1), step), flip=True)
    mask = _jax_flip_mask(seed, step, 8)
    assert 0 < mask.sum() < 8  # both kinds of sample in the batch
    consts = [torch.from_numpy(a).view(1, 3, 1, 1)
              for a in (tf.IMAGENET_MEAN, tf.IMAGENET_STD)]
    got = steps.device_input_epilogue(torch.from_numpy(imgs).permute(0, 3, 1, 2),
                                      *consts, torch.from_numpy(mask))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    # the port's own masks: a function of (seed, step) alone
    np.testing.assert_array_equal(steps.flip_mask(seed, step, 8),
                                  steps.flip_mask(seed, step, 8))
    assert not np.array_equal(steps.flip_mask(seed, 5, 64),
                              steps.flip_mask(seed, 6, 64))


@pytest.mark.parametrize("wire", ["uint8", "float32"])
@pytest.mark.parametrize("dataset", ["synthetic", "imagefolder", "cifar10",
                                     "cifar100", "plc"])
def test_train_flip_enabled_matches_jax(dataset, wire):
    cfgs = jax_preset("baseline"), get_preset("baseline")
    for cfg in cfgs:
        cfg.data.dataset, cfg.data.input_dtype = dataset, wire
    assert steps._train_flip_enabled(cfgs[1]) == jax_steps._train_flip_enabled(cfgs[0])


# ---------------------------------------------------- one train step, flip --

IMAGE, BATCH = 64, 4


@functools.lru_cache(maxsize=None)
def _reduced_jax_tresnet():
    """The reduced JAX TResNet and its init variables as numpy, made once
    a process (its parameters and statistics do not depend on the image
    size; callers copy before they change them)."""
    jmodel = JaxClassifier(backbone=JaxTResNet(dtype=jnp.float32, **REDUCED))
    return jmodel, jax.tree_util.tree_map(np.asarray,
                                          init_variables(jmodel, IMAGE))


def test_train_step_on_uint8_images_with_the_flip_matches_jax():
    """The reduced TResNet, f32, one step on an image batch on the uint8
    wire: the JAX step draws its flip mask from its key; the port's step
    is given that mask."""
    cfgs = jax_preset("baseline"), get_preset("baseline")
    for cfg in cfgs:
        cfg.model.arch = "tresnet_m"
        cfg.data.dataset, cfg.data.input_dtype = "imagefolder", "uint8"
        cfg.data.image_size, cfg.data.num_classes = IMAGE, 10
        cfg.data.batch_size = BATCH
        for k, v in OPTIM.items():
            setattr(cfg.optim, k, v)
    jcfg, cfg = cfgs
    jmodel, v = _reduced_jax_tresnet()
    params, stats = randomize_bn(v["params"], v["batch_stats"],
                                 np.random.default_rng(0))
    tx = jax_schedule.build_optimizer(jcfg.optim, 1)
    jstate = JaxTrainState(step=jnp.asarray(3, jnp.int32),
                           params=jax.tree_util.tree_map(jnp.asarray, params),
                           batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                           opt_state=tx.init(jax.tree_util.tree_map(jnp.asarray, params)))
    images = np.random.default_rng(7).integers(0, 256, (BATCH, IMAGE, IMAGE, 3),
                                               dtype=np.uint8)
    labels = np.array([1, 7, 3, 3], np.int32)
    jstate, jm = jax_steps.make_train_step(jcfg, jmodel, tx)(
        jstate, jnp.asarray(images), jnp.asarray(labels))

    model = ClassifierModel(tresnet.TResNet(dtype=torch.float32, **REDUCED))
    model.load_state_dict({f"backbone.{k}": t for k, t in
                           tresnet_from_jax(params, stats).items()})
    model.to(memory_format=torch.channels_last)
    state = TrainState(model, schedule.build_optimizer(cfg.optim,
                                                       model.parameters()),
                       schedule.build_schedule(cfg.optim, 1), step=3)
    step = steps.make_train_step(cfg)
    mask = _jax_flip_mask(cfg.run.seed, 3, BATCH)
    m = step(state, torch.from_numpy(images), torch.from_numpy(labels), mask)
    assert 0 < mask.sum() < BATCH
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-2)
    want = tresnet_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                            jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    got = model.backbone.state_dict()
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                       atol=1e-3 * float(w.abs().max()), err_msg=k)
    # without a mask the step draws flip_mask(seed, state.step, B) itself
    drawn = steps.flip_mask(cfg.run.seed, 4, BATCH)
    assert 0 < drawn.sum() < BATCH
    losses = [float(step(copy.deepcopy(state), torch.from_numpy(images),
                         torch.from_numpy(labels), flip)["loss"])
              for flip in (None, drawn, ~drawn)]
    assert losses[0] == losses[1] != losses[2]


def test_cifar_steps_then_eval_on_running_statistics_match_jax():
    """The CIFAR configuration (32 px, uint8 wire, the flip), reduced
    TResNet from the JAX init, f32: four train steps on both sides (the
    port given the JAX masks), then the eval step, which reads the running
    statistics those steps left (at 32 px stage 4 is 1x1: its BNs' batch
    statistics come from B rows). Loss, eval loss and every running
    statistic within the one-step test's tolerances."""
    n, px, n_steps = 8, 32, 4
    cfgs = jax_preset("baseline"), get_preset("baseline")
    for cfg in cfgs:
        cfg.model.arch = "tresnet_m"
        cfg.data.dataset, cfg.data.input_dtype = "cifar10", "uint8"
        cfg.data.image_size, cfg.data.num_classes = px, 10
        cfg.data.batch_size = n
        for k, v in OPTIM.items():
            setattr(cfg.optim, k, v)
    jcfg, cfg = cfgs
    assert steps._train_flip_enabled(cfg)
    jmodel, v = _reduced_jax_tresnet()
    v = jax.tree_util.tree_map(np.copy, v)
    tx = jax_schedule.build_optimizer(jcfg.optim, n_steps)
    jparams = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=jparams,
                           batch_stats=jax.tree_util.tree_map(
                               jnp.asarray, v["batch_stats"]),
                           opt_state=tx.init(jparams))
    model = ClassifierModel(tresnet.TResNet(dtype=torch.float32, **REDUCED))
    model.load_state_dict({f"backbone.{k}": t for k, t in tresnet_from_jax(
        v["params"], v["batch_stats"]).items()})
    model.to(memory_format=torch.channels_last)
    state = TrainState(model, schedule.build_optimizer(cfg.optim,
                                                       model.parameters()),
                       schedule.build_schedule(cfg.optim, n_steps))
    jstep = jax_steps.make_train_step(jcfg, jmodel, tx)
    step = steps.make_train_step(cfg)
    rng = np.random.default_rng(11)
    for k in range(n_steps):
        images = rng.integers(0, 256, (n, px, px, 3), dtype=np.uint8)
        labels = rng.integers(0, 10, n).astype(np.int32)
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
        m = step(state, torch.from_numpy(images), torch.from_numpy(labels),
                 _jax_flip_mask(cfg.run.seed, k, n))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {k}")
    images = rng.integers(0, 256, (n, px, px, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, n).astype(np.int32)
    valid = np.ones(n, np.float32)
    want = jax_steps.make_eval_step(jcfg, jmodel)(
        jstate, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(valid))
    got = steps.make_eval_step(cfg)(state, torch.from_numpy(images),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(valid))
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]),
                               rtol=1e-5)
    jwant = tresnet_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                             jax.tree_util.tree_map(np.asarray,
                                                    jstate.batch_stats))
    got = model.backbone.state_dict()
    for k, w in jwant.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                       atol=1e-3 * float(w.abs().max()),
                                       err_msg=k)


# ------------------------------------------------- datasets of the trainer --

def test_build_datasets_for_folders_and_cifar(tree, tmp_path):
    cfg = get_preset("baseline")
    cfg.data.dataset, cfg.data.train_dir = "imagefolder", str(tree / "train")
    cfg.data.val_dir = str(tree / "val")
    train, val = loop.build_datasets(cfg)
    assert (len(train), len(val), train.num_classes) == (18, 9, 3)
    assert isinstance(loop.make_native_batcher(train, cfg, True),
                      native.NativeBatcher)
    for transform in ("cdr", "cifar"):  # the item route: no batcher
        cfg.data.transform = transform
        train, val = loop.build_datasets(cfg)
        assert loop.make_native_batcher(train, cfg, True) is None
        assert (train.transform.kind, train.transform.train,
                val.transform.train) == (transform, True, False)
        assert loop.decodes_items(train)
    cfg = get_preset("baseline")
    cfg.data.dataset, cfg.data.num_classes = "cifar100", 100
    cfg.data.train_dir = _write_cifar(tmp_path, "cifar100",
                                      np.random.default_rng(8))
    train, val = loop.build_datasets(cfg)
    assert (len(train), len(val)) == (12, 4)
    assert loop.make_native_batcher(train, cfg, True) is None
    cfg.data.dataset = "plc"  # PLC's annotation layout: missing here
    with pytest.raises(FileNotFoundError, match="annotations"):
        loop.build_datasets(cfg)


def _small_tree(root, px=32):
    """train/ and val/ of two classes of px × px JPEGs."""
    rng = np.random.default_rng(12)
    for split in ("train", "val"):
        for cls in "ab":
            (root / split / cls).mkdir(parents=True)
            for i in range(3):
                _jpeg(root / split / cls / f"{i}.jpg", rng, px, px)
    return root


@pytest.mark.parametrize("workload,extra", [
    ("cdr", ["--image_size", "32", "--crop_size", "40"]),
    ("baseline", ["--transform", "cifar", "--image_size", "32"])],
    ids=["cdr", "cifar"])
def test_cli_trains_on_folders_through_the_item_route(tmp_path, capsys,
                                                      workload, extra):
    from ddp_classification_pytorch_tpu_torch.cli import train as train_cli

    root = _small_tree(tmp_path / "data")
    try:
        train_cli.main([workload, "--folder", str(root), "--model", "resnet18",
                        "--num_classes", "2", "--batchsize", "4", "--epochs", "1",
                        "--dtype", "float32", "--num_workers", "2",
                        "--device", "cpu", "--out", str(tmp_path / "run"),
                        *extra])
    except SystemExit as e:
        raise AssertionError(f"rc {e.code}") from None
    out = capsys.readouterr().out
    assert "native decoder active (item route, transform " in out
    assert (tmp_path / "run" / "ckpt_e0.pt").exists()


def test_decoder_build_failure_is_rc2_and_no_pil_fallback(monkeypatch, tmp_path):
    from ddp_classification_pytorch_tpu_torch.cli import train as train_cli

    monkeypatch.setattr(native, "_decoder", None)
    monkeypatch.setattr(native, "LINK_VARIANTS", (("-lno_such_library_x",),))
    with pytest.raises(native.DataplaneUnavailable, match="no_such_library_x"):
        native.decode_image(JPEGS[0])
    root = _small_tree(tmp_path / "data")
    with pytest.raises(SystemExit) as e:
        train_cli.main(["cdr", "--folder", str(root), "--model", "resnet18",
                        "--num_classes", "2", "--image_size", "32",
                        "--batchsize", "4", "--epochs", "1", "--device", "cpu",
                        "--out", str(tmp_path / "run")])
    assert e.value.code == 2
