"""The port's data layer against the JAX package's on the CPU.

Image files are written with cv2 into a temp dir from a seeded numpy
generator; both packages read the same files with the same seed. Every
comparison is exact (byte-equal batches): the host crop and the streams
are numpy and C++ code with the same draws, and the native loader is one
C++ source (csrc/dataloader.cc) that each package builds for itself. The
native tests skip only where g++ cannot build that source (no libjpeg or
libpng headers).

The slice test runs files → native u8 loader → DevicePrefetcher("cpu") →
fused_augment (plain version) → one train step of UNetS2D(levels=2) at
92², against the JAX package's loader → fused_augment (Pallas, interpret
mode) → its trainer (f32, XLA route) on the same params: byte-equal
batches, the loss within rtol 1e-3 and the params within the tolerance of
tests/test_torch_train_trainer.py (2·lr a step everywhere, 0.1·lr on
99.9 % of the elements).
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segmentation_tpu.data as jdata
from segmentation_tpu.data import native as jnative
from segmentation_tpu.data.augment import host_joint_random_crop as j_crop
from segmentation_tpu.data.datasets import ImageDataSet as JImageDataSet
from segmentation_tpu.data.datasets import ImageMaskDataSet as JImageMask
from segmentation_tpu.data.datasets import load_images as j_load_images
from segmentation_tpu.data.decode import decode_image as j_decode
from segmentation_tpu.data.pipeline import GeneratorDataSet as JGenerator
from segmentation_tpu.data.synthetic import SyntheticImages as JSynthImages
import segmentation_tpu_torch.data as data
from segmentation_tpu_torch.core.config import ModelConfig, TrainConfig
from segmentation_tpu_torch.data import native
from segmentation_tpu_torch.data.augment import host_joint_random_crop
from segmentation_tpu_torch.data.datasets import (
    ImageDataSet,
    ImageMaskDataSet,
    load_images,
)
from segmentation_tpu_torch.data.decode import decode_image
from segmentation_tpu_torch.data.pipeline import (
    DevicePrefetcher,
    GeneratorDataSet,
)
from segmentation_tpu_torch.data.synthetic import SyntheticImages

H, W, CROP, N_FILES = 44, 52, 32, 8


def _write_pairs(root, n, h, w, seed, corrupt=None):
    import cv2

    img_dir, mask_dir = root / "features", root / "labels"
    img_dir.mkdir()
    mask_dir.mkdir()
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    for i in range(n):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cy, cx, r = rng.integers(8, h - 8), rng.integers(8, w - 8), 6 + i
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        img[disc] = 250
        cv2.imwrite(str(img_dir / f"{i:03d}.jpg"), img)
        cv2.imwrite(str(mask_dir / f"{i:03d}.png"),
                    disc.astype(np.uint8) * 255)
    if corrupt is not None:
        (img_dir / f"{corrupt:03d}.jpg").write_bytes(b"not a jpeg")
    return str(img_dir), str(mask_dir)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return _write_pairs(tmp_path_factory.mktemp("pairs"), N_FILES, H, W, 0)


def _batches(ds, n=3):
    out = [ds.get_batch() for _ in range(n)]
    ds.stop()
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ------------------------------------------------------------ host crop
@pytest.mark.parametrize("hw,with_mask,flip", [
    ((40, 50), True, True), ((40, 50), False, False),
    ((20, 27), True, True),  # smaller than the crop: reflect pad
    ((35, 12), True, False),
])
def test_host_joint_random_crop_matches_jax(hw, with_mask, flip):
    src = np.random.default_rng(1)
    img = src.integers(0, 256, hw + (3,), dtype=np.uint8)
    mask = src.integers(0, 2, hw + (1,), dtype=np.uint8) if with_mask else None
    r_port, r_jax = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(6):  # several draws from one generator
        got = host_joint_random_crop(r_port, img, mask, 30, flip=flip)
        want = j_crop(r_jax, img, mask, 30, flip=flip)
        assert got[0].shape == (30, 30, 3)
        np.testing.assert_array_equal(got[0], want[0])
        if with_mask:
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got[1] is None and want[1] is None


def test_decode_image_matches_jax(pairs):
    img_dir, mask_dir = pairs
    for path, gray in ((os.path.join(img_dir, "000.jpg"), False),
                       (os.path.join(mask_dir, "000.png"), True),
                       (os.path.join(mask_dir, "001.png"), False)):
        got, want = decode_image(path, gray), j_decode(path, gray)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- python datasets
@pytest.mark.parametrize("threads,ratio,flip", [
    (1, 1.0, False), (3, 1.0, True), (3, 0.5, True)])
def test_image_mask_dataset_matches_jax(pairs, threads, ratio, flip):
    """Three batches of 3 cross the first epoch's end (8 files)."""
    kw = dict(batch_size=3, crop_size=CROP, threads=threads, seed=7,
              ratio=ratio, augment_flip=flip, capacity=16)
    got = _batches(ImageMaskDataSet(*pairs, **kw))
    want = _batches(JImageMask(*pairs, min_holding=4, **kw))
    _same(got, want)
    assert got[0]["image"].dtype == np.float32
    assert set(np.unique(got[0]["mask"])) <= {0, 1}


@pytest.mark.parametrize("threads", [1, 3])
def test_image_dataset_matches_jax(pairs, threads):
    kw = dict(batch_size=3, crop_size=CROP, threads=threads, seed=8,
              capacity=16)
    _same(_batches(ImageDataSet(pairs[0], **kw)),
          _batches(JImageDataSet(pairs[0], **kw)))


def test_decode_failure_sentinel_matches_jax(tmp_path):
    """An unreadable file is skipped in the same place of the stream."""
    dirs = _write_pairs(tmp_path, 6, H, W, 3, corrupt=2)
    kw = dict(batch_size=4, crop_size=CROP, threads=2, seed=1, capacity=8)
    got = _batches(ImageMaskDataSet(*dirs, **kw))
    _same(got, _batches(JImageMask(*dirs, **kw)))


def test_load_images_matches_jax(pairs):
    paths = sorted(os.path.join(pairs[0], f) for f in os.listdir(pairs[0]))
    got = load_images(paths, 5, 48, seed=3)  # 48 > 44: reflect pad
    want = j_load_images(paths, 5, 48, seed=3)
    assert got.shape == (5, 48, 48, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------- native loader
def _native_or_skip():
    if not native.available():
        pytest.skip(f"native loader unavailable: {native.build_error()}")
    if not jnative.available():
        pytest.skip(f"JAX native loader unavailable: {jnative.build_error()}")


@pytest.mark.parametrize("uint8_images,flip", [(True, False), (False, True)])
def test_native_image_mask_dataset_matches_jax(pairs, uint8_images, flip):
    _native_or_skip()
    kw = dict(batch_size=3, crop_size=CROP, threads=3, seed=11,
              augment_flip=flip, uint8_images=uint8_images)
    ours = native.NativeImageMaskDataSet(*pairs, **kw)
    theirs = jnative.NativeImageMaskDataSet(*pairs, **kw)
    got, want = _batches(ours, 4), _batches(theirs, 4)
    ours.close()
    theirs.close()
    _same(got, want)
    want_dtype = np.uint8 if uint8_images else np.float32
    assert got[0]["image"].dtype == want_dtype


def test_native_image_dataset_matches_jax(pairs):
    _native_or_skip()
    kw = dict(batch_size=3, crop_size=CROP, threads=2, seed=4)
    ours = native.NativeImageDataSet(pairs[0], **kw)
    theirs = jnative.NativeImageDataSet(pairs[0], **kw)
    got, want = _batches(ours), _batches(theirs)
    ours.close()
    theirs.close()
    _same(got, want)
    assert set(got[0]) == {"image"}


def test_native_builds_from_the_shared_source():
    _native_or_skip()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-3:] == ("segmentation_tpu_torch", "csrc",
                                           "build")
    assert native.SOURCE.parts[-2:] == ("csrc", "dataloader.cc")


def test_native_failed_build_reports_and_raises(tmp_path, monkeypatch):
    bad = tmp_path / "dataloader.cc"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert not native.available()
    err = native.build_error()
    assert "no_such_header_here.h" in err
    with pytest.raises(RuntimeError, match="no_such_header_here.h"):
        native.NativeImageMaskDataSet(str(tmp_path), str(tmp_path))
    assert not any((tmp_path / "build").glob("*"))


# ------------------------------------------------------------- pipeline
def _gen_batches(seed, n):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (2, 5, 5, 3), dtype=np.uint8),
             "mask": rng.integers(0, 2, (2, 5, 5, 1), dtype=np.uint8)}
            for _ in range(n)]


def test_generator_dataset_matches_jax():
    def gen_fn(worker_id):
        return iter(_gen_batches(worker_id, 3))

    ours = GeneratorDataSet(gen_fn, batch_size=2, threads=1)
    theirs = JGenerator(gen_fn, batch_size=2, threads=1)
    got = [ours.get_batch() for _ in range(5)]  # restarts after 3
    want = [theirs.get_batch() for _ in range(5)]
    ours.request_stop()
    theirs.request_stop()
    _same(got, want)


def test_prefetcher_over_generator_dataset_keeps_order():
    want = _gen_batches(0, 3)
    ds = GeneratorDataSet(lambda w: iter(want), batch_size=2, threads=1,
                          has_masks=True)
    pf = DevicePrefetcher(ds, device="cpu", depth=2)
    assert pf.batch_size == 2 and pf.has_masks  # delegated
    got = [pf.get_batch() for _ in range(6)]
    pf.stop()
    ds.request_stop()
    for g, w in zip(got, want + want):
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_prefetcher_finite_iterator_ends():
    want = _gen_batches(1, 3)
    pf = DevicePrefetcher(iter(want), device="cpu")
    got = list(pf)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
    with pytest.raises(StopIteration):
        next(pf)
    # staged batches are copies: the source may reuse its arrays
    want[0]["image"][...] = 0
    assert got[0]["image"].sum() > 0


def test_prefetcher_surfaces_a_source_crash():
    def source():
        yield _gen_batches(2, 1)[0]
        raise ValueError("decoder exploded")

    pf = DevicePrefetcher(source(), device="cpu")
    next(pf)
    with pytest.raises(RuntimeError) as info:
        next(pf)
    assert isinstance(info.value.__cause__, ValueError)


def test_prefetcher_stop_unblocks_a_full_queue():
    def forever():
        while True:
            yield {"image": np.zeros((1, 2, 2, 3), np.uint8)}

    pf = DevicePrefetcher(forever(), device="cpu", depth=1)
    next(pf)
    deadline = time.monotonic() + 10
    while not pf._q.full() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pf._q.full()  # the staging thread now waits on put
    t0 = time.monotonic()
    pf.stop()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert time.monotonic() - t0 < 5


@pytest.mark.parametrize("src", [
    torch.arange(12, dtype=torch.float32).reshape(3, 4),
    torch.tensor(3.5),                                   # 0-d
    torch.full((2, 3), 1.5, dtype=torch.bfloat16),       # no numpy dtype
    torch.tensor([True, False, True]),
    torch.arange(24).reshape(4, 6)[:, ::2],              # not contiguous
])
def test_copy_into_pinned_buffer_keeps_every_byte(src):
    """The staging copy (one host thread, through numpy) for any dtype."""
    from segmentation_tpu_torch.data.pipeline import _copy_bytes

    dst = torch.empty(src.shape, dtype=src.dtype)
    _copy_bytes(dst, src)
    assert torch.equal(dst, src)


def test_prefetcher_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        DevicePrefetcher(iter([]))


# ---------------------------------------------------- synthetic, exports
def test_synthetic_images_match_jax():
    ours = SyntheticImages(batch_size=3, hw=(20, 24), channels=3, seed=4)
    theirs = JSynthImages(batch_size=3, hw=(20, 24), channels=3, seed=4)
    for _ in range(2):
        got, want = ours.get_batch(), theirs.get_batch()
        assert set(got) == {"image"}
        np.testing.assert_array_equal(got["image"], want["image"])


def test_data_exports_match_jax_but_mnist():
    assert set(data.__all__) == set(jdata.__all__) - {"MNISTDataSet"}
    for name in data.__all__:
        assert getattr(data, name) is not None


# ------------------------------------------------------------- trainer
def test_trainer_defaults_to_the_card(tmp_path):
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.training.trainer import SegmentationTrainer

    cfg = ModelConfig(n_classes=2, input_dims=(92, 92), n_kernels=8)
    tcfg = TrainConfig(save_dir=str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            SegmentationTrainer(UNetS2D(cfg, levels=2), train_cfg=tcfg)
        return
    trainer = SegmentationTrainer(UNetS2D(cfg, levels=2), train_cfg=tcfg)
    assert all(p.device.type == "cuda" for p in trainer.model.parameters())


def test_place_keeps_a_batch_on_its_device(tmp_path):
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.training.trainer import SegmentationTrainer

    cfg = ModelConfig(n_classes=2, input_dims=(92, 92), n_kernels=8)
    trainer = SegmentationTrainer(UNetS2D(cfg, levels=2), device="cpu",
                                  train_cfg=TrainConfig(save_dir=str(tmp_path)))
    batch = {"image": torch.zeros((1, 92, 92, 3), dtype=torch.bfloat16),
             "mask": torch.zeros((1, 92, 92, 1), dtype=torch.uint8)}
    placed = trainer._place(batch)
    assert all(placed[k] is batch[k] for k in batch)  # no copy


# ----------------------------------------------------------- the slice
LR, B, TILE, HW = 1e-4, 2, 100, 92


@pytest.fixture(scope="module")
def slice_files(tmp_path_factory):
    return _write_pairs(tmp_path_factory.mktemp("slice"), 4, TILE, TILE, 9)


def test_data_path_slice_matches_jax(slice_files):
    """files → native u8 loader → prefetcher → fused_augment → one train
    step, both packages, same files, seed and crop offsets."""
    _native_or_skip()
    from segmentation_tpu.core.config import ModelConfig as JConfig
    from segmentation_tpu.core.config import TrainConfig as JTrainConfig
    from segmentation_tpu.data.synthetic import SyntheticSegmentation as JSynth
    from segmentation_tpu.models.base import SegmentationTrainer as JTrainer
    from segmentation_tpu.models.unet_fast import UNetS2D as JUNetS2D
    from segmentation_tpu.nn.pallas.augment import fused_augment as jfused
    from segmentation_tpu_torch import interop
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.nn.kernels.augment import (
        fused_augment_at,
        launches,
    )
    from segmentation_tpu_torch.training.trainer import SegmentationTrainer

    kw = dict(batch_size=B, crop_size=TILE, threads=2, seed=21,
              augment_flip=False, uint8_images=True)
    key = jax.random.PRNGKey(17)

    # JAX: its loader, the Pallas augment, its trainer
    old = os.environ.get("SEG_PALLAS_TRAIN")
    os.environ["SEG_PALLAS_TRAIN"] = "0"
    try:
        j_ds = jnative.NativeImageMaskDataSet(*slice_files, **kw)
        jb = j_ds.get_batch()
        j_ds.close()
        j_img, j_mask = jfused(key, jnp.asarray(jb["image"]),
                               jnp.asarray(jb["mask"]), crop=HW, flip=True,
                               interpret=True)
        mcfg = JConfig(name="unet", n_classes=2, input_dims=(HW, HW),
                       n_kernels=32)
        jt = JTrainer(JUNetS2D(mcfg, levels=2), JSynth(B, (HW, HW), seed=3),
                      None, mcfg,
                      JTrainConfig(save_dir=os.path.join(slice_files[0], "j"),
                                   compute_dtype="float32", learning_rate=LR))
        params0 = jax.device_get(jt.state.params)
        j_loss = jt.train_step(jt._place_batch(
            {"image": j_img, "mask": j_mask}))["seg_xentropy"]
        j_params = jax.device_get(jt.state.params)
    finally:
        if old is None:
            os.environ.pop("SEG_PALLAS_TRAIN")
        else:
            os.environ["SEG_PALLAS_TRAIN"] = old

    # the port: its loader, its prefetcher, H7's plain version, its trainer
    ds = native.NativeImageMaskDataSet(*slice_files, **kw)
    pf = DevicePrefetcher(ds, device="cpu", depth=2)
    b = pf.get_batch()
    pf.stop()
    ds.close()
    np.testing.assert_array_equal(b["image"].numpy(), jb["image"])
    np.testing.assert_array_equal(b["mask"].numpy(), jb["mask"])
    k_y, k_x, k_f = jax.random.split(key, 3)
    ys = jax.random.randint(k_y, (B,), 0, TILE - HW + 1)
    xs = jax.random.randint(k_x, (B,), 0, (TILE - HW) // 8 + 1) * 8
    flips = jax.random.bernoulli(k_f, 0.5, (B,)).astype(jnp.int32)
    img, mask = fused_augment_at(
        b["image"], b["mask"],
        *(torch.from_numpy(np.array(a)) for a in (ys, xs, flips)), HW)
    assert launches["crop_normalize"] == 0  # CPU: the plain version
    np.testing.assert_array_equal(img.numpy(), np.asarray(j_img))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))

    cfg = ModelConfig(n_classes=2, input_dims=(HW, HW), n_kernels=32)
    trainer = SegmentationTrainer(
        UNetS2D(cfg, levels=2, params=interop.params_from_jax(params0)),
        device="cpu",
        train_cfg=TrainConfig(save_dir=os.path.join(slice_files[0], "t"),
                              compute_dtype="float32", learning_rate=LR))
    loss = trainer.train_step({"image": img, "mask": mask})["seg_xentropy"]
    np.testing.assert_allclose(loss, j_loss, rtol=1e-3)
    diffs = np.concatenate([
        np.abs(p.detach().numpy() - np.asarray(j_params[n])).ravel()
        for n, p in trainer.model.params.items()])
    assert diffs.max() <= 2 * LR, diffs.max()
    assert np.mean(diffs <= 0.1 * LR) >= 0.999


def test_prefetcher_over_an_empty_source():
    pf = DevicePrefetcher(iter([]), device="cpu")
    assert list(pf) == []
    assert pf._thread.daemon
