"""The port's crop/flip/normalize (H7's plain version and the functions over
it) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides; where the
JAX function draws its own offsets from a key, the test draws them again
with the same ``jax.random`` calls and hands them to the port's
explicit-offset function. The Pallas kernel runs in interpret mode, as the
JAX package's own tests run it. Tolerance: none. Every value is one f32
multiply of a byte (bf16: that value rounded to nearest even) or a byte
copy, so both sides must agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_tpu.data.augment import device_augment as jax_device_augment
from segmentation_tpu.data.augment import one_hot_mask as jax_one_hot
from segmentation_tpu.nn.pallas.augment import fused_augment as jax_fused
from segmentation_tpu.nn.pallas.augment import pallas_crop_normalize
from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.data.augment import (
    device_augment,
    device_augment_at,
    one_hot_mask,
)
from segmentation_tpu_torch.nn.kernels import augment as aug

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(t: torch.Tensor) -> np.ndarray:
    """bf16 as f32 (exact), everything else as is."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _equal(got: torch.Tensor, want) -> None:
    want = _jnp(want)
    got = _np(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c", [1, 3])
def test_crop_normalize_plain_matches_pallas(c, dtype):
    """x offsets on and off the 8-px grid, flips on and off, in one batch:
    the port's pallas_crop_normalize (floor to 8) and crop_normalize_plain
    on the floored offsets both equal the Pallas kernel."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(c)
    imgs = rng.integers(0, 256, (4, 30, 44, c), dtype=np.uint8)
    ys = np.array([0, 7, 3, 14], np.int32)
    xs = np.array([8, 5, 16, 13], np.int32)
    flips = np.array([0, 1, 1, 0], np.int32)
    want = pallas_crop_normalize(jnp.asarray(imgs), jnp.asarray(ys),
                                 jnp.asarray(xs), jnp.asarray(flips),
                                 crop=16, out_dtype=jdt, interpret=True)
    t = [torch.from_numpy(a) for a in (imgs, ys, xs, flips)]
    _equal(aug.pallas_crop_normalize(*t, 16, tdt), want)
    _equal(aug.crop_normalize_plain(t[0], t[1], (t[2] // 8) * 8, t[3], 16,
                                    tdt), want)


def test_byte_map_is_the_multiply_not_a_division():
    """Every byte: the port's map equals the Pallas kernel's and XLA's
    device_augment, which both give v · f32(1/255); a true division would
    differ on 126 of them."""
    v = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    zeros = jnp.zeros((1,), jnp.int32)
    pallas = pallas_crop_normalize(jnp.asarray(v), zeros, zeros, zeros,
                                   crop=16, interpret=True)
    xla, _ = jax_device_augment(jax.random.PRNGKey(0), jnp.asarray(v), None,
                                crop=16, flip=False)
    table = aug.byte_table()
    np.testing.assert_array_equal(np.asarray(pallas).ravel(), table)
    np.testing.assert_array_equal(np.asarray(xla).ravel(), table)
    division = np.arange(256, dtype=np.float32) / np.float32(255)
    assert int((division != table).sum()) == 126


def _jax_fused_offsets(key, n, h, w, crop, flip):
    """fused_augment's draws (nn/pallas/augment.py:115-122)."""
    k_y, k_x, k_f = jax.random.split(key, 3)
    ys = jax.random.randint(k_y, (n,), 0, h - crop + 1)
    xs = jax.random.randint(k_x, (n,), 0, (w - crop) // 8 + 1) * 8
    flips = (jax.random.bernoulli(k_f, 0.5, (n,)).astype(jnp.int32)
             if flip else jnp.zeros((n,), jnp.int32))
    return [torch.from_numpy(np.asarray(a).astype(np.int32))
            for a in (ys, xs, flips)]


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_augment_matches_jax(dtype, flip):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    n, h, w, crop = 6, 40, 47, 24
    imgs = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    masks = rng.integers(0, 3, (n, h, w, 1), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    want_i, want_m = jax_fused(key, jnp.asarray(imgs), jnp.asarray(masks),
                               crop=crop, flip=flip, out_dtype=jdt,
                               interpret=True)
    ys, xs, flips = _jax_fused_offsets(key, n, h, w, crop, flip)
    got_i, got_m = aug.fused_augment_at(torch.from_numpy(imgs),
                                        torch.from_numpy(masks), ys, xs,
                                        flips, crop, tdt)
    _equal(got_i, want_i)
    _equal(got_m, want_m)


def test_fused_augment_mask_round_trip_keeps_every_byte():
    """JAX sends the mask through the kernel in f32 and back as
    round(m·255): that gives back each of the 256 bytes, so the port's
    byte copy is the same function."""
    m = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    img = np.zeros((1, 16, 16, 3), np.uint8)
    _, want = jax_fused(jax.random.PRNGKey(0), jnp.asarray(img),
                        jnp.asarray(m), crop=16, flip=False, interpret=True)
    np.testing.assert_array_equal(np.asarray(want), m)
    _, got = aug.fused_augment_at(torch.from_numpy(img), torch.from_numpy(m),
                                  [0], [0], [0], 16)
    np.testing.assert_array_equal(got.numpy(), m)


def test_fused_augment_draws_on_the_grid():
    """The port's own draws: x on the 8-px grid, image and mask cropped
    and flipped jointly."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (8, 36, 50, 3), dtype=np.uint8)
    masks = imgs[..., :1].copy()  # the mask is the image's channel 0
    out_i, out_m = aug.fused_augment(generator(3), torch.from_numpy(imgs),
                                     torch.from_numpy(masks), 24, flip=True,
                                     out_dtype=torch.float32)
    assert out_i.shape == (8, 24, 24, 3) and out_m.shape == (8, 24, 24, 1)
    want = torch.from_numpy(aug.byte_table())[out_m[..., 0].long()]
    assert torch.equal(out_i[..., 0], want)


@pytest.mark.parametrize("x_step,flip", [(1, True), (8, True), (8, False)])
def test_random_offsets_in_range_and_on_the_grid(x_step, flip):
    n, h, w, crop = 64, 40, 57, 24
    ys, xs, flips = aug.random_offsets(generator(5), (n, h, w, 3), crop,
                                       flip, x_step)
    for t in (ys, xs, flips):
        assert t.dtype == torch.int32 and t.shape == (n,)
    assert 0 <= int(ys.min()) and int(ys.max()) <= h - crop
    assert 0 <= int(xs.min()) and int(xs.max()) <= w - crop
    assert bool((xs % x_step == 0).all())
    assert set(flips.tolist()) == ({0, 1} if flip else {0})


def _jax_device_offsets(key, n, h, w, crop, flip):
    """device_augment's draws (data/augment.py:68-75)."""
    k_y, k_x, k_f = jax.random.split(key, 3)
    ys = jax.random.randint(k_y, (n,), 0, h - crop + 1)
    xs = jax.random.randint(k_x, (n,), 0, w - crop + 1)
    flips = (jax.random.bernoulli(k_f, 0.5, (n,)) if flip
             else jnp.zeros((n,), bool))
    return [torch.from_numpy(np.asarray(a).astype(np.int32))
            for a in (ys, xs, flips)]


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("n_classes", [0, 3])
def test_device_augment_matches_jax(n_classes, with_mask):
    rng = np.random.default_rng(7 + n_classes)
    n, h, w, crop = 5, 33, 41, 20
    imgs = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    # class 3 lies outside n_classes = 3: one-hot all zeros on both sides
    masks = rng.integers(0, 4, (n, h, w, 1), dtype=np.uint8)
    key = jax.random.PRNGKey(9)
    jm = jnp.asarray(masks) if with_mask else None
    want_i, want_m = jax_device_augment(key, jnp.asarray(imgs), jm, crop=crop,
                                        flip=True, n_classes=n_classes)
    ys, xs, flips = _jax_device_offsets(key, n, h, w, crop, True)
    got_i, got_m = device_augment_at(
        torch.from_numpy(imgs), torch.from_numpy(masks) if with_mask else None,
        ys, xs, flips, crop, n_classes)
    _equal(got_i, want_i)
    if with_mask:
        _equal(got_m, want_m)
    else:
        assert got_m is None and want_m is None


def test_device_augment_own_draws_in_range():
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (16, 30, 30, 3), dtype=np.uint8))
    got_i, got_m = device_augment(generator(1), imgs, imgs[..., :1], 29,
                                  flip=True, n_classes=0)
    assert got_i.shape == (16, 29, 29, 3) and got_i.dtype == torch.float32
    table = torch.from_numpy(aug.byte_table())
    assert torch.equal(got_i[..., 0], table[got_m[..., 0].long()])


@pytest.mark.parametrize("shape", [(2, 5, 6), (2, 5, 6, 1)])
def test_one_hot_mask_matches_jax(shape):
    m = np.random.default_rng(4).integers(0, 5, shape, dtype=np.uint8)
    _equal(one_hot_mask(torch.from_numpy(m), 4),
           jax_one_hot(jnp.asarray(m), 4))


def test_crop_normalize_rejects_what_it_cannot_take():
    x = torch.zeros((2, 10, 12, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        aug.crop_normalize(x, [0, 0], [0, 0], [0, 0], 11)
    with pytest.raises(TypeError):
        aug.crop_normalize(x.float(), [0, 0], [0, 0], [0, 0], 8)
    with pytest.raises(TypeError):
        aug.crop_normalize(x, [0, 0], [0, 0], [0, 0], 8, torch.float16)
    assert aug.launches["crop_normalize"] == 0
