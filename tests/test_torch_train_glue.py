"""The train step's glue against the JAX package on CPU: the mask and bias
grad (train_glue.relu_bias_grad, plain and pool modes), H1's pool-index
mode, the level Function (conv2x2_pool_t) and the crop-folded dual
(conv2x2_dual_t on the uncropped skip), the skip side's weight gradient
and the skip gradient's un-crop.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its train route's pieces: the wrappers of nn/pallas/train.py
with their Pallas kernels in interpret mode (``SEG_PALLAS_INTERPRET=1``),
``pool4_select`` and ``packed_center_crop_flat`` of models/unet_fast.py.
Tolerances, per test: moves of values without arithmetic (masks, selects,
crops, the pool and its index) exactly; one sum of at most four values in
bf16, exactly (the same rounding); f32 products and their gradients 1e-4
relative (atol 1e-4: the packages sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from segmentation_tpu.models import unet_fast as jfast
from segmentation_tpu.nn.pallas import conv as jconv
from segmentation_tpu.nn.pallas import train as jtr
from segmentation_tpu_torch.nn.kernels import conv_bwd as cb
from segmentation_tpu_torch.nn.kernels import conv_flat as cf
from segmentation_tpu_torch.nn.kernels import train as ttr
from segmentation_tpu_torch.nn.kernels import train_glue as tg
from segmentation_tpu_torch.nn.packing import crop_packed, uncrop_packed

_DN = ("NHWC", "HWIO", "NHWC")
TOL = {"rtol": 1e-4, "atol": 1e-4}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("SEG_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("SEG_PALLAS_TRAIN", raising=False)


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=requires_grad)


def _bf16_bits(a):
    """A numpy bf16-valued f32 array → the port's bf16 tensor."""
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


# ------------------------------------------------------- mask and bias grad
@pytest.mark.parametrize("pad,shape", [(False, (2, 5, 7, 64)),
                                       (True, (2, 5, 7, 64)),
                                       (True, (3, 1, 1, 64))])
def test_relu_bias_grad_matches_jax_mask_and_db(np_rng, pad, shape):
    """gm = JAX's _mask(g, y) and db = _db(gm) (f32: db 1e-5 relative);
    the buffer's margin is zero and its window gm."""
    n, h, w, c4 = shape
    g = np_rng.normal(size=shape).astype(np.float32)
    y = np.maximum(np_rng.normal(size=g.shape), 0).astype(np.float32)
    want_gm = np.asarray(jtr._mask(jnp.asarray(g), jnp.asarray(y), True))
    want_db = np.asarray(jtr._db(jnp.asarray(want_gm),
                                 jnp.zeros(c4, jnp.float32)))
    gm, db = (t.numpy() for t in tg.relu_bias_grad(_t(g), _t(y), pad=pad))
    assert gm.shape == ((n, h + 1, w + 1, c4) if pad else g.shape)
    np.testing.assert_array_equal(gm[:, :h, :w], want_gm)
    assert not gm[:, h:].any() and not gm[:, :, w:].any()
    np.testing.assert_allclose(db, want_db, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_g", [True, False])
def test_relu_bias_grad_pool_matches_jax_pool4_select_vjp(np_rng, with_g):
    """The pool mode in bf16: dy = g + pool4_select's VJP of gp (JAX's,
    from the same x4), masked: bit for bit, -0 cotangents included."""
    x4 = np.maximum(np_rng.normal(size=(2, 4, 6, 128)), 0)
    x4[:, :, ::2] = 0.25  # four equal slots: the tie rule decides
    x4 = np.asarray(jnp.asarray(x4, jnp.bfloat16).astype(jnp.float32))
    gp = np_rng.normal(size=(2, 4, 6, 32)).astype(np.float32)
    gp[0, 0, 0, :4] = -0.0
    g = np_rng.normal(size=x4.shape).astype(np.float32)
    g[1, 1] = -0.0
    _, vjp = jax.vjp(jfast.pool4_select, jnp.asarray(x4, jnp.bfloat16))
    (d,) = vjp(jnp.asarray(gp, jnp.bfloat16))
    dy = d + jnp.asarray(g, jnp.bfloat16) if with_g else d
    want = jtr._mask(dy, jnp.asarray(x4, jnp.bfloat16), True)
    _, idx = cf.pool_select(_bf16_bits(x4))
    gm, db = tg.relu_bias_grad(_bf16_bits(g) if with_g else None,
                               _bf16_bits(x4), pool=(_bf16_bits(gp), idx))
    got = gm.view(torch.int16).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(want).view(np.int16))
    np.testing.assert_allclose(db.numpy(), np.asarray(
        want.astype(jnp.float32).sum((0, 1, 2))), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ H1 pool index
def test_pool_index_mode_matches_conv2x2_flat_and_pool4_select(interpret,
                                                              np_rng):
    """H1's pool_index plain mode against conv2x2_flat (interpret mode) →
    pool4_select's forward and its saved index (f32 y 1e-4; the pool and
    index of the same y exactly), with ties forced: zero input pixels
    under a bias tiled over the slots make four equal slots, a negative
    bias four zero ones."""
    x = np.abs(np_rng.normal(size=(2, 7, 9, 128))).astype(np.float32)
    x[:, :3] = 0.0
    w = (np_rng.normal(size=(2, 2, 128, 128)) * 0.05).astype(np.float32)
    b = np_rng.normal(size=32).astype(np.float32) * 0.1
    b[::4] = -3.0
    b4 = np.tile(b, 4)
    yj = jconv.conv2x2_flat(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b4))
    pj, idxj = jfast._pool4_argmax(yj)
    y, pooled, idx = cf.packed_conv2x2_plain(_t(x), _t(w), _t(b4),
                                            pool_index=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    best, first = cf.pool_select(_t(np.asarray(yj)))
    np.testing.assert_array_equal(first.numpy(), np.asarray(idxj))
    np.testing.assert_array_equal(best.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(
        cf.pool_select(y)[1].numpy()[:, :2], np.asarray(idxj)[:, :2])
    np.testing.assert_array_equal(pooled.numpy(), cf.pool_select(y)[0].numpy())
    assert (np.asarray(idxj)[:, :2] == 0).all()  # the tied rows: slot 0


# ---------------------------------------- the level and the crop-folded dual
@pytest.mark.parametrize("offset", [(2, 2), (3, 5), (1, 4)])
def test_level_and_crop_folded_dual_match_jax_chain(interpret, np_rng,
                                                   offset):
    """y, pooled, out and the loss, and the grads to x, w, b, up, wa, wb
    and the dual's bias, of the port's conv2x2_pool_t → conv2x2_dual_t(skip
    uncropped, offset) against JAX's conv2x2_t → pool4_select and
    packed_center_crop_flat → conv2x2_dual_t, f32 1e-4, at even and odd
    crop offsets (both axes odd, and one of each)."""
    def nrm(*shape, scale=1.0):
        return (np_rng.normal(size=shape) * scale).astype(np.float32)

    x = nrm(2, 9, 11, 128)
    w1, b1 = nrm(2, 2, 128, 128, scale=0.05), nrm(128, scale=0.1)
    up = np.abs(nrm(2, 6, 7, 128))
    wa, wb = (nrm(2, 2, 128, 128, scale=0.05) for _ in range(2))
    b2 = nrm(128, scale=0.1)
    cot_o = nrm(2, 5, 6, 128)
    cot_p = nrm(2, 8, 10, 32)
    args = (x, w1, b1, up, wa, wb, b2)

    def jloss(x, w1, b1, up, wa, wb, b2):
        skip = jtr.conv2x2_t(x, w1, b1)
        pooled = jfast.pool4_select(skip)
        sk = jfast.packed_center_crop_flat(skip, 32, (12, 14), offset)
        out = jtr.conv2x2_dual_t(sk, up, wa, wb, b2)
        return jnp.sum(out * cot_o) + jnp.sum(pooled * cot_p), (skip, out)

    (want_v, (want_skip, want_out)), want_g = jax.value_and_grad(
        jloss, argnums=tuple(range(7)), has_aux=True)(
            *map(jnp.asarray, args))
    targs = [_t(a, requires_grad=True) for a in args]
    skip, pooled = ttr.conv2x2_pool_t(*targs[:3])
    out = ttr.conv2x2_dual_t(skip, *targs[3:], offset=offset)
    got_v = (out * _t(cot_o)).sum() + (pooled * _t(cot_p)).sum()
    got_v.backward()
    np.testing.assert_allclose(skip.detach().numpy(), np.asarray(want_skip),
                               **TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    np.testing.assert_allclose(got_v.item(), float(want_v), rtol=1e-4)
    for i, (a, w) in enumerate(zip(targs, want_g)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"operand {i}")


@pytest.mark.parametrize("offset", [(2, 4), (3, 3), (4, 1)])
def test_crop_wgrad_matches_xla_vjp(np_rng, offset):
    """conv2x2_wgrad_crop on the uncropped skip and the cotangent in its
    zero-margined buffer against jax.vjp of the conv of the crop (f32
    1e-4)."""
    skip = np_rng.normal(size=(3, 9, 10, 128)).astype(np.float32)
    hp, wp = 6, 6
    g4 = np_rng.normal(size=(3, hp - 1, wp - 1, 64)).astype(np.float32)
    sk = jfast.packed_center_crop_flat(jnp.asarray(skip), 32,
                                       (2 * hp, 2 * wp), offset)
    wk = jnp.zeros((2, 2, 128, 64), jnp.float32)
    _, vjp = jax.vjp(lambda w_: lax.conv_general_dilated(
        sk, w_, (1, 1), "VALID", dimension_numbers=_DN), wk)
    (want,) = vjp(jnp.asarray(g4))
    gp = np.zeros((3, hp, wp, 64), np.float32)
    gp[:, :-1, :-1] = g4
    got = cb.conv2x2_wgrad_crop(_t(skip), _t(gp), offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("offset", [(0, 0), (2, 4), (3, 3), (5, 2)])
def test_uncrop_is_the_crop_vjp_and_margin_zero_its_complement(np_rng,
                                                              offset):
    """The skip gradient's un-crop (the plain dual dgrad's) equals JAX's
    VJP of packed_center_crop_flat exactly; crop_margin_zero keeps that
    window and zeros the rest."""
    skip = np_rng.normal(size=(2, 8, 9, 64)).astype(np.float32)
    hp, wp = 5, 6
    g = np_rng.normal(size=(2, hp, wp, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda s: jfast.packed_center_crop_flat(
        s, 16, (2 * hp, 2 * wp), offset), jnp.asarray(skip))
    (want,) = vjp(jnp.asarray(g))
    got = uncrop_packed(_t(g), skip.shape, offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        crop_packed(got, g.shape, offset).numpy(), g)
    buf = tg.crop_margin_zero(_t(skip), hp, wp, offset)
    np.testing.assert_array_equal(
        buf.numpy(), np.where(np.asarray(want) != 0, skip, 0.0))
