"""The port's training pieces against the JAX package on CPU: the five
trainable packed-site Functions, the input-grad (dgrad) plain versions,
the weight gradient, pool4_select, the differentiable weight packing, the
packed crop, the losses and the synthetic data.

Inputs are made with numpy from a seed and handed to both packages. The
JAX wrappers run their Pallas kernels in interpret mode
(``SEG_PALLAS_INTERPRET=1``), as tests/test_pallas_train.py runs them, at
its shapes and tolerances (rtol 1e-3, atol 2e-3: the interpret-mode
kernels and XLA sum in other orders than PyTorch's CPU convs). The dgrads
are held to the Pallas dgrad kernels through pad_rows/unpad_rows, as
tests/test_conv_flat_bwd.py does (f32, 1e-4 relative). Pooling, packing
and cropping move values without arithmetic, so they are held exactly;
their VJPs sum at most four values (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from segmentation_tpu.data.synthetic import SyntheticSegmentation as JSynth
from segmentation_tpu.models import unet_fast as jfast
from segmentation_tpu.nn import shapes as jshapes
from segmentation_tpu.nn.pallas import train as jtr
from segmentation_tpu.nn.pallas.conv_flat import (
    pad_rows,
    stride_for,
    unpad_rows,
)
from segmentation_tpu.nn.pallas.conv_flat_bwd import (
    conv2x2_dgrad_dual_padflat,
    conv2x2_dgrad_padflat,
)
from segmentation_tpu.training import losses as jlosses
from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation
from segmentation_tpu_torch.models import unet_fast as tfast
from segmentation_tpu_torch.nn import shapes as tshapes
from segmentation_tpu_torch.nn.kernels import conv_bwd as cb
from segmentation_tpu_torch.nn.kernels import train as ttr
from segmentation_tpu_torch.nn.kernels import train_glue as tg
from segmentation_tpu_torch.nn.packing import crop_packed
from segmentation_tpu_torch.training import losses as tlosses

_DN = ("NHWC", "HWIO", "NHWC")


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=requires_grad)


def _sites(rng):
    """The five wrappers' operands at tests/test_pallas_train.py's shapes:
    (JAX wrapper, port Function, operands)."""
    def nrm(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {
        "conv2x2_t": (jtr.conv2x2_t, ttr.conv2x2_t,
                      (nrm(2, 7, 9, 128), nrm(2, 2, 128, 128, scale=0.05),
                       nrm(128))),
        "conv2x2_dual_t": (jtr.conv2x2_dual_t, ttr.conv2x2_dual_t,
                           (nrm(2, 6, 8, 128), nrm(2, 6, 8, 128),
                            nrm(2, 2, 128, 128, scale=0.05),
                            nrm(2, 2, 128, 128, scale=0.05), nrm(128))),
        "conv4x4s2_t": (jtr.conv4x4s2_t, ttr.conv4x4s2_t,
                        (nrm(2, 14, 18, 64), nrm(4, 4, 64, 128, scale=0.05),
                         nrm(128))),
        "matmul_rows_t": (jtr.matmul_rows_t, ttr.matmul_rows_t,
                          (nrm(2, 5, 9, 128), nrm(128, 128, scale=0.05),
                           nrm(128))),
        "deconv_packed_t": (jtr.deconv_packed_t, ttr.deconv_packed_t,
                            (nrm(2, 5, 7, 128), nrm(32, 128, scale=0.05),
                             nrm(128))),
    }


@pytest.mark.parametrize("site", ["conv2x2_t", "conv2x2_dual_t",
                                  "conv4x4s2_t", "matmul_rows_t",
                                  "deconv_packed_t"])
def test_function_matches_jax_wrapper(monkeypatch, np_rng, site):
    """Value and the grads to every operand of sum(f(...) · cot)."""
    monkeypatch.setenv("SEG_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("SEG_PALLAS_TRAIN", raising=False)
    jf, tf, args = _sites(np_rng)[site]
    probe = jf(*map(jnp.asarray, args))
    cot = np_rng.normal(size=probe.shape).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jf(*a) * cot)

    want_v, want_g = jax.value_and_grad(
        jloss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    targs = [_t(a, requires_grad=True) for a in args]
    got_v = (tf(*targs) * _t(cot)).sum()
    got_v.backward()
    np.testing.assert_allclose(got_v.item(), float(want_v), rtol=1e-3,
                               atol=2e-3)
    for i, (a, w) in enumerate(zip(targs, want_g)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=2e-3, err_msg=f"operand {i}")


def test_functions_take_relu_only(np_rng):
    x = _t(np_rng.normal(size=(1, 3, 3, 128)))
    w = _t(np_rng.normal(size=(2, 2, 128, 128)))
    with pytest.raises(ValueError, match="relu=True"):
        ttr.conv2x2_t(x, w, _t(np.zeros(128)), relu=False)
    # the dual takes the uncropped skip: its crop must cover up
    with pytest.raises(ValueError, match="does not cover"):
        ttr.conv2x2_dual_t(x[:, :2], x, w, w, _t(np.zeros(128)))
    with pytest.raises(ValueError, match="does not cover"):
        ttr.conv2x2_dual_t(x, x[:, :2], w, w, _t(np.zeros(128)),
                           offset=(3, 0))


# ------------------------------------------------------------------ dgrad
@pytest.mark.parametrize("n,h,w,c,o", [(2, 7, 6, 128, 128),
                                       (1, 6, 9, 256, 128),
                                       (2, 5, 5, 128, 256)])
def test_dgrad_plain_matches_pallas(np_rng, n, h, w, c, o):
    """dx of the packed 2×2 conv (odd and even sizes), f32."""
    wk = (np_rng.standard_normal((2, 2, c, o)) * 0.1).astype(np.float32)
    g4 = np_rng.standard_normal((n, h - 1, w - 1, o)).astype(np.float32)
    s = stride_for(w, jnp.float32)
    want = unpad_rows(conv2x2_dgrad_padflat(
        pad_rows(jnp.asarray(g4), s), jnp.asarray(wk), h_out=h, w_out=w,
        s=s, interpret=True), s, h, w)
    got = cb.packed_conv2x2_dgrad(_t(g4), _t(wk))
    assert tuple(got.shape) == (n, h, w, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n,h,w,c,o", [(2, 7, 6, 128, 128),
                                       (1, 5, 8, 256, 256)])
def test_dgrad_dual_plain_matches_pallas(np_rng, n, h, w, c, o):
    wa, wb = ((np_rng.standard_normal((2, 2, c, o)) * 0.1).astype(np.float32)
              for _ in range(2))
    g4 = np_rng.standard_normal((n, h - 1, w - 1, o)).astype(np.float32)
    s = stride_for(w, jnp.float32)
    want = conv2x2_dgrad_dual_padflat(
        pad_rows(jnp.asarray(g4), s), jnp.asarray(wa), jnp.asarray(wb),
        h_out=h, w_out=w, s=s, interpret=True)
    got = cb.packed_conv2x2_dgrad_dual(_t(g4), _t(wa), _t(wb))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(),
                                   np.asarray(unpad_rows(wt, s, h, w)),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("h,w", [(7, 6), (4, 9)])
def test_wgrad_and_bias_grad_match_xla_vjp(np_rng, h, w):
    """dw by the four row-shifted products on the zero-margined cotangent
    (read in place: no pad of g), and db, against jax.vjp of the conv
    (f32)."""
    x4 = np_rng.standard_normal((2, h, w, 128)).astype(np.float32)
    wk = (np_rng.standard_normal((2, 2, 128, 128)) * 0.1).astype(np.float32)
    g4 = np_rng.standard_normal((2, h - 1, w - 1, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda w_: lax.conv_general_dilated(
        jnp.asarray(x4), w_, (1, 1), "VALID", dimension_numbers=_DN),
        jnp.asarray(wk))
    (want,) = vjp(jnp.asarray(g4))
    gp = np.pad(g4, ((0, 0), (0, 1), (0, 1), (0, 0)))
    np.testing.assert_allclose(cb.conv2x2_wgrad(_t(x4), _t(gp)).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="x's grid"):
        cb.conv2x2_wgrad(_t(x4), _t(g4))
    # db is the glue's f32 sum of the masked cotangent (here y > 0 keeps
    # all of g)
    db = tg.relu_bias_grad(_t(g4), _t(np.ones_like(g4)))[1]
    np.testing.assert_allclose(db.numpy(),
                               g4.sum((0, 1, 2)), rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------ pool4_select
def test_pool4_select_matches_jax_with_ties(np_rng):
    """Post-ReLU values drawn from a few levels tie often; the forward and
    the argmax-index VJP (first slot that attains the max) are exact."""
    x = np.maximum(np_rng.integers(-2, 3, size=(2, 5, 6, 4 * 8)), 0)
    x = x.astype(np.float32)
    g = np_rng.normal(size=(2, 5, 6, 8)).astype(np.float32)
    y, vjp = jax.vjp(jfast.pool4_select, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = _t(x, requires_grad=True)
    yt = tfast.pool4_select(xt)
    yt.backward(_t(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))
    ties = (x.reshape(2, 5, 6, 4, 8) == np.asarray(y)[:, :, :, None]).sum(3)
    assert (ties > 1).mean() > 0.2  # the tie-break is exercised


# ---------------------------------------------------------------- packing
@pytest.mark.parametrize("s2", [False, True])
def test_torch_packing_matches_numpy_and_jnp_vjp(np_rng, s2):
    w = np_rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    pack_np = jfast.pack_conv3_weight_s2 if s2 else jfast.pack_conv3_weight
    pack_t = tfast.pack_conv3_weight_s2_t if s2 else tfast.pack_conv3_weight_t
    pack_j = (jfast.pack_conv3_weight_s2_jnp if s2
              else jfast.pack_conv3_weight_jnp)
    wt = _t(w, requires_grad=True)
    got = pack_t(wt)
    np.testing.assert_array_equal(got.detach().numpy(), pack_np(w))
    cot = np_rng.normal(size=got.shape).astype(np.float32)
    got.backward(_t(cot))
    _, vjp = jax.vjp(pack_j, jnp.asarray(w))
    (want,) = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("off", [(41, 41), (90, 90), (3, 4)])
def test_packed_crop_and_its_vjp_match_jax(np_rng, off):
    """Even offsets slice, odd ones take the slot phase; autograd of the
    slices is the JAX crop_flat_t VJP."""
    c, th, tw = 8, 20, 16
    hp, wp = (off[0] + th) // 2 + 2, (off[1] + tw) // 2 + 3
    x = np_rng.normal(size=(2, hp, wp, 4 * c)).astype(np.float32)
    g = np_rng.normal(size=(2, th // 2, tw // 2, 4 * c)).astype(np.float32)
    y, vjp = jax.vjp(lambda v: jfast.crop_flat_t(v, c, (th, tw), off),
                     jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = _t(x, requires_grad=True)
    yt = crop_packed(xt, (2, th // 2, tw // 2, 4 * c), off)
    yt.backward(_t(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))


# -------------------------------------------------- shapes, losses, data
@pytest.mark.parametrize("th,tw", [(5, 4), (9, 12), (12, 3)])
def test_center_crop_or_pad_matches_jax(np_rng, th, tw):
    x = np_rng.integers(0, 3, size=(2, 9, 7, 1)).astype(np.uint8)
    np.testing.assert_array_equal(
        tshapes.center_crop_or_pad(torch.from_numpy(x), th, tw).numpy(),
        np.asarray(jshapes.center_crop_or_pad(jnp.asarray(x), th, tw)))


@pytest.mark.parametrize("n_classes", [2, 3])
def test_losses_match_jax(np_rng, n_classes):
    logits = np_rng.normal(size=(2, 6, 5, n_classes)).astype(np.float32)
    masks = np_rng.integers(0, n_classes, size=(2, 6, 5, 1)).astype(np.uint8)
    pred = logits.argmax(-1)
    pairs = [
        (tlosses.segmentation_xentropy(_t(logits), torch.from_numpy(masks),
                                       n_classes),
         jlosses.segmentation_xentropy(logits, masks, n_classes)),
        (tlosses.miou(torch.from_numpy(pred), torch.from_numpy(masks[..., 0]),
                      n_classes),
         jlosses.miou(pred, masks[..., 0], n_classes)),
        (tlosses.pixel_accuracy(torch.from_numpy(pred),
                                torch.from_numpy(masks[..., 0])),
         jlosses.pixel_accuracy(pred, masks[..., 0])),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # a class absent from both maps counts as IoU 1, as in JAX
    zeros = np.zeros((1, 3, 3), np.int64)
    assert tlosses.miou(torch.from_numpy(zeros), torch.from_numpy(zeros),
                        3).item() == 1.0


def test_synthetic_batches_equal_jax():
    mine = SyntheticSegmentation(3, (40, 36), n_classes=3, seed=5)
    theirs = JSynth(3, (40, 36), n_classes=3, seed=5)
    for _ in range(2):
        a, b = mine.get_batch(), theirs.get_batch()
        for k in ("image", "mask"):
            np.testing.assert_array_equal(a[k], b[k])
