"""The port's packed-site ops (segmentation_tpu_torch/nn/kernels/conv_flat.py)
against the JAX Pallas kernels they replace (segmentation_tpu/nn/pallas/
conv_flat.py), run in interpret mode on CPU as tests/test_conv_flat.py runs
them. On a CPU tensor each wrapper runs its plain PyTorch version; the
CUDA kernels are held against those plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Inputs are float32 from one numpy seed. The Pallas side sees them through
its padded-flat (pad_rows) or paired-column (pad_pairs) layout and is
compared on the real window. Tolerance: 1e-4 absolute — both sides are
float32 sums of at most 2·4·4C = 2048 products of O(1) terms, differing
only in summation order (~1e-6). Masks: the head rounds y and wd to bf16
on both sides, so only pixels whose f32 margin is below the summation-order
noise (1e-4) may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_tpu.models import unet_fast as jfast
from segmentation_tpu.nn.pallas import conv_flat as jcf
from segmentation_tpu_torch.models.unet_fast import pack_conv3_weight_s2_t
from segmentation_tpu_torch.nn.kernels import conv_flat as tcf

TOL = 1e-4
C = O = 128  # the Pallas kernels take 128-multiples only


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=0, atol=TOL)


def _mask_close(got, want, y, wd, bd):
    """Masks equal except where the head's f32 margin is within noise."""
    got, want = np.asarray(got), np.asarray(want)
    yb = np.asarray(torch.from_numpy(np.asarray(y, np.float32))
                    .to(torch.bfloat16).float())
    wdb = np.asarray(_t(wd).to(torch.bfloat16).float())
    margin = yb @ wdb + np.asarray(bd, np.float32)
    diff = got != want
    assert np.all(np.abs(margin[diff]) < TOL), np.abs(margin[diff]).max()
    assert diff.mean() < 1e-3


def _operands(rng, c, o, taps=(2, 2)):
    w = rng.normal(size=(*taps, c, o)).astype(np.float32) * 0.05
    b = rng.normal(size=(o,)).astype(np.float32)
    return w, b


# ------------------------------------------------------------------ H1
@pytest.mark.parametrize("layout", ["padflat", "pf2"])
@pytest.mark.parametrize("mode", ["conv", "pool", "head_only"])
def test_packed_conv2x2_vs_pallas(np_rng, layout, mode):
    h, w_in = 7, 9
    x = np_rng.normal(size=(2, h, w_in, C)).astype(np.float32)
    w, b = _operands(np_rng, C, O)
    wd = np_rng.normal(size=(O, 4)).astype(np.float32)
    bd = np_rng.normal(size=(4,)).astype(np.float32)
    kw = {}
    if mode == "pool":
        kw["pool"] = True
    if mode == "head_only":
        kw.update(head=(wd, bd), head_only=True)
    if layout == "padflat":
        s = jcf.stride_for(w_in, jnp.float32)
        outs = jcf.conv2x2_padflat(jcf.pad_rows(jnp.asarray(x), s), w, b,
                                   h=h, w_real=w_in, s=s, r_block=4,
                                   interpret=True, **kw)
        unpad = lambda v: jcf.unpad_rows(v, s, h - 1, w_in - 1)  # noqa
    else:
        s2 = jcf.stride_for((w_in + 1) // 2, jnp.float32)
        outs = jcf.conv2x2_pf2(jcf.pad_pairs(jnp.asarray(x), s2), w, b,
                               h=h, w_real=w_in, s2=s2, r_block=4,
                               interpret=True, **kw)
        unpad = lambda v: jcf.unpad_pairs(v, s2, h - 1, w_in - 1)  # noqa
    outs = outs if isinstance(outs, tuple) else (outs,)
    want = [np.asarray(unpad(v)) for v in outs]

    if "head" in kw:
        kw["head"] = (_t(wd), _t(bd))
    got = tcf.packed_conv2x2(_t(x), _t(w), _t(b), **kw)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    if mode == "head_only":
        y = tcf.packed_conv2x2(_t(x), _t(w), _t(b))
        assert got[0].dtype == torch.uint8
        _mask_close(got[0], want[0], y, wd, bd)
        return
    for g, wv in zip(got, want):
        assert tuple(g.shape) == wv.shape
        _close(g, wv)


# ------------------------------------------------------------------ H2
@pytest.mark.parametrize("offset", [(0, 0), (4, 2), (3, 5), (4, 3)],
                         ids=["even0", "even", "odd_phase", "mixed_phase"])
def test_packed_conv2x2_dual_vs_padflat(np_rng, offset):
    hb, wb_ = 7, 9
    ha, wa_ = hb + 4, wb_ + 4
    xa = np_rng.normal(size=(2, ha, wa_, C)).astype(np.float32)
    xb = np_rng.normal(size=(2, hb, wb_, C)).astype(np.float32)
    wa, b = _operands(np_rng, C, O)
    wb, _ = _operands(np_rng, C, O)
    sa = jcf.stride_for(wa_, jnp.float32)
    sb = jcf.stride_for(wb_, jnp.float32)
    even = offset[0] % 2 == 0 and offset[1] % 2 == 0
    kw = (dict(a_offset=(offset[0] // 2, offset[1] // 2)) if even
          else dict(a_offset=(0, 0), a_slot_phase=offset))
    xaf = jcf.pad_rows(jnp.asarray(xa), sa)
    want = jcf.conv2x2_dual_padflat(
        xaf, jcf.pad_rows(jnp.asarray(xb), sb), wa, wb, b, h=hb,
        w_real=wb_, s=sb, s_a=sa, hp_a=xaf.shape[1] // sa, r_block=4,
        interpret=True, **kw,
    )
    want = jcf.unpad_rows(want, sb, hb - 1, wb_ - 1)
    got = tcf.packed_conv2x2_dual(_t(xa), _t(xb), _t(wa), _t(wb), _t(b),
                                  offset=offset)
    _close(got, want)


@pytest.mark.parametrize("col_off", [4, 7])
def test_packed_conv2x2_dual_vs_pf2(np_rng, col_off):
    """The pf2 dual reads the skip at a packed (row, col) offset, which is
    the even unpacked offset (2·row, 2·col)."""
    hb, wb_, ro = 7, 9, 3
    ha, wa_ = hb + 8, wb_ + 12
    xa = np_rng.normal(size=(2, ha, wa_, C)).astype(np.float32)
    xb = np_rng.normal(size=(2, hb, wb_, C)).astype(np.float32)
    wa, b = _operands(np_rng, C, O)
    wb, _ = _operands(np_rng, C, O)
    s2a = jcf.stride_for((wa_ + 2) // 2, jnp.float32)
    s2b = jcf.stride_for((wb_ + 1) // 2, jnp.float32)
    want = jcf.conv2x2_dual_pf2(
        jcf.pad_pairs(jnp.asarray(xa), s2a), jcf.pad_pairs(jnp.asarray(xb),
                                                           s2b),
        wa, wb, b, h=hb, w_real=wb_, s2=s2b, s2_a=s2a, hp_a=ha,
        a_row_off=ro, a_col_off=col_off, r_block=4, interpret=True,
    )
    want = jcf.unpad_pairs(want, s2b, hb - 1, wb_ - 1)
    got = tcf.packed_conv2x2_dual(_t(xa), _t(xb), _t(wa), _t(wb), _t(b),
                                  offset=(2 * ro, 2 * col_off))
    _close(got, want)


# ------------------------------------------------------------------ H3
@pytest.mark.parametrize("h,w_in,c,o4", [(10, 12, 32, 128),
                                          (9, 14, 64, 256)])
def test_strided_conv4x4s2_vs_padflat(np_rng, h, w_in, c, o4):
    x = np_rng.normal(size=(2, h, w_in, c)).astype(np.float32)
    w4, b = _operands(np_rng, c, o4, taps=(4, 4))
    xp = jnp.asarray(x).reshape(2, h, w_in // 2, 2 * c)  # column pairs
    s2 = jcf.stride_for(w_in // 2, jnp.float32)
    want = jcf.conv4x4s2_padflat(jcf.pad_rows(xp, s2), w4, b, h=h,
                                 w2_real=w_in // 2, s2=s2, r_block=3,
                                 interpret=True)
    want = jcf.unpad_rows(want, s2, (h - 2) // 2, (w_in - 2) // 2)
    got = tcf.strided_conv4x4s2(_t(x), _t(w4), _t(b))
    _close(got, want)


def test_strided_conv4x4s2_vs_entry_pf2(np_rng):
    """C = 3: the fused pf2 entry (3×3 conv + s2d fold) with the same 3×3
    weights, folded for the port by pack_conv3_weight_s2_t."""
    h_img, w_img, o = 10, 512, 32  # the entry kernel needs W % 128 == 0
    x = np_rng.normal(size=(1, h_img, w_img, 3)).astype(np.float32)
    w3 = np_rng.normal(size=(3, 3, 3, o)).astype(np.float32) * 0.2
    b = np_rng.normal(size=(o,)).astype(np.float32)
    we, wh, wl = map(jnp.asarray, jcf.entry_weights_pf2(w3))
    want = jcf.conv3entry_pf2(jcf.entry_transform_pf2(jnp.asarray(x)), we,
                              wh, wl, jnp.tile(jnp.asarray(b), 4),
                              h_img=h_img, r_block=3, interpret=True)
    h_out, w_out = (h_img - 2) // 2, (w_img - 2) // 2
    want = jcf.unpad_pairs(want, w_img // 4, h_out, w_out)
    got = tcf.strided_conv4x4s2(_t(x), pack_conv3_weight_s2_t(_t(w3)),
                                _t(np.tile(b, 4)))
    _close(got, want)


# ------------------------------------------------------------------ H4
def test_rows_matmul_identity_vs_padflat(np_rng):
    h, w_in, k = 5, 9, 256
    x = np_rng.normal(size=(2, h, w_in, C)).astype(np.float32)
    wm = np_rng.normal(size=(C, k)).astype(np.float32) * 0.05
    b = np_rng.normal(size=(k,)).astype(np.float32)
    s = jcf.stride_for(w_in, jnp.float32)
    want = jcf.matmul_rows_padflat(jcf.pad_rows(jnp.asarray(x), s), wm, b,
                                   interpret=True)
    want = jcf.unpad_rows(want, s, h, w_in)
    _close(tcf.rows_matmul(_t(x), _t(wm), _t(b)), want)


@pytest.mark.parametrize("pf2_out", [False, True])
def test_rows_matmul_scatter_vs_deconv_packed(np_rng, pf2_out):
    i_in, j_in, c, o = 5, 7, 64, 32
    x = np_rng.normal(size=(2, i_in, j_in, 4 * c)).astype(np.float32)
    wm = np_rng.normal(size=(c, 4 * o)).astype(np.float32) * 0.05
    b4 = np.tile(np_rng.normal(size=(o,)).astype(np.float32), 4)
    s_i = jcf.stride_for(j_in, jnp.float32)
    want = jcf.deconv_packed_padflat(
        jcf.pad_rows(jnp.asarray(x), s_i), wm, b4, i_in=i_in, j_in=j_in,
        s_i=s_i, r_block=4, pf2_out=pf2_out, interpret=True,
    )
    if pf2_out:
        want = jcf.unpad_pairs(want, s_i, 2 * i_in, 2 * j_in)
    else:
        s_o = jcf.stride_for(2 * j_in, jnp.float32)
        want = jcf.unpad_rows(want, s_o, 2 * i_in, 2 * j_in)
    got = tcf.rows_matmul(_t(x), _t(wm), _t(b4), scatter=True)
    _close(got, want)


def test_rows_matmul_scatter_matches_jax_deconv_packed_in(np_rng):
    """The slot scatter is the JAX deconv2_packed_in_flat map."""
    x = np_rng.normal(size=(1, 3, 4, 4 * 8)).astype(np.float32)
    wm = np_rng.normal(size=(8, 4 * 8)).astype(np.float32)
    b = np_rng.normal(size=(8,)).astype(np.float32)
    want = jfast.deconv2_packed_in_flat(jnp.asarray(x), wm, b, 8,
                                        pallas=False)
    got = tcf.rows_matmul(_t(x), _t(wm), _t(np.tile(b, 4)), scatter=True)
    _close(got, want)


# ------------------------------------------------------------ dispatch
def test_wrappers_take_plain_versions_on_cpu(np_rng):
    x = _t(np_rng.normal(size=(1, 4, 5, 32)))
    w, b = (_t(v) for v in _operands(np_rng, 32, 128))
    before = dict(tcf.launches)
    got = tcf.packed_conv2x2(x, w, b, pool=True)
    want = tcf.packed_conv2x2_plain(x, w, b, pool=True)
    for g, wv in zip(got, want):
        assert torch.equal(g, wv)
    assert tcf.launches == before


def test_wrappers_refuse_other_devices():
    x = torch.empty((1, 4, 5, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tcf.packed_conv2x2(x, x, x)
