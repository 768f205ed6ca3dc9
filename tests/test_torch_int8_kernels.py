"""The plain versions of the int8 kernels (segmentation_tpu_torch/nn/
kernels/conv_int8.py) against the int8 modes of the JAX Pallas kernels and
entry_chain_pf2, run in interpret mode on CPU as tests/test_conv_flat.py
runs them. The CUDA kernels are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Operands are made with numpy from a seed: resident s8 activations (post-
ReLU codes), s8 weights, and channel scales that spread the requantized
outputs over the code range. The Pallas side sees the inputs through its
padded-flat (pad_rows) or paired-column (pad_pairs) layout and is compared
on the real window. Tolerances: the s8 × s8 products are exact on both
sides, so s8 outputs may differ only where f32 epilogue roundings in
another order move a value across a rounding boundary: at most one code,
on at most 1e-3 of the elements. bf16 outputs: one bf16 ulp of the
largest value. Masks: only pixels whose head margin lies within bf16
rounding may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_tpu.nn.pallas import conv_flat as jcf
from segmentation_tpu_torch.models.unet_fast import pack_conv3_weight_s2_t
from segmentation_tpu_torch.models.unet_int8 import _affine
from segmentation_tpu_torch.nn.kernels import conv_int8 as tci

OUT_S = 0.05


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _codes(rng, *shape):
    """Resident activations: post-ReLU s8 codes."""
    return rng.integers(0, 128, size=shape).astype(np.int8)


def _wq(rng, *shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


def _scales(rng, k, o, out_s=OUT_S):
    """(chan_scale, bias): acc · cs / out_s ~ N(0, 60) for s8 operands
    (acc std ~ 5376 · √k), bias / out_s ~ N(0, 10)."""
    cs = (rng.random(o).astype(np.float32) + 0.5) * np.float32(
        out_s * 60.0 / (5376.0 * np.sqrt(k)))
    b = rng.normal(0, 10 * out_s, o).astype(np.float32)
    return cs, b


def _vecs(cs, b, out_s=OUT_S):
    return _affine(_t(cs), _t(b), out_s)


def _codes_close(got, want):
    got = np.asarray(got).astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


def _bf16_close(got, want):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0**-7 * np.abs(want).max())


# ------------------------------------------------------------------ H1
@pytest.mark.parametrize("layout,mode", [
    ("padflat", "requant"), ("padflat", "pool"), ("pf2", "pool"),
    ("pf2", "float"), ("pf2", "head_only"),
])
def test_packed_conv2x2_s8_vs_pallas(np_rng, layout, mode):
    h, w_in, c, o = 7, 9, 128, 128 if layout == "pf2" else 256
    x, wq = _codes(np_rng, 2, h, w_in, c), _wq(np_rng, 2, 2, c, o)
    cs, b = _scales(np_rng, 4 * c, o)
    requant = mode in ("requant", "pool")
    q = {"chan_scale": jnp.asarray(cs)}
    if requant:
        q["out_scale"] = OUT_S
    else:
        cs = cs / np.float32(20 * OUT_S)  # bf16 values of O(1)
        b = b / np.float32(20 * OUT_S)
        q["chan_scale"] = jnp.asarray(cs)
    kw = {"pool": mode == "pool"}
    wd = np_rng.normal(size=(o, 4)).astype(np.float32)
    bd = np_rng.normal(size=(4,)).astype(np.float32)
    if mode == "head_only":
        kw.update(head=(jnp.asarray(wd), jnp.asarray(bd)), head_only=True)
    if layout == "padflat":
        s = jcf.stride_for(w_in, jnp.int8)
        outs = jcf.conv2x2_padflat(jcf.pad_rows(jnp.asarray(x), s),
                                   jnp.asarray(wq), jnp.asarray(b), h=h,
                                   w_real=w_in, s=s, r_block=4, quant=q,
                                   interpret=True, **kw)
        unpad = lambda v: jcf.unpad_rows(v, s, h - 1, w_in - 1)  # noqa
    else:
        s2 = jcf.stride_for((w_in + 1) // 2, jnp.int8)
        outs = jcf.conv2x2_pf2(jcf.pad_pairs(jnp.asarray(x), s2),
                               jnp.asarray(wq), jnp.asarray(b), h=h,
                               w_real=w_in, s2=s2, r_block=4, quant=q,
                               interpret=True, **kw)
        unpad = lambda v: jcf.unpad_pairs(v, s2, h - 1, w_in - 1)  # noqa
    outs = outs if isinstance(outs, tuple) else (outs,)
    want = [np.asarray(unpad(v)) for v in outs]

    mul, add = _vecs(cs, b, OUT_S if requant else None)
    if "head" in kw:
        kw["head"] = (_t(wd).to(torch.bfloat16), _t(bd))
    got = tci.packed_conv2x2_s8(_t(x), _t(wq), mul, add, requant=requant,
                                **kw)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    if mode == "head_only":
        y = tci.packed_conv2x2_s8(_t(x), _t(wq), mul, add, requant=False)
        margin = (y.float() @ _t(wd).to(torch.bfloat16).float()
                  + _t(bd)).numpy()
        diff = got[0].numpy() != want[0]
        assert np.all(np.abs(margin[diff]) <= 2.0**-7 * np.abs(margin).max())
        return
    for g, wv in zip(got, want):
        if requant:
            assert g.dtype == torch.int8
            _codes_close(g, wv)
        else:
            assert g.dtype == torch.bfloat16
            _bf16_close(g, np.asarray(wv, np.float32))


# ------------------------------------------------------------------ H2
@pytest.mark.parametrize("offset", [(4, 2), (3, 5)], ids=["even", "odd"])
def test_packed_conv2x2_dual_s8_vs_padflat(np_rng, offset):
    hb, wb_, c, o = 7, 9, 256, 256
    ha, wa_ = hb + 4, wb_ + 4
    xa, xb = _codes(np_rng, 2, ha, wa_, c), _codes(np_rng, 2, hb, wb_, c)
    wqa, wqb = _wq(np_rng, 2, 2, c, o), _wq(np_rng, 2, 2, c, o)
    csa, b = _scales(np_rng, 8 * c, o)
    csb, _ = _scales(np_rng, 8 * c, o)
    sa = jcf.stride_for(wa_, jnp.int8)
    sb = jcf.stride_for(wb_, jnp.int8)
    even = offset[0] % 2 == 0 and offset[1] % 2 == 0
    kw = (dict(a_offset=(offset[0] // 2, offset[1] // 2)) if even
          else dict(a_offset=(0, 0), a_slot_phase=offset))
    q = {"chan_scale_a": jnp.asarray(csa), "chan_scale_b": jnp.asarray(csb),
         "out_scale": OUT_S}
    xaf = jcf.pad_rows(jnp.asarray(xa), sa)
    want = jcf.conv2x2_dual_padflat(
        xaf, jcf.pad_rows(jnp.asarray(xb), sb), jnp.asarray(wqa),
        jnp.asarray(wqb), jnp.asarray(b), h=hb, w_real=wb_, s=sb, s_a=sa,
        hp_a=xaf.shape[1] // sa, r_block=4, quant=q, interpret=True, **kw,
    )
    want = jcf.unpad_rows(want, sb, hb - 1, wb_ - 1)
    mul, add = _vecs(np.ones(o, np.float32), b)
    got = tci.packed_conv2x2_dual_s8(_t(xa), _t(xb), _t(wqa), _t(wqb),
                                     _t(csa), _t(csb), mul, add,
                                     offset=offset)
    _codes_close(got, want)


def test_packed_conv2x2_dual_s8_vs_pf2(np_rng):
    """conv9_1's site: the pf2 dual at an even crop (packed offset 3, 7)."""
    hb, wb_, ro, co = 7, 9, 3, 7
    c, o = 128, 128
    ha, wa_ = hb + 8, wb_ + 12
    xa, xb = _codes(np_rng, 2, ha, wa_, c), _codes(np_rng, 2, hb, wb_, c)
    wqa, wqb = _wq(np_rng, 2, 2, c, o), _wq(np_rng, 2, 2, c, o)
    csa, b = _scales(np_rng, 8 * c, o)
    csb, _ = _scales(np_rng, 8 * c, o)
    s2a = jcf.stride_for((wa_ + 2) // 2, jnp.int8)
    s2b = jcf.stride_for((wb_ + 1) // 2, jnp.int8)
    q = {"chan_scale_a": jnp.asarray(csa), "chan_scale_b": jnp.asarray(csb),
         "out_scale": OUT_S}
    want = jcf.conv2x2_dual_pf2(
        jcf.pad_pairs(jnp.asarray(xa), s2a),
        jcf.pad_pairs(jnp.asarray(xb), s2b), jnp.asarray(wqa),
        jnp.asarray(wqb), jnp.asarray(b), h=hb, w_real=wb_, s2=s2b,
        s2_a=s2a, hp_a=ha, a_row_off=ro, a_col_off=co, r_block=4, quant=q,
        interpret=True,
    )
    want = jcf.unpad_pairs(want, s2b, hb - 1, wb_ - 1)
    mul, add = _vecs(np.ones(o, np.float32), b)
    got = tci.packed_conv2x2_dual_s8(_t(xa), _t(xb), _t(wqa), _t(wqb),
                                     _t(csa), _t(csb), mul, add,
                                     offset=(2 * ro, 2 * co))
    _codes_close(got, want)


# ------------------------------------------------------------------ H3
def test_strided_conv4x4s2_s8_vs_padflat(np_rng):
    """conv2_1's site: C = 32 from the paired pooled handoff."""
    h, w_in, c, o4 = 10, 12, 32, 256
    x, wq = _codes(np_rng, 2, h, w_in, c), _wq(np_rng, 4, 4, c, o4)
    cs, b = _scales(np_rng, 16 * c, o4)
    xp = jnp.asarray(x).reshape(2, h, w_in // 2, 2 * c)  # column pairs
    s2 = jcf.stride_for(w_in // 2, jnp.int8)
    want = jcf.conv4x4s2_padflat(
        jcf.pad_rows(xp, s2), jnp.asarray(wq), jnp.asarray(b), h=h,
        w2_real=w_in // 2, s2=s2, r_block=3,
        quant={"chan_scale": jnp.asarray(cs), "out_scale": OUT_S},
        interpret=True,
    )
    want = jcf.unpad_rows(want, s2, (h - 2) // 2, (w_in - 2) // 2)
    got = tci.strided_conv4x4s2_s8(_t(x), _t(wq), *_vecs(cs, b))
    _codes_close(got, want)


# ------------------------------------------------------------------ H4
def test_rows_matmul_s8_identity_vs_padflat(np_rng):
    """upconv3's site: unpacked s8 in, packed s8 out."""
    h, w_in, c, o4 = 5, 9, 128, 256
    x, wm = _codes(np_rng, 2, h, w_in, c), _wq(np_rng, c, o4)
    cs, b = _scales(np_rng, c, o4)
    s = jcf.stride_for(w_in, jnp.int8)
    want = jcf.matmul_rows_padflat(
        jcf.pad_rows(jnp.asarray(x), s), jnp.asarray(wm), jnp.asarray(b),
        quant={"chan_scale": jnp.asarray(cs), "out_scale": OUT_S},
        interpret=True,
    )
    want = jcf.unpad_rows(want, s, h, w_in)
    _codes_close(tci.rows_matmul_s8(_t(x), _t(wm), *_vecs(cs, b)), want)


def test_rows_matmul_s8_scatter_vs_deconv_pf2(np_rng):
    """upconv4's site: packed s8 in, slot scatter, the pf2 output."""
    i_in, j_in, c, o = 5, 7, 64, 32
    x, wm = _codes(np_rng, 2, i_in, j_in, 4 * c), _wq(np_rng, c, 4 * o)
    cs, b = _scales(np_rng, c, 4 * o)
    s_i = jcf.stride_for(j_in, jnp.int8)
    want = jcf.deconv_packed_padflat(
        jcf.pad_rows(jnp.asarray(x), s_i), jnp.asarray(wm), jnp.asarray(b),
        i_in=i_in, j_in=j_in, s_i=s_i, r_block=4, pf2_out=True,
        quant={"chan_scale": jnp.asarray(cs), "out_scale": OUT_S},
        interpret=True,
    )
    want = jcf.unpad_pairs(want, s_i, 2 * i_in, 2 * j_in)
    got = tci.rows_matmul_s8(_t(x), _t(wm), *_vecs(cs, b), scatter=True)
    _codes_close(got, want)


# ------------------------------------------------------------------ H5
def test_entry_chain_vs_entry_chain_pf2(np_rng):
    """Level 1 in one kernel: bf16 conv1_1 requantized at out_scale1, s8
    conv1_2 with chan_scale and out_scale, slot-max pool."""
    h_img, w_img, o = 38, 512, 32  # the Pallas chain needs W % 128 == 0
    o4 = 4 * o
    out_s1 = 1 / 16.0
    xb = torch.rand((1, h_img, w_img, 3),
                    generator=torch.Generator().manual_seed(3)).bfloat16()
    w3 = (np_rng.normal(size=(3, 3, 3, o)) * 0.2).astype(np.float32)
    b1 = (np_rng.normal(size=(o,)) * 0.1).astype(np.float32)
    w2 = _wq(np_rng, 2, 2, o4, o4)
    cs2, b2 = _scales(np_rng, 4 * o4, o4)
    we, wh, wl = (jnp.asarray(v, jnp.bfloat16)
                  for v in jcf.entry_weights_pf2(w3))
    xj = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    got_y, got_p = jcf.entry_chain_pf2(
        jcf.entry_transform_pf2(xj), we, wh, wl,
        jnp.tile(jnp.asarray(b1), 4), jnp.asarray(w2), jnp.asarray(b2),
        h_img=h_img, out_scale1=out_s1,
        quant2={"chan_scale": jnp.asarray(cs2), "out_scale": OUT_S},
        r_block=4, interpret=True,
    )
    h2, w2_out, g = (h_img - 2) // 2 - 1, (w_img - 2) // 2 - 1, w_img // 4
    want_y = jcf.unpad_pairs(got_y, g, h2, w2_out)
    want_p = jcf.unpad_pairs(got_p, g, h2, w2_out)

    w4 = pack_conv3_weight_s2_t(_t(w3)).to(torch.bfloat16)
    mul1, add1 = _affine(torch.ones(o4), _t(np.tile(b1, 4)), out_s1)
    y, pooled = tci.entry_chain(xb, w4, mul1, add1, _t(w2), *_vecs(cs2, b2))
    assert y.dtype == pooled.dtype == torch.int8
    _codes_close(y, want_y)
    _codes_close(pooled, want_p)


# ------------------------------------------------------------ dispatch
def test_int8_wrappers_take_plain_versions_on_cpu(np_rng):
    x, wq = _t(_codes(np_rng, 1, 4, 5, 32)), _t(_wq(np_rng, 2, 2, 32, 128))
    mul, add = _vecs(*_scales(np_rng, 128, 128))
    before = dict(tci.launches)
    got = tci.packed_conv2x2_s8(x, wq, mul, add, pool=True)
    want = tci.packed_conv2x2_s8_plain(x, wq, mul, add, pool=True)
    for g, wv in zip(got, want):
        assert torch.equal(g, wv)
    assert tci.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        tci.entry_chain(torch.empty((1, 8, 8, 3), device="meta"),
                        *[None] * 6)
