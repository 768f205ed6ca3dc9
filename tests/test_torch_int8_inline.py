"""The new kernel modes' plain versions (segmentation_tpu_torch/nn/kernels/
conv_int8.py, conv_flat.py) against the Pallas modes they replace, run in
interpret mode on CPU as tests/test_pallas_conv.py and
tests/test_conv_flat.py run them:

- the inline-quantize modes (a bf16 operand quantized as the kernel loads
  it, ``act_scale``) of H1 (conv2x2_flat, conv2x2_padflat, with pool and
  head), H2 (conv2x2_dual_flat, a side, b side or both, even and odd
  crops), H3 (conv4x4s2_flat) and H4 (matmul_rows_flat, deconv_packed_flat,
  deconv_packed_padflat);
- the 4-D route's conv2x2_pool_flat (bf16 and s8, pool_pairs on and off)
  against H1's pool mode, and conv2x2_dual_flat with the crop folded in
  (bf16 and s8) against H2's offset mode;
- conv3entry_pf2's requant-only and s8-input modes against H3's entry
  modes; the requant-only codes through H1's pool equal H5 exactly.

The bf16 operands hold values on rounding ties (x · inv = k + 1/2 exactly)
and beyond ±127 codes. Tolerances: the s8 × s8 products are exact on both
sides and the quantize is the same f32 multiply, so s8 outputs differ
only where f32 epilogue roundings in another order cross a rounding
boundary: at most one code, on at most 1e-3 of the elements. bf16
outputs: within 1e-2 of the largest value (bf16 rounding in another
order). JAX's 4-D deconv_packed_flat rounds the dequantized product to
bf16 before its interleave matmul (nn/pallas/conv.py:1063-1071), which the
padded-flat pf2 scatter and the port do not: there codes differ by at most
one on at most 5 % of the elements (that rounding moves a value v by up to
v · 2^-9; 3.2-3.4 % differ at the test's scales).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_tpu.nn.pallas import conv as jconv
from segmentation_tpu.nn.pallas import conv_flat as jcf
from segmentation_tpu_torch.models.unet_fast import pack_conv3_weight_s2_t
from segmentation_tpu_torch.models.unet_int8 import _affine
from segmentation_tpu_torch.nn.kernels import conv_flat as tcf
from segmentation_tpu_torch.nn.kernels import conv_int8 as tci

OUT_S = 0.05
ACT_S = 1 / 16.0  # inv = 16 exactly: (k + 1/2) / 16 is a tie


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_acts(rng, *shape, act_s=ACT_S, signed=False):
    """bf16 activations whose codes at ``act_s`` reach past 127, a third
    of them exactly on a rounding tie, as float32 holding bf16 values."""
    k = rng.integers(-150 if signed else 0, 150, size=shape)
    frac = rng.choice([0.0, 0.5, 0.25], size=shape)
    x = (k + frac + (frac == 0.25) * rng.random(shape)) * act_s
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _jx(xb):
    return jnp.asarray(xb.float().numpy(), jnp.bfloat16)


def _codes(rng, *shape):
    return rng.integers(0, 128, size=shape).astype(np.int8)


def _wq(rng, *shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


def _scales(rng, k, o, out_s=OUT_S):
    """(chan_scale, bias) spreading acc · cs / out_s over the codes."""
    cs = (rng.random(o).astype(np.float32) + 0.5) * np.float32(
        out_s * 60.0 / (5376.0 * np.sqrt(k)))
    return cs, rng.normal(0, 10 * out_s, o).astype(np.float32)


def _codes_close(got, want, share=1e-3):
    got = np.asarray(got).astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= share, (d > 0).mean()
    assert (want > 0).mean() > 0.2  # the outputs spread over the codes


def _bf16_close(got, want):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


# ------------------------------------------------------ the quantize itself
@pytest.mark.parametrize("act_s", [ACT_S, 0.0123, 3e-3])
def test_quant_inline_is_quant_rows(np_rng, act_s):
    """quant_inline == _quant_rows bit for bit: the f32 multiply by
    f32(1/act_scale), round half to even, clip ±127."""
    x = _bf16_acts(np_rng, 4, 300, act_s=act_s, signed=True)
    inv = jnp.asarray(1.0 / act_s, jnp.float32).reshape(1, 1)
    want = np.asarray(jconv._quant_rows(_jx(x), inv))
    got = tci.quant_inline(x, act_s)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() == 127  # the clip engaged
    if act_s == ACT_S:  # ties round half to even
        v = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5]) * ACT_S
        assert tci.quant_inline(v.bfloat16(), ACT_S).tolist() == \
            [0, 2, 2, 0, -2]


# ------------------------------------------------------------------- H1
@pytest.mark.parametrize("mode", ["requant", "float", "head", "pool"])
def test_conv2x2_flat_inline(np_rng, mode):
    """conv2x2_flat (conv2x2_pool_flat for ``pool``) with act_scale."""
    c, o = 128, 256
    x = _bf16_acts(np_rng, 2, 6, 9, c)
    wq = _wq(np_rng, 2, 2, c, o)
    cs, b = _scales(np_rng, 4 * c, o)
    q = {"chan_scale": jnp.asarray(cs), "act_scale": ACT_S}
    out_s = OUT_S if mode in ("requant", "pool") else None
    if out_s:
        q["out_scale"] = out_s
    else:  # bf16 values of O(1)
        cs, b = cs / np.float32(20 * OUT_S), b / np.float32(20 * OUT_S)
        q["chan_scale"] = jnp.asarray(cs)
    kw = {}
    wd = np_rng.normal(size=(o, 4)).astype(np.float32)
    bd = np_rng.normal(size=(4,)).astype(np.float32)
    if mode == "head":
        kw["head"] = (jnp.asarray(wd), jnp.asarray(bd))
    if mode == "pool":
        want = jconv.conv2x2_pool_flat(_jx(x), jnp.asarray(wq),
                                       jnp.asarray(b), quant=q,
                                       interpret=True)
    else:
        want = jconv.conv2x2_flat(_jx(x), jnp.asarray(wq), jnp.asarray(b),
                                  quant=q, interpret=True, **kw)
    want = want if isinstance(want, tuple) else (want,)
    mul, add = _affine(_t(cs), _t(b), out_s)
    if mode == "head":
        kw["head"] = (_t(wd).to(torch.bfloat16), _t(bd))
    got = tci.packed_conv2x2_s8(x, _t(wq), mul, add,
                                requant=out_s is not None,
                                pool=mode == "pool", act_scale=ACT_S, **kw)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dtype == torch.int8:
            _codes_close(g, w)
        elif g.dtype == torch.uint8:  # the head on bf16 values
            assert (g.numpy() == np.asarray(w)).mean() >= 0.99
        else:
            _bf16_close(g, w)


def test_conv2x2_padflat_inline(np_rng):
    """The padded-flat H1 with act_scale and the fused pool."""
    h, w_in, c, o = 7, 9, 128, 256
    x = _bf16_acts(np_rng, 2, h, w_in, c)
    wq = _wq(np_rng, 2, 2, c, o)
    cs, b = _scales(np_rng, 4 * c, o)
    s = jcf.stride_for(w_in, jnp.int8)
    q = {"chan_scale": jnp.asarray(cs), "act_scale": ACT_S,
         "out_scale": OUT_S}
    y, pooled = jcf.conv2x2_padflat(
        jcf.pad_rows(_jx(x), s), jnp.asarray(wq), jnp.asarray(b), h=h,
        w_real=w_in, s=s, r_block=4, quant=q, pool=True, interpret=True)
    got = tci.packed_conv2x2_s8(x, _t(wq), *_affine(_t(cs), _t(b), OUT_S),
                                pool=True, act_scale=ACT_S)
    for g, w in zip(got, (y, pooled)):
        _codes_close(g, jcf.unpad_rows(w, s, h - 1, w_in - 1))


# ------------------------------------------------- H1 pool, the 4-D route
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "s8"])
def test_conv2x2_pool_flat_vs_pool_mode(np_rng, dtype, pairs):
    """conv2x2_pool_flat (conv1_2 and conv2_2 of the 4-D route) against
    H1's pool mode; pool_pairs is the pooled tensor column-paired."""
    n, h, w_in, c, o = 2, 6, 9, 128, 128
    if dtype == "bf16":
        x = torch.rand((n, h, w_in, c), generator=torch.Generator()
                       .manual_seed(1)).bfloat16()
        w2 = torch.from_numpy(np_rng.normal(0, 0.05, (2, 2, c, o))
                              .astype(np.float32)).bfloat16()
        b = np_rng.normal(0, 0.1, o).astype(np.float32)
        want = jconv.conv2x2_pool_flat(_jx(x), _jx(w2), jnp.asarray(b),
                                       pool_pairs=pairs, interpret=True)
        got = tcf.packed_conv2x2(x, w2, _t(b), pool=True)
        close = _bf16_close
    else:
        x, wq = _codes(np_rng, n, h, w_in, c), _wq(np_rng, 2, 2, c, o)
        cs, b = _scales(np_rng, 4 * c, o)
        want = jconv.conv2x2_pool_flat(
            jnp.asarray(x), jnp.asarray(wq), jnp.asarray(b),
            pool_pairs=pairs, interpret=True,
            quant={"chan_scale": jnp.asarray(cs), "out_scale": OUT_S})
        got = tci.packed_conv2x2_s8(_t(x), _t(wq),
                                    *_affine(_t(cs), _t(b), OUT_S),
                                    pool=True)
        close = _codes_close
    y, pooled = got
    if pairs:
        pooled = pooled.reshape(n, h - 1, (w_in - 1) // 2, o // 2)
    close(y, want[0])
    close(pooled, want[1])


# ------------------------------------------------------------------- H2
def _crop_kw(offset):
    """conv2x2_dual_flat's crop arguments for the UNPACKED ``offset``:
    even → a packed a_offset, odd → the slot phase."""
    even = offset[0] % 2 == 0 and offset[1] % 2 == 0
    if even:
        return dict(a_offset=(offset[0] // 2, offset[1] // 2))
    return dict(a_slot_phase=offset)


@pytest.mark.parametrize("offset", [(4, 2), (3, 5)], ids=["even", "odd"])
def test_conv2x2_dual_flat_crop_folded_bf16(np_rng, offset):
    """The 4-D route's dual with the skip crop folded in, bf16, against
    H2's offset mode."""
    hb, wb_, c, o = 6, 9, 128, 128
    skip = torch.rand((2, hb + 4, wb_ + 4, c), generator=torch.Generator()
                      .manual_seed(2)).bfloat16()
    up = torch.rand((2, hb, wb_, c), generator=torch.Generator()
                    .manual_seed(3)).bfloat16()
    wa, wb = (torch.from_numpy(np_rng.normal(0, 0.03, (2, 2, c, o))
                               .astype(np.float32)).bfloat16()
              for _ in range(2))
    b = np_rng.normal(0, 0.1, o).astype(np.float32)
    want = jconv.conv2x2_dual_flat(_jx(skip), _jx(up), _jx(wa), _jx(wb),
                                   jnp.asarray(b), interpret=True,
                                   **_crop_kw(offset))
    got = tcf.packed_conv2x2_dual(skip, up, wa, wb, _t(b), offset=offset)
    _bf16_close(got, want)


@pytest.mark.parametrize("inline", ["b", "a", "ab", ""])
@pytest.mark.parametrize("offset", [(4, 2), (3, 5)], ids=["even", "odd"])
def test_conv2x2_dual_flat_s8(np_rng, offset, inline):
    """The 4-D route's s8 dual, crop folded in, each side resident or
    quantized inline (act_scale_a / act_scale_b)."""
    hb, wb_, c, o = 6, 9, 256, 256
    ha, wa_ = hb + 4, wb_ + 4
    skip = (_bf16_acts(np_rng, 2, ha, wa_, c) if "a" in inline
            else _t(_codes(np_rng, 2, ha, wa_, c)))
    up = (_bf16_acts(np_rng, 2, hb, wb_, c) if "b" in inline
          else _t(_codes(np_rng, 2, hb, wb_, c)))
    wqa, wqb = _wq(np_rng, 2, 2, c, o), _wq(np_rng, 2, 2, c, o)
    csa, b = _scales(np_rng, 8 * c, o)
    csb, _ = _scales(np_rng, 8 * c, o)
    sa = ACT_S if "a" in inline else None
    sb = ACT_S if "b" in inline else None
    q = {"chan_scale_a": jnp.asarray(csa), "chan_scale_b": jnp.asarray(csb),
         "out_scale": OUT_S}
    if sa:
        q["act_scale_a"] = sa
    if sb:
        q["act_scale_b"] = sb

    def j(v):
        return _jx(v) if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy())

    want = jconv.conv2x2_dual_flat(j(skip), j(up), jnp.asarray(wqa),
                                   jnp.asarray(wqb), jnp.asarray(b),
                                   quant=q, interpret=True,
                                   **_crop_kw(offset))
    mul, add = _affine(torch.ones(o), _t(b), OUT_S)
    got = tci.packed_conv2x2_dual_s8(skip, up, _t(wqa), _t(wqb), _t(csa),
                                     _t(csb), mul, add, offset=offset,
                                     act_scale_a=sa, act_scale_b=sb)
    _codes_close(got, want)


# ------------------------------------------------------------------- H3
def test_conv4x4s2_flat_inline(np_rng):
    """conv2_1's site in the 4-D route, its input quantized inline."""
    h, w_in, c, o4 = 10, 12, 32, 256
    x = _bf16_acts(np_rng, 2, h, w_in, c)
    wq = _wq(np_rng, 4, 4, c, o4)
    cs, b = _scales(np_rng, 16 * c, o4)
    want = jconv.conv4x4s2_flat(
        _jx(x), jnp.asarray(wq), jnp.asarray(b), r_block=3, interpret=True,
        quant={"chan_scale": jnp.asarray(cs), "act_scale": ACT_S,
               "out_scale": OUT_S})
    got = tci.strided_conv4x4s2_s8(x, _t(wq), *_affine(_t(cs), _t(b), OUT_S),
                                   act_scale=ACT_S)
    _codes_close(got, want)


# ------------------------------------------------------------------- H4
def test_matmul_rows_flat_inline(np_rng):
    h, w_in, c, o4 = 5, 9, 128, 256
    x = _bf16_acts(np_rng, 2, h, w_in, c)
    wm = _wq(np_rng, c, o4)
    cs, b = _scales(np_rng, c, o4)
    want = jconv.matmul_rows_flat(
        _jx(x), jnp.asarray(wm), jnp.asarray(b), interpret=True,
        quant={"chan_scale": jnp.asarray(cs), "act_scale": ACT_S,
               "out_scale": OUT_S})
    got = tci.rows_matmul_s8(x, _t(wm), *_affine(_t(cs), _t(b), OUT_S),
                             act_scale=ACT_S)
    _codes_close(got, want)


@pytest.mark.parametrize("layout", ["pf2", "4d"])
def test_deconv_packed_inline(np_rng, layout):
    """The slot-scatter deconv with act_scale: the padded-flat pf2 form
    (upconv4's) at the strict bar; the 4-D form with the bf16 rounding of
    its dequantized product (module docstring)."""
    i_in, j_in, c, o = 5, 7, 32, 32
    x = _bf16_acts(np_rng, 2, i_in, j_in, 4 * c)
    wm = _wq(np_rng, c, 4 * o)
    cs, b = _scales(np_rng, c, 4 * o)
    q = {"chan_scale": jnp.asarray(cs), "act_scale": ACT_S,
         "out_scale": OUT_S}
    if layout == "pf2":
        s_i = jcf.stride_for(j_in, jnp.int8)
        want = jcf.deconv_packed_padflat(
            jcf.pad_rows(_jx(x), s_i), jnp.asarray(wm), jnp.asarray(b),
            i_in=i_in, j_in=j_in, s_i=s_i, r_block=4, pf2_out=True, quant=q,
            interpret=True)
        want, share = jcf.unpad_pairs(want, s_i, 2 * i_in, 2 * j_in), 1e-3
    else:
        want = jconv.deconv_packed_flat(_jx(x), jnp.asarray(wm),
                                        jnp.asarray(b), quant=q,
                                        interpret=True)
        share = 0.05  # 3.2-3.4 % on three seeds
    got = tci.rows_matmul_s8(x, _t(wm), *_affine(_t(cs), _t(b), OUT_S),
                             scatter=True, act_scale=ACT_S)
    _codes_close(got, want, share)


# ------------------------------------------------------ the image entry
H_IMG, W_IMG, O = 18, 512, 32  # conv3entry_pf2 needs W % 128 == 0


def _entry_out(v):
    return jcf.unpad_pairs(v, W_IMG // 4, (H_IMG - 2) // 2, (W_IMG - 2) // 2)


def test_conv3entry_requant_vs_pallas(np_rng):
    """The requant-only entry: bf16 image and taps, f32 accumulation,
    clip(round(max(acc/out_s + b/out_s, 0))) → s8."""
    x = _bf16_acts(np_rng, 2, H_IMG, W_IMG, 3, act_s=1 / 128)
    w3 = (np_rng.normal(size=(3, 3, 3, O)) * 0.2).astype(np.float32)
    b = (np_rng.normal(size=(O,)) * 0.1).astype(np.float32)
    we, wh, wl = (jnp.asarray(v, jnp.bfloat16)
                  for v in jcf.entry_weights_pf2(w3))
    want = jcf.conv3entry_pf2(
        jcf.entry_transform_pf2(_jx(x)), we, wh, wl,
        jnp.tile(jnp.asarray(b), 4), h_img=H_IMG, r_block=3,
        quant={"out_scale": OUT_S}, interpret=True)
    w4 = pack_conv3_weight_s2_t(_t(w3)).to(torch.bfloat16)
    mul, add = _affine(torch.ones(4 * O), _t(np.tile(b, 4)), OUT_S)
    got = tci.conv3entry_requant(x, w4, mul, add)
    assert got.dtype == torch.int8
    _codes_close(got, _entry_out(want))


def test_conv3entry_s8_vs_pallas(np_rng):
    """The s8-input entry (u8-native image serving): s8 image codes and
    s8 taps, s32 accumulation, chan_scale and out_scale."""
    x = _codes(np_rng, 2, H_IMG, W_IMG, 3)
    wq3 = _wq(np_rng, 3, 3, 3, O)
    cs, b = _scales(np_rng, 27, 4 * O)
    we, wh, wl = (jnp.asarray(v) for v in jcf.entry_weights_pf2(wq3))
    want = jcf.conv3entry_pf2(
        jcf.entry_transform_pf2(jnp.asarray(x)), we, wh, wl, jnp.asarray(b),
        h_img=H_IMG, r_block=3, interpret=True,
        quant={"chan_scale": jnp.asarray(cs), "out_scale": OUT_S})
    wq4 = pack_conv3_weight_s2_t(_t(wq3))
    assert wq4.dtype == torch.int8
    got = tci.conv3entry_s8(_t(x), wq4, *_affine(_t(cs), _t(b), OUT_S))
    _codes_close(got, _entry_out(want))


def test_conv3entry_requant_is_entry_chain_conv1_1(np_rng):
    """H1's pool mode on the requant-only entry's codes equals H5 exactly
    (as entry_chain_pf2 equals its two-kernel form, tests/
    test_conv_flat.py:685): the same requant point, the same codes."""
    x = _bf16_acts(np_rng, 2, 22, 26, 3, act_s=1 / 128)
    w4 = pack_conv3_weight_s2_t(_t(
        (np_rng.normal(size=(3, 3, 3, O)) * 0.2).astype(np.float32)))
    w4 = w4.to(torch.bfloat16)
    b1 = _t((np_rng.normal(size=4 * O) * 0.1).astype(np.float32))
    mul1, add1 = _affine(torch.ones(4 * O), b1, 1 / 16)
    wq2 = _t(_wq(np_rng, 2, 2, 4 * O, 4 * O))
    mul2, add2 = _affine(*map(_t, _scales(np_rng, 16 * O, 4 * O)), OUT_S)
    codes = tci.conv3entry_requant(x, w4, mul1, add1)
    y, pooled = tci.packed_conv2x2_s8(codes, wq2, mul2, add2, pool=True)
    want_y, want_p = tci.entry_chain(x, w4, mul1, add1, wq2, mul2, add2)
    assert torch.equal(y, want_y) and torch.equal(pooled, want_p)


# ------------------------------------------------------------ dispatch
def test_wrappers_refuse_bf16_without_scale(np_rng):
    """A bf16 tensor at an s8 site needs its act_scale (CPU and card
    alike), and an s8 tensor takes none; on the CPU nothing launches."""
    xb = _bf16_acts(np_rng, 1, 4, 5, 64)
    x8 = _t(_codes(np_rng, 1, 4, 5, 64))
    wq = _t(_wq(np_rng, 2, 2, 64, 128))
    mul, add = _affine(*map(_t, _scales(np_rng, 256, 128)), OUT_S)
    before = dict(tci.launches)
    with pytest.raises(TypeError, match="act_scale"):
        tci.packed_conv2x2_s8(xb, wq, mul, add)
    with pytest.raises(TypeError, match="act_scale"):
        tci.packed_conv2x2_s8(x8, wq, mul, add, act_scale=ACT_S)
    with pytest.raises(TypeError, match="act_scale"):
        tci.packed_conv2x2_dual_s8(x8, xb, wq, wq, mul, mul, mul, add,
                                   offset=(0, 0))
    with pytest.raises(TypeError, match="act_scale"):
        tci.rows_matmul_s8(xb, _t(_wq(np_rng, 64, 128)), mul, add)
    with pytest.raises(TypeError, match="act_scale"):
        tci.strided_conv4x4s2_s8(xb, _t(_wq(np_rng, 4, 4, 64, 128)), mul,
                                 add)
    got = tci.packed_conv2x2_s8(xb, wq, mul, add, act_scale=ACT_S)
    want = tci.packed_conv2x2_s8(tci.quant_inline(xb, ACT_S), wq, mul, add)
    assert torch.equal(got, want)
    assert tci.launches == before
    assert set(tci.NAMES) == set(tci.launches)
    for mode in tci.NAMES:  # every mode's wrapper and plain version exist
        assert callable(getattr(tci, tci.wrapper_of(mode)))
        assert callable(getattr(tci, f"{tci.wrapper_of(mode)}_plain"))
