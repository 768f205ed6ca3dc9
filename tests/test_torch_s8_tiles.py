"""H1's and H2's int8 loads, B layout and epilogues on the CPU.

The int8 modes of H1 and H2 run on the Hopper mainloop
(csrc/packed_conv2x2_fwd.cuh on csrc/sm90_igemm.cuh): output tiles of th ×
tw pixels (``tiles.tile_plan`` over 128 GEMM rows; H2 at 4O = 256 over 64)
laid out as th · (tw + 1) GEMM rows, A read per K block of 128 s8 channels
as one halo box, zero outside the tensor (TMA's fill), whose rows shifted by
u · (tw + 1) + v are tap (u, v)'s operand. H2's skip is one box at the
crop's packed origin for an even offset; at an odd offset (C = 32 and 64:
a K block holds slots of different origins) the producer warps gather it
16 channels at a time by the crop rule. A bf16 operand (the inline-quantize
modes) is gathered the same way and quantized once per K block by
QuantLoader's rule. B is the K-major copy wk [4O, 4 · 4C] of the s8 weight
(s8 wgmma has no transpose), one box of 128 K bytes per K block and tap.
H1 ends in relu(f32(acc) · mul + add), requantized or rounded to bf16, then
the pool and the head; H2 keeps one s32 accumulator per side and mixes them
as f32(acc_a) · cs_a + f32(acc_b) · cs_b first.

Here a torch emulation of those loads and epilogues (``_emulate``), whose
products are exact (float64 sums of s8 × s8), must give the same outputs,
bit for bit, as the port's plain versions, partial K blocks included, and
the codes of JAX's Pallas int8 modes in interpret mode (``conv2x2_padflat``
requant, pool, inline; ``conv2x2_pf2`` float and head;
``conv2x2_dual_padflat`` even offset, ``a_slot_phase`` at C = 32 and 64,
inline b). The products are exact on both sides, but XLA rounds the f32
epilogue in its own order, so against Pallas a code may differ by one on
at most 1e-3 of them (tests/test_torch_int8_kernels.py's bar; the dual's
mix moves one of 46592 at one case), a bf16 value by one bf16 step on at
most 1e-3, a mask only where the head's margin lies within bf16 rounding.
Then: ``UNetS2DInt8.plan`` makes the K-major copies, equal to
``wq.reshape(4 · 4C, 4O).T``; and the K-major descriptor's strides, read
from csrc/sm90_igemm.cuh, address every s8 element of each k32 step of an
A view or B stage where TMA's 128-byte swizzle put it.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_tpu.nn.pallas import conv_flat as jcf
from segmentation_tpu_torch.models.unet_int8 import _affine
from segmentation_tpu_torch.nn.kernels import conv_flat as cf
from segmentation_tpu_torch.nn.kernels import conv_int8 as ci
from segmentation_tpu_torch.nn.kernels.tiles import tile_plan

KC = 128  # s8 channels of a K block: one 128-byte swizzled row
OUT_S = 0.05
ACT_S = 1 / 16.0  # inv = 16 exactly: (k + 1/2) / 16 is a tie
CSRC = Path(cf.__file__).resolve().parents[2] / "csrc"


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes(rng, *shape):
    return _t(rng.integers(0, 128, size=shape).astype(np.int8))


def _wq(rng, *shape):
    return _t(rng.integers(-127, 128, size=shape).astype(np.int8))


def _acts(rng, *shape):
    """bf16 activations whose codes at ACT_S reach past 127, a third of
    them on a rounding tie."""
    k = rng.integers(0, 150, size=shape)
    frac = rng.choice([0.0, 0.5, 0.25], size=shape)
    x = (k + frac + (frac == 0.25) * rng.random(shape)) * ACT_S
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _scales(rng, k, o):
    """(chan_scale, bias): acc · cs / OUT_S ~ N(0, 60), bias / OUT_S ~
    N(0, 10)."""
    cs = (rng.random(o).astype(np.float32) + 0.5) * np.float32(
        OUT_S * 60.0 / (5376.0 * np.sqrt(k)))
    return cs, rng.normal(0, 10 * OUT_S, o).astype(np.float32)


def _jx(x):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


# ------------------------------------------------------------ the emulation
def _quantize(v, act_scale):
    """QuantLoader's rule on a gathered chunk: clip(rint(f32(x) · inv))."""
    inv = torch.tensor(ci.act_inverse(act_scale), dtype=torch.float32)
    return torch.clamp(torch.round(v.float() * inv), -127, 127)


def _x_block(x, n, i0, j0, th, wrow, k0, act_scale=None):
    """x's K block k0 .. k0 + 127 for tile (n, i0, j0): the TMA halo box
    [th + 1, wrow] (s8), or the same rows gathered chunk by chunk and
    quantized (bf16, act_scale); zero outside x and past 4C; flat rows, then
    wrow zero rows (a tap's view runs past the box)."""
    _, h, w, c4 = x.shape
    box = torch.zeros(th + 2, wrow, KC, dtype=torch.float64)
    si, sj = min(i0, h), min(j0, w)
    ei, ej = min(i0 + th + 1, h), min(j0 + wrow, w)
    k1 = min(k0 + KC, c4)
    if si < ei and sj < ej and k0 < k1:
        v = x[n, si:ei, sj:ej, k0:k1]
        v = v.double() if act_scale is None else _quantize(v, act_scale)
        box[si - i0:ei - i0, sj - j0:ej - j0, :k1 - k0] = v.double()
    return box.reshape(-1, KC)


def _skip_block(skip, c4, offset, n, i0, j0, th, wrow, k0, act_scale=None):
    """The skip's K block k0 as the kernel loads it: an even offset with s8
    codes is one TMA box at the crop's packed origin; else the producer
    warps gather it (FwdTiles::gather_a): chunk k = k0 + 16 q of box row
    (bi, bj) is slot s = k // C of the skip at unpacked (oh + 2 (i0 + bi) +
    s // 2, ow + 2 (j0 + bj) + s % 2), zero past 4C and outside the skip,
    quantized where the skip is bf16."""
    oh, ow = offset
    if oh % 2 == 0 and ow % 2 == 0 and act_scale is None:
        return _x_block(skip, n, oh // 2 + i0, ow // 2 + j0, th, wrow, k0)
    _, hpa, wpa, _ = skip.shape
    cs = c4 // 4
    rows = torch.zeros((th + 2) * wrow, KC, dtype=torch.float64)
    for row in range((th + 1) * wrow):
        bi, bj = divmod(row, wrow)
        for q in range(KC // 16):
            k = k0 + 16 * q
            if k >= c4:
                continue
            s = k // cs
            yy = oh + 2 * (i0 + bi) + (s >> 1)
            xx = ow + 2 * (j0 + bj) + (s & 1)
            if (yy >> 1) >= hpa or (xx >> 1) >= wpa:
                continue
            ch = (2 * (yy & 1) + (xx & 1)) * cs + k - s * cs
            v = skip[n, yy >> 1, xx >> 1, ch:ch + 16]
            rows[row, 16 * q:16 * q + 16] = (
                v.double() if act_scale is None
                else _quantize(v, act_scale).double())
    return rows


def _b_block(wk, kb, tap):
    """B of (K block, tap): the 128 K values tap · 4C + 128 kb .. of every
    column of the K-major wk [4O, 4 · 4C], zero past the weight
    (FwdTiles::load_b); as [128, 4O]."""
    o4, k4 = wk.shape
    flat = torch.cat([wk.double(), torch.zeros(o4, KC, dtype=torch.float64)],
                     1)
    c4 = k4 // 4
    r = tap * c4 + KC * kb
    return flat[:, r:r + KC].t()


def _side_acc(load, wk, c4, rows, wrow):
    """One side's exact s32 sum over its K blocks and taps."""
    acc = torch.zeros(rows, wk.shape[0], dtype=torch.float64)
    for kb in range(-(-c4 // KC)):
        a = load(kb)
        for tap in range(4):
            shift = (tap >> 1) * wrow + (tap & 1)
            acc += a[shift:shift + rows] @ _b_block(wk, kb, tap)
    return acc


def _finish(v, requant):
    if requant:
        return torch.clamp(torch.round(v), -127, 127)
    return v.to(torch.bfloat16).float()


def _emulate(x, wq, mul, add, *, requant=True, pool=False, head=None,
             act_scale=None, skip=None, wqa=None, cs_a=None, cs_b=None,
             offset=(0, 0), act_scale_a=None):
    """The kernel's loads, products and epilogue, one tile at a time:
    H1 (x against wq) or, with ``skip``, H2 (skip against wqa, x = up
    against wq, one accumulator a side). Returns (y, mask, pooled) as the
    kernel stores them (y f32 holding the codes or bf16 values)."""
    n, hp, wp, c4 = x.shape
    o4 = wq.shape[-1]
    ho, wo = hp - 1, wp - 1
    rows_max = ci.dual_tile_rows(o4) if skip is not None else \
        cf.FWD_TILE_ROWS
    plan = tile_plan(n, ho, wo, rows_max)
    th, tw, wrow = plan.th, plan.tw, plan.tw + 1
    rows = th * wrow
    wk = ci.k_major(wq)
    y = torch.full((n, ho, wo, o4), float("nan"))
    for t in range(plan.count):
        bn, i0, j0 = plan.origin(t)
        acc = _side_acc(lambda kb: _x_block(x, bn, i0, j0, th, wrow, KC * kb,
                                            act_scale), wk, c4, rows, wrow)
        if skip is None:
            v = torch.relu(acc.float() * mul + add)
        else:
            acc_a = _side_acc(lambda kb: _skip_block(
                skip, c4, offset, bn, i0, j0, th, wrow, KC * kb,
                act_scale_a), ci.k_major(wqa), c4, rows, wrow)
            mix = acc_a.float() * cs_a + acc.float() * cs_b
            v = torch.relu(mix * mul + add)
        v = _finish(v, requant).view(th, wrow, o4)[:, :tw]
        hi, wi = min(th, ho - i0), min(tw, wo - j0)
        y[bn, i0:i0 + hi, j0:j0 + wi] = v[:hi, :wi]
    assert not y.isnan().any()  # every pixel was stored
    outs = [y]
    if head is not None:
        wd, bd = head
        outs.append(((y @ wd.float() + bd) > 0).to(torch.uint8))
    if pool:
        outs.append(y.reshape(n, ho, wo, 4, o4 // 4).amax(3))
    return outs


def _as_kernel(outs, requant):
    """The emulation's outputs in the kernel's dtypes."""
    t = torch.int8 if requant else torch.bfloat16
    return [o if o.dtype == torch.uint8 else o.to(t) for o in outs]


def _outs(v):
    return list(v) if isinstance(v, tuple) else [v]


def _assert_same(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _codes_close(got, want):
    """Codes against Pallas's: within one, on at most 1e-3 of them."""
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype == torch.int8 and g.shape == w.shape
        d = (g.int() - w.int()).abs()
        assert d.max().item() <= 1
        assert (d > 0).float().mean().item() <= 1e-3


# ---------------------------------------------------------------- H1 tiles
# (N, hp, wp) of x with several tiles a image, ragged ones included, 4C, 4O
EMULATED = [(2, 20, 38, 128, 128), (1, 12, 22, 256, 256),
            (2, 18, 24, 128, 256)]


def _h1_case(rng, n, hp, wp, c4, o4, requant, inline=False):
    x = _acts(rng, n, hp, wp, c4) if inline else _codes(rng, n, hp, wp, c4)
    wq = _wq(rng, 2, 2, c4, o4)
    cs, b = _scales(rng, 4 * c4, o4)
    if not requant:
        cs, b = cs / np.float32(20 * OUT_S), b / np.float32(20 * OUT_S)
    return x, wq, cs, b


@pytest.mark.parametrize("mode", ["requant", "pool", "inline"])
@pytest.mark.parametrize("n,hp,wp,c4,o4", EMULATED)
def test_emulated_s8_boxes_match_pallas_padflat(np_rng, n, hp, wp, c4, o4,
                                                mode):
    inline = mode == "inline"
    x, wq, cs, b = _h1_case(np_rng, n, hp, wp, c4, o4, True, inline)
    q = {"chan_scale": jnp.asarray(cs), "out_scale": OUT_S}
    if inline:
        q["act_scale"] = ACT_S
    pool = mode != "requant"
    s = jcf.stride_for(wp, jnp.int8)
    want = jcf.conv2x2_padflat(jcf.pad_rows(_jx(x), s), jnp.asarray(wq),
                               jnp.asarray(b), h=hp, w_real=wp, s=s,
                               r_block=4, quant=q, pool=pool, interpret=True)
    want = [_t(np.asarray(jcf.unpad_rows(v, s, hp - 1, wp - 1)))
            for v in (want if isinstance(want, tuple) else (want,))]
    mul, add = _affine(_t(cs), _t(b), OUT_S)
    act = ACT_S if inline else None
    got = _as_kernel(_emulate(x, wq, mul, add, pool=pool, act_scale=act),
                     True)
    _codes_close(got, want)
    _assert_same(got, _outs(ci.packed_conv2x2_s8_plain(
        x, wq, mul, add, pool=pool, act_scale=act)))


@pytest.mark.parametrize("mode", ["float", "head_only"])
def test_emulated_s8_float_and_head_match_pallas_pf2(np_rng, mode):
    """conv9_2's modes: the bf16 value, and the head on it."""
    n, hp, wp, c4, o4 = 2, 15, 26, 128, 128
    x, wq, cs, b = _h1_case(np_rng, n, hp, wp, c4, o4, False)
    wd = np_rng.normal(size=(o4, 4)).astype(np.float32)
    bd = np_rng.normal(size=(4,)).astype(np.float32)
    kw = {}
    if mode == "head_only":
        kw = {"head": (jnp.asarray(wd), jnp.asarray(bd)), "head_only": True}
    s2 = jcf.stride_for((wp + 1) // 2, jnp.int8)
    want = jcf.conv2x2_pf2(jcf.pad_pairs(_jx(x), s2), jnp.asarray(wq),
                           jnp.asarray(b), h=hp, w_real=wp, s2=s2, r_block=4,
                           quant={"chan_scale": jnp.asarray(cs)},
                           interpret=True, **kw)
    want = np.asarray(jcf.unpad_pairs(want, s2, hp - 1, wp - 1))
    mul, add = _affine(_t(cs), _t(b), None)
    head = (_t(wd).to(torch.bfloat16), _t(bd))
    y, mask = _emulate(x, wq, mul, add, requant=False, head=head)
    if mode == "float":
        # XLA's f32 epilogue may round one value to the neighbouring bf16
        # (the plain version's order is the kernel's: held exactly below)
        got, want = y.numpy(), np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=0)
        assert (got != want).mean() <= 1e-3
        _assert_same(_as_kernel([y], False), _outs(
            ci.packed_conv2x2_s8_plain(x, wq, mul, add, requant=False)))
        return
    margin = (y @ head[0].float() + head[1]).numpy()
    diff = mask.numpy() != want
    assert np.all(np.abs(margin[diff]) <= 2.0**-7 * np.abs(margin).max())
    assert diff.mean() < 1e-3
    _assert_same(_as_kernel([y, mask], False), _outs(
        ci.packed_conv2x2_s8_plain(x, wq, mul, add, requant=False,
                                   head=head)))


@pytest.mark.parametrize("inline", [False, True])
@pytest.mark.parametrize("c4", [16, 48, 144])
@pytest.mark.parametrize("o4", [128, 256])
def test_emulated_s8_partial_k_blocks_match_plain(np_rng, c4, o4, inline):
    """4C = 16 and 48: one K block of 16 / 48 channels and TMA's zeros,
    its B columns the next taps'; 4C = 144: a second block of 16."""
    x, wq, cs, b = _h1_case(np_rng, 2, 9, 13, c4, o4, True, inline)
    mul, add = _affine(_t(cs), _t(b), OUT_S)
    act = ACT_S if inline else None
    got = _as_kernel(_emulate(x, wq, mul, add, pool=True, act_scale=act),
                     True)
    _assert_same(got, _outs(ci.packed_conv2x2_s8_plain(
        x, wq, mul, add, pool=True, act_scale=act)))


# ---------------------------------------------------------------- H2 tiles
# (up's N, hp, wp), the skip 4 packed pixels larger, 4C, 4O, offset
DUAL = [((2, 10, 22), 128, 128, (4, 2)), ((2, 10, 22), 128, 128, (3, 5)),
        ((1, 9, 17), 256, 256, (6, 4)), ((1, 9, 17), 256, 256, (5, 7)),
        ((2, 8, 14), 128, 256, (2, 3)), ((1, 8, 14), 256, 128, (1, 0))]


def _dual_case(rng, shape, c4, o4, inline_a=False, inline_b=False):
    n, hp, wp = shape
    skip = (_acts(rng, n, hp + 4, wp + 4, c4) if inline_a
            else _codes(rng, n, hp + 4, wp + 4, c4))
    up = _acts(rng, n, hp, wp, c4) if inline_b else _codes(rng, n, hp, wp,
                                                            c4)
    wqa, wqb = _wq(rng, 2, 2, c4, o4), _wq(rng, 2, 2, c4, o4)
    csa, b = _scales(rng, 8 * c4, o4)
    csb, _ = _scales(rng, 8 * c4, o4)
    return skip, up, wqa, wqb, csa, csb, b


def _dual_emulate(skip, up, wqa, wqb, csa, csb, mul, add, offset,
                  act_a=None, act_b=None):
    (y,) = _emulate(up, wqb, mul, add, act_scale=act_b, skip=skip, wqa=wqa,
                    cs_a=_t(csa), cs_b=_t(csb), offset=offset,
                    act_scale_a=act_a)
    return y.to(torch.int8)


@pytest.mark.parametrize("inline_b", [False, True])
@pytest.mark.parametrize("shape,c4,o4,offset", DUAL)
def test_emulated_s8_dual_matches_pallas_padflat(np_rng, shape, c4, o4,
                                                 offset, inline_b):
    """Even offsets: one skip box at the crop's packed origin; odd (C = 32
    and 64): the skip gathered chunk by chunk; inline b: up gathered and
    quantized (the 4-D route's and bf16 deconvs' sites)."""
    skip, up, wqa, wqb, csa, csb, b = _dual_case(np_rng, shape, c4, o4,
                                                 inline_b=inline_b)
    n, hp, wp = shape
    even = offset[0] % 2 == 0 and offset[1] % 2 == 0
    kw = (dict(a_offset=(offset[0] // 2, offset[1] // 2)) if even
          else dict(a_offset=(0, 0), a_slot_phase=offset))
    q = {"chan_scale_a": jnp.asarray(csa), "chan_scale_b": jnp.asarray(csb),
         "out_scale": OUT_S}
    if inline_b:
        q["act_scale_b"] = ACT_S
    sa, sb = jcf.stride_for(wp + 4, jnp.int8), jcf.stride_for(wp, jnp.int8)
    xaf = jcf.pad_rows(_jx(skip), sa)
    want = jcf.conv2x2_dual_padflat(
        xaf, jcf.pad_rows(_jx(up), sb), jnp.asarray(wqa), jnp.asarray(wqb),
        jnp.asarray(b), h=hp, w_real=wp, s=sb, s_a=sa,
        hp_a=xaf.shape[1] // sa, r_block=4, quant=q, interpret=True, **kw)
    want = _t(np.asarray(jcf.unpad_rows(want, sb, hp - 1, wp - 1)))
    mul, add = _affine(torch.ones(o4), _t(b), OUT_S)
    act_b = ACT_S if inline_b else None
    got = _dual_emulate(skip, up, wqa, wqb, csa, csb, mul, add, offset,
                        act_b=act_b)
    _codes_close([got], [want])
    _assert_same([got], [ci.packed_conv2x2_dual_s8_plain(
        skip, up, wqa, wqb, _t(csa), _t(csb), mul, add, offset=offset,
        act_scale_b=act_b)])


@pytest.mark.parametrize("inline", ["", "a", "b", "ab"])
@pytest.mark.parametrize("c4,offset", [(64, (0, 0)), (64, (3, 5)),
                                       (192, (2, 4)), (192, (5, 2)),
                                       (256, (7, 7))])
def test_emulated_s8_dual_two_accumulators_match_plain(np_rng, c4, offset,
                                                       inline):
    """The two-accumulator mix, exact against the plain version: 4C = 64
    (one partial K block a side), 192 (a second block of 64), 256; every
    crop parity; each side resident or quantized inline."""
    skip, up, wqa, wqb, csa, csb, b = _dual_case(
        np_rng, (2, 7, 11), c4, 256, "a" in inline, "b" in inline)
    mul, add = _affine(torch.ones(256), _t(b), OUT_S)
    act_a = ACT_S if "a" in inline else None
    act_b = ACT_S if "b" in inline else None
    got = _dual_emulate(skip, up, wqa, wqb, csa, csb, mul, add, offset,
                        act_a, act_b)
    want = ci.packed_conv2x2_dual_s8_plain(
        skip, up, wqa, wqb, _t(csa), _t(csb), mul, add, offset=offset,
        act_scale_a=act_a, act_scale_b=act_b)
    _assert_same([got], [want])


@pytest.mark.parametrize("shape", [(8, 83, 83), (8, 163, 163), (3, 19, 44),
                                   (1, 1, 39), (1, 39, 1)])
@pytest.mark.parametrize("o4", [128, 256])
def test_dual_s8_tile_plan_covers_once(shape, o4):
    """H2 s8's tiles (64 GEMM rows at 4O = 256) cover every output pixel
    once, conv8_1's and conv9_1's grids included."""
    rows = ci.dual_tile_rows(o4)
    assert rows == (128 if o4 == 128 else 64)
    plan = tile_plan(*shape, rows)
    assert plan.th * (plan.tw + 1) <= rows
    hits = np.zeros(shape, np.int64)
    for t in range(plan.count):
        n, i0, j0 = plan.origin(t)
        hits[n, i0:i0 + plan.th, j0:j0 + plan.tw] += 1
    assert (hits == 1).all()


# ------------------------------------------------------- the K-major copies
def test_plan_makes_the_k_major_copies(np_rng):
    from segmentation_tpu_torch.core.config import ModelConfig
    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.models.unet import init_params
    from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8

    cfg = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=4)
    model = UNetS2DInt8(cfg)
    x = torch.rand(1, 188, 188, 3, generator=generator(3))
    p = model.prepare(init_params(cfg, generator(0)), calib_batches=[x])
    pairs = [(f"{s}/wk", f"{s}/wq") for s in model.sites.packed]
    pairs += [(f"{s}/wk_{side}", f"{s}/wq_{side}") for s in model.sites.dual
              for side in "ab"]
    for wk, wq in pairs:
        w = p[wq]
        c4, o4 = w.shape[2], w.shape[3]
        assert p[wk].is_contiguous() and p[wk].dtype == torch.int8
        assert torch.equal(p[wk], w.reshape(4 * c4, o4).T), wk
        # row o, K index tap · 4C + c: w[u, v, c, o] with tap = 2u + v
        assert p[wk][5, 2 * c4 + 3] == w[1, 0, 3, 5]


# ------------------------------------------------------------ the layout
def _sw128(addr):
    """The 128-byte swizzle of a shared address (1024-byte aligned base):
    its 16-byte chunk index XOR its 128-byte row index mod 8."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _k_major_constants():
    """(SBO, A's k-step, A's m64 step, B's K-major k-step), in bytes, and
    the K of one s8 wgmma, as csrc/sm90_igemm.cuh writes them."""
    src = (CSRC / "sm90_igemm.cuh").read_text()
    body = re.search(r"uint64_t sw128_desc\(const void\* p\) \{(.*?)\}",
                     src, re.S).group(1)
    sbo = int(re.search(r"\(\(uint64_t\)\((\d+) >> 4\) << 32\)",
                        body).group(1))
    assert "((uint64_t)1 << 16)" in body and "<< 62" in body  # layout 1
    a = re.search(r"da \+ (\d+) \* mi \+ (\d+) \* ks", src)
    b_step = int(re.search(r"b_step = P::B_MN \? 2048 >> 4 : (\d+);",
                           src).group(1))
    ks = {int(k) for k in re.findall(
        r"wgmma\.mma_async\.sync\.aligned\.m64n(?:128|256)k(\d+)"
        r"\.s32\.s8\.s8", src)}
    assert ks == {32}, ks
    return sbo, 16 * int(a.group(2)), 16 * int(a.group(1)), 16 * b_step


def test_s8_maps_box_one_swizzled_row_per_k_block():
    """The s8 A and B maps box 128 one-byte channels a row (TMA's uint8
    type, the 128-byte swizzle), one K block of KC channels."""
    src = (CSRC / "packed_conv2x2_fwd.cuh").read_text()
    maps = re.search(r"inline int fwd_maps_s8\(.*?\n\}\n", src, re.S).group(0)
    assert "xbox[4] = {128," in maps and "wbox[2] = {128," in maps
    assert maps.count("sm90::kMapS8") == 2
    assert "static constexpr int KC = INT8 ? 128 : 64;" in src
    sm90 = (CSRC / "sm90_igemm.cuh").read_text()
    assert re.search(r"kMapS8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;", sm90)


@pytest.mark.parametrize("shift", [0, 1, 42, 43, 126])
def test_k_major_descriptor_reads_s8_where_tma_writes_a(shift):
    """Element (m, k) of each k32 step of a tap's A view (the slot's rows
    from `shift` on, m64 group mi): the canonical K-major 128-byte-swizzled
    address (K bytes contiguous in 128-byte rows, 8-row groups SBO apart,
    the step's 32 bytes on; then the swizzle of the address itself) is the
    byte where TMA put box row shift + m, channel 32 ks + k."""
    sbo, a_step, mi_step, _ = _k_major_constants()
    assert (a_step, mi_step, sbo) == (32, 64 * 128, 1024)
    m = np.arange(64)[:, None]
    k = np.arange(32)[None, :]
    for mi in range(2):
        start = shift * 128 + mi * mi_step
        for ks in range(KC // 32):
            canon = start + ks * a_step + (m // 8) * sbo + (m % 8) * 128 + k
            tma = (shift + 64 * mi + m) * 128 + 32 * ks + k
            np.testing.assert_array_equal(_sw128(canon), _sw128(tma))


@pytest.mark.parametrize("nb", [128, 256])
def test_k_major_descriptor_reads_s8_where_tma_writes_b(nb):
    """Every element (c, k) of each k32 step of a B stage (column c's 128 K
    bytes a row, as the box [4O, 128] lands; SPLIT_N's consumer 1 from row
    128 on) is read where TMA's swizzle put it."""
    sbo, _, _, b_step = _k_major_constants()
    assert b_step == 32
    c = np.arange(nb)[:, None]
    k = np.arange(32)[None, :]
    for off in ((0, 128) if nb == 256 else (0,)):
        cc = c[: nb - off]
        for ks in range(KC // 32):
            canon = off * 128 + ks * b_step + (cc // 8) * sbo \
                + (cc % 8) * 128 + k
            tma = (off + cc) * 128 + 32 * ks + k
            np.testing.assert_array_equal(_sw128(canon), _sw128(tma))
    # each stage's bytes: NB rows of 128, the ring's B_BYTES = NB · 128
    src = (CSRC / "sm90_igemm.cuh").read_text()
    assert "static constexpr int B_BYTES = P::NB * 128;" in src
