"""H8 (the std levels' int8 3×3 conv) and H4's int8 modes on the CPU.

H8, csrc/std_conv3x3_s8.cu, computes the JAX package's int8_conv and
int8_std_dual_conv (segmentation_tpu/models/unet_int8.py :72, :104; XLA,
no Pallas kernel) with the epilogue fused. Its plain versions
(conv_int8.std_conv3x3_s8_plain, std_conv3x3_dual_s8_plain, reached
through models/unet_int8.py int8_conv / int8_std_dual_conv) must give
JAX's codes and bf16 values exactly: the s32 products are exact on both
sides and every epilogue step is one f32 operation in the same order
(held here; the dual's requant divides by out_scale, which a multiply by
f32(1/out_scale) does not match: a case where they differ is built). The
std levels quantize a bf16 side by the division too (``quant_act``).

The kernel's loads are emulated in torch (``_emulate_std``): output tiles
of th × tw pixels (``tiles.std_plan``) as th · (tw + 2) GEMM rows, A per
K block of 128 s8 channels the halo box [th + 2, tw + 2] (zeros past C and
past the tensor, as TMA fills), the nine taps its rows shifted by u (tw +
2) + v, rows past the box whatever the slot held (here random codes:
only junk rows read them); C <= 64 runs the first 64 K bytes of the block
(two k32 steps); B the K-major ``wk`` [O, 9C] as boxes of 128 K bytes at
tap · C + 128 kb (zeros past 9C), column tiles of NB; the dual's skip box
at the crop origin, a bf16 side gathered and quantized by the division,
one accumulator a side. The emulation equals the plain versions bit for
bit. Then the tile plans cover every output once within the kernel's
bounds, ``UNetS2DInt8.plan`` makes the K-major copies, and H4's int8 loads
(the identity box, the scatter and the inline modes gathered) equal the
plain version and, within one code on at most 1e-3 of them (XLA's own
epilogue order; tests/test_torch_int8_kernels.py's bar), the Pallas int8
modes in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_tpu.models import unet_int8 as jq
from segmentation_tpu.nn.pallas import conv_flat as jcf
from segmentation_tpu_torch.models import unet_int8 as tq
from segmentation_tpu_torch.models.unet_int8 import _affine
from segmentation_tpu_torch.nn.kernels import conv_int8 as ci
from segmentation_tpu_torch.nn.kernels.tiles import std_plan, std_tile

KC = 128
ACT_S = 1 / 16.0
OUT_S = 0.05


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes(rng, *shape, lo=0):
    return _t(rng.integers(lo, 128, size=shape).astype(np.int8))


def _wq(rng, *shape):
    return _t(rng.integers(-127, 128, size=shape).astype(np.int8))


def _acts(rng, *shape):
    """bf16 activations whose codes at ACT_S reach past 127, many of them
    on a rounding tie."""
    k = rng.integers(0, 150, size=shape)
    frac = rng.choice([0.0, 0.5, 0.25], size=shape)
    x = (k + frac + (frac == 0.25) * rng.random(shape)) * ACT_S
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _jx(x):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _scales(rng, k, o):
    """Weight scales and bias with acc · ws · act / OUT_S ~ N(0, 60) for
    s8 operands (acc std ~ 5376 · √k), bias / OUT_S ~ N(0, 10)."""
    ws = (rng.random(o).astype(np.float32) + 0.5) * np.float32(
        OUT_S * 60.0 / (5376.0 * np.sqrt(k) * ACT_S))
    return _t(ws), _t(rng.normal(0, 10 * OUT_S, o).astype(np.float32))


def _equal(got, want):
    want = np.asarray(want)
    got = got.float().numpy() if got.dtype == torch.bfloat16 else \
        got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))


# ------------------------------------------ the plain versions against JAX
@pytest.mark.parametrize("c,o", [(64, 128), (128, 256)])
@pytest.mark.parametrize("out_scale", [OUT_S, None], ids=["s8", "bf16"])
def test_std_single_matches_jax_code_for_code(np_rng, c, o, out_scale):
    x = _codes(np_rng, 2, 9, 11, c)
    wq = _wq(np_rng, 3, 3, c, o)
    ws, b = _scales(np_rng, 9 * c, o)
    want = jq.int8_conv(_jx(x), _jx(wq), _jx(ws), jnp.float32(ACT_S),
                        _jx(b), out_scale=out_scale)
    got = tq.int8_conv(x, wq, ws, ACT_S, b, out_scale=out_scale)
    assert got.dtype == (torch.int8 if out_scale else torch.bfloat16)
    _equal(got, want)


@pytest.mark.parametrize("offset", [(2, 2), (3, 1)], ids=["even", "odd"])
@pytest.mark.parametrize("sides", ["s8 bf16", "bf16 bf16", "s8 s8"])
@pytest.mark.parametrize("c,out_scale", [(64, OUT_S), (128, OUT_S),
                                         (64, None)],
                         ids=["C=64 s8", "C=128 s8", "C=64 bf16"])
def test_std_dual_matches_jax_code_for_code(np_rng, c, out_scale, sides,
                                            offset):
    """int8_std_dual_conv on the whole skip and its crop origin against
    JAX's on the cropped skip: s8 or bf16 sides, even and odd crops."""
    o, (n, h, w) = c, (2, 8, 9)
    hs, ws_ = h + 2 * offset[0] + 1, w + 2 * offset[1] + 2
    sk_bf16, up_bf16 = (s == "bf16" for s in sides.split())
    sk = (_acts if sk_bf16 else _codes)(np_rng, n, hs, ws_, c)
    up = (_acts if up_bf16 else _codes)(np_rng, n, h, w, c)
    wqa, wqb = _wq(np_rng, 3, 3, c, o), _wq(np_rng, 3, 3, c, o)
    wsa, _ = _scales(np_rng, 18 * c, o)
    wsb, b = _scales(np_rng, 18 * c, o)
    oh, ow = offset
    crop = sk[:, oh:oh + h, ow:ow + w]
    want = jq.int8_std_dual_conv(_jx(crop), _jx(up), _jx(wqa), _jx(wsa),
                                 ACT_S, _jx(wqb), _jx(wsb), ACT_S, _jx(b),
                                 out_scale=out_scale)
    got = tq.int8_std_dual_conv(sk, up, wqa, wsa, ACT_S, wqb, wsb, ACT_S, b,
                                out_scale=out_scale, offset=offset)
    _equal(got, want)


def test_std_dual_requant_divides():
    """With zero weights the dual's sum is its bias, so its codes are
    rint(b / out_scale): a bias where the division and a multiply by
    f32(1 / out_scale) round to different codes shows that the plain
    version (and JAX) divide."""
    out = np.float32(0.0123)
    inv = np.float32(1.0) / out
    cand = ((np.arange(1, 127, dtype=np.float32) + np.float32(0.5)) * out)
    bits = cand.view(np.int32)[:, None] + np.arange(-3, 4, dtype=np.int32)
    b = bits.reshape(-1).view(np.float32)
    differ = np.rint(b / out) != np.rint(b * inv)
    assert differ.any()
    b = b[differ][:128]
    o, c = 128, 16
    b = np.resize(b, o).astype(np.float32)
    zeros = torch.zeros((3, 3, c, o), dtype=torch.int8)
    x = torch.zeros((1, 3, 3, c), dtype=torch.int8)
    ones = torch.ones(o)
    got = ci.std_conv3x3_dual_s8_plain(x, x, zeros, zeros, ones, ones,
                                       _t(b), out_scale=float(out))
    want = np.clip(np.rint(np.maximum(b / out, 0)), -127, 127)
    assert np.array_equal(got.reshape(-1).numpy(), want.astype(np.int8))
    recip = np.clip(np.rint(np.maximum(b * inv, 0)), -127, 127)
    assert not np.array_equal(got.reshape(-1).numpy(), recip.astype(np.int8))
    jwant = jq.int8_std_dual_conv(
        _jx(x), _jx(x), _jx(zeros), jnp.ones(o), 1.0, _jx(zeros),
        jnp.ones(o), 1.0, jnp.asarray(b), out_scale=jnp.float32(out))
    _equal(got, jwant)


def test_quant_act_divides_like_jax():
    """quant_act is JAX's _quant_act (a division) on values at and next to
    the ties of 20 scales; the Pallas rule (quant_inline, a multiply by
    f32(1/scale)) differs on some of them."""
    rng = np.random.default_rng(1)
    scales = (rng.uniform(1, 2, 20) * 2.0 ** rng.integers(-12, -2, 20))
    differ = 0
    for s in scales.astype(np.float32):
        ties = (np.arange(-130, 130, dtype=np.float32) + np.float32(0.5)) * s
        bits = ties.astype(np.float32).view(np.int32)[:, None] + \
            np.arange(-4, 5, dtype=np.int32)
        x = bits.reshape(-1).view(np.float32)
        want = np.asarray(jq._quant_act(jnp.asarray(x), jnp.float32(s)))
        got = tq.quant_act(torch.from_numpy(x), float(s))
        np.testing.assert_array_equal(got.numpy(), want)
        differ += int((ci.quant_inline(torch.from_numpy(x), float(s))
                       != got).sum())
    assert differ > 0


# ------------------------------------------------------- the emulation
def _box(x, n, r0, c0, rows, cols, k0, act_scale=None):
    """K block k0 of x's box [rows, cols] at (n, r0, c0): TMA's (zeros
    past the tensor and past C) or, for a bf16 side, the same gathered and
    quantized by the division. [rows · cols, 128] float64."""
    _, h, w, c = x.shape
    out = torch.zeros((rows, cols, KC), dtype=torch.float64)
    r1, c1 = min(r0 + rows, h), min(c0 + cols, w)
    k1 = min(k0 + KC, c)
    if r1 > r0 and c1 > c0 and k1 > k0:
        v = x[n, r0:r1, c0:c1, k0:k1]
        if act_scale is not None:
            v = ci.quant_act(v, act_scale)
        out[: r1 - r0, : c1 - c0, : k1 - k0] = v.double()
    return out.reshape(rows * cols, KC)


def _wk_box(wk, k, cb, nb):
    """B of (K block, tap) for column tile cb: wk's 128 K bytes from k,
    zeros past 9C. [nb, 128] float64."""
    o, kk = wk.shape
    out = torch.zeros((nb, KC), dtype=torch.float64)
    k1 = min(k + KC, kk)
    out[:, : k1 - k] = wk[cb * nb:(cb + 1) * nb, k:k1].double()
    return out


def _emulate_std(sides, o, plan_ho_wo, dual, gen):
    """H8's loads, products and raw accumulators for the sides [(x, wk,
    origin, act_scale)]: per tile and column tile, one accumulator a side
    over its K blocks and nine taps. Returns [N, ho, wo, o] float64 per
    side."""
    n = sides[0][0].shape[0]
    c = sides[0][0].shape[-1]
    ho, wo = plan_ho_wo
    nb, bm, w_max = std_tile(o, 2 if dual else 1)
    plan = std_plan(n, ho, wo, o, 2 if dual else 1)
    assert plan.th * (plan.tw + 2) <= bm and plan.tw + 2 <= w_max
    a_rows = (bm + 2 * w_max + 2 + 7) // 8 * 8
    kps = -(-c // KC)
    ksteps = 64 if not dual and c <= 64 else KC  # K bytes a block runs
    th, tw, w = plan.th, plan.tw, plan.tw + 2
    accs = [torch.zeros((n, ho, wo, o), dtype=torch.float64) for _ in sides]
    for t in range(plan.count):
        n_, i0, j0 = plan.origin(t)
        m = torch.arange(bm)
        a, b = m // w, m % w
        ok = (a < th) & (b < tw) & (i0 + a < ho) & (j0 + b < wo)
        for cb in range(o // nb):
            for s, (x, wk, (oh, ow), act) in enumerate(sides):
                acc = torch.zeros((bm, nb), dtype=torch.float64)
                for kb in range(kps):
                    box = _box(x, n_, oh + i0, ow + j0, th + 2, w, KC * kb,
                               act)
                    slot = torch.randint(-128, 128, (a_rows, KC),
                                         generator=gen).double()
                    slot[: box.shape[0]] = box
                    for tap in range(9):
                        sh = tap // 3 * w + tap % 3
                        at = slot[sh:sh + bm, :ksteps]
                        bt = _wk_box(wk, tap * c + KC * kb, cb, nb)
                        acc += at @ bt[:, :ksteps].T
                pix = acc[ok]
                accs[s][n_, (i0 + a)[ok], (j0 + b)[ok],
                        cb * nb:(cb + 1) * nb] = pix
    return accs


@pytest.mark.parametrize("c,o,shape", [
    (64, 128, (2, 11, 13)),    # conv3_1's C: half a K block, tiles of 256
    (128, 256, (1, 9, 12)),    # a full block, tiles of 128
    (48, 512, (1, 6, 7)),      # O = 512: two column tiles
    (192, 128, (2, 5, 17)),    # a second, partial K block
    (16, 128, (1, 4, 140)),    # rows wider than W_MAX: two tiles a row
])
@pytest.mark.parametrize("requant", [True, False], ids=["s8", "bf16"])
def test_emulated_std_single_matches_plain(np_rng, c, o, shape, requant):
    n, h, w = shape
    x, wq = _codes(np_rng, n, h, w, c, lo=-127), _wq(np_rng, 3, 3, c, o)
    ws, b = _scales(np_rng, 9 * c, o)
    mul, add = [v.float() for v in ci.std_affine(
        ws, ACT_S, b, OUT_S if requant else None)]
    wk = ci.k_major(wq)
    (acc,) = _emulate_std([(x, wk, (0, 0), None)], o, (h - 2, w - 2), False,
                          torch.Generator().manual_seed(0))
    got = ci._finish(acc, mul, add, requant)
    want = ci.std_conv3x3_s8_plain(x, wq, mul, add, requant=requant, wk=wk)
    assert torch.equal(got, want)


def _dual_epilogue(acc_a, acc_b, cs_a, cs_b, b, out_scale):
    """The kernel's dual epilogue, one f32 operation at a time."""
    ya = (acc_a.float() * cs_a).to(torch.bfloat16).float()
    v = (ya + acc_b.float() * cs_b) + b
    if out_scale is None:
        return torch.relu(v).to(torch.bfloat16)
    q = torch.relu(v / ci.f32_scale(out_scale))
    return torch.clamp(torch.round(q), -127, 127).to(torch.int8)


@pytest.mark.parametrize("c,o,offset", [(128, 128, (3, 5)),
                                        (64, 256, (2, 2)),
                                        (32, 512, (1, 4))])
@pytest.mark.parametrize("sides", ["s8 bf16", "bf16 s8"])
@pytest.mark.parametrize("out_scale", [OUT_S, None], ids=["s8", "bf16"])
def test_emulated_std_dual_matches_plain(np_rng, c, o, offset, sides,
                                         out_scale):
    n, h, w = 2, 7, 9
    oh, ow = offset
    sk_bf16, up_bf16 = (s == "bf16" for s in sides.split())
    sk = (_acts if sk_bf16 else _codes)(np_rng, n, h + 2 * oh + 1,
                                        w + 2 * ow, c)
    up = (_acts if up_bf16 else _codes)(np_rng, n, h, w, c)
    wqa, wqb = _wq(np_rng, 3, 3, c, o), _wq(np_rng, 3, 3, c, o)
    wsa, _ = _scales(np_rng, 18 * c, o)
    wsb, b = _scales(np_rng, 18 * c, o)
    cs_a, cs_b = ci.std_dual_scales(wsa, ACT_S, wsb, ACT_S)
    act_a = ACT_S if sk_bf16 else None
    act_b = ACT_S if up_bf16 else None
    acc_a, acc_b = _emulate_std(
        [(sk, ci.k_major(wqa), offset, act_a),
         (up, ci.k_major(wqb), (0, 0), act_b)], o, (h - 2, w - 2), True,
        torch.Generator().manual_seed(1))
    got = _dual_epilogue(acc_a, acc_b, cs_a, cs_b, b, out_scale)
    want = ci.std_conv3x3_dual_s8_plain(
        sk, up, wqa, wqb, cs_a, cs_b, b, out_scale=out_scale, offset=offset,
        act_scale_a=act_a, act_scale_b=act_b)
    assert torch.equal(got, want)


# ------------------------------------------------------------ tile plans
@pytest.mark.parametrize("o,dual", [(128, False), (256, False),
                                    (512, False), (128, True), (256, True),
                                    (128, "bf16"), (256, "bf16"),
                                    (512, "bf16")])
@pytest.mark.parametrize("shape", [(8, 123, 123), (8, 121, 121), (8, 58, 58),
                                   (8, 56, 56), (8, 26, 26), (8, 24, 24),
                                   (8, 44, 44), (8, 84, 84), (8, 46, 46),
                                   (8, 86, 86), (3, 1, 298), (2, 17, 1),
                                   (64, 121, 121), (64, 24, 24)])
def test_std_plan_covers_every_output_once(shape, o, dual):
    """At the request's sites (B = 8 and 64) and odd shapes: every output
    pixel in exactly one tile, each tile within the kernel's GEMM rows and
    row width, TMA's 256 a side. ``dual``: H8 s8's single (False) or dual
    (True) plan, or "bf16", the bf16 mode's (one accumulator, so its dual
    tiles as its single), each from tiles.std_plan as its wrapper calls
    it."""
    acc = 2 if dual is True else 1  # the s8 dual: one accumulator a side
    nb, bm, w_max = std_tile(o, acc)
    plan = std_plan(*shape, o, acc)
    assert plan.th * (plan.tw + 2) <= bm and plan.tw + 2 <= w_max
    assert plan.th + 2 <= 256
    hits = torch.zeros(shape, dtype=torch.int32)
    for t in range(plan.count):
        n, i0, j0 = plan.origin(t)
        hits[n, i0:i0 + plan.th, j0:j0 + plan.tw] += 1
    assert (hits == 1).all()
    assert o % nb == 0


# ------------------------------------------------- plan's K-major copies
def test_plan_makes_the_std_and_deconv_copies():
    from segmentation_tpu_torch.core.config import ModelConfig
    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.models.unet import init_params

    cfg = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=4)
    model = tq.UNetS2DInt8(cfg)
    x = torch.rand(1, 188, 188, 3, generator=generator(3))
    p = model.prepare(init_params(cfg, generator(0)), calib_batches=[x])
    std, dual = model.sites.std, model.sites.std_dual
    pairs = [(f"{s}/wk", f"{s}/wq") for s in std if s not in dual]
    pairs += [(f"{s}/wk_{side}", f"{s}/wq_{side}") for s in dual
              for side in "ab"]
    for wk, wq in pairs:
        w = p[wq]
        c, o = w.shape[2], w.shape[3]
        assert p[wk].is_contiguous() and p[wk].dtype == torch.int8
        assert torch.equal(p[wk], w.reshape(9 * c, o).T), wk
        # row o, K index tap · C + c: w[u, v, c, o] with tap = 3u + v
        assert p[wk][3, 5 * c + 2] == w[1, 2, 2, 3]
    for up in model.sites.ups:  # quant_deconvs: each one int8
        assert torch.equal(p[f"{up}/wkm"], p[f"{up}/wqm"].T)
        assert p[f"{up}/wkm"].is_contiguous()
    for s in std:  # the epilogue vectors, host f32 as std_affine makes them
        if s in dual:
            want = ci.std_dual_scales(
                p[f"{s}/wscale_a"], model._skip_scale_of(p, s),
                p[f"{s}/wscale_b"], model._in_scale_of(p, s, "b"))
            got = (p[f"{s}/qcs_a"], p[f"{s}/qcs_b"])
        else:
            want = ci.std_affine(p[f"{s}/wscale"], model._in_scale_of(p, s),
                                 p[f"{s}/b"], model._out_scale_of(p, s))
            got = (p[f"{s}/qmul"], p[f"{s}/qadd"])
        for g, wv in zip(got, want):
            assert g.dtype == torch.float32 and torch.equal(g, wv)


# ----------------------------------------------------------- H4 int8
def _emulate_rows(x, wqm, mul, add, scatter, act_scale):
    """H4 int8's loads: tiles of th × tw output pixels (rows_s8_plan) as th
    · tw GEMM rows; the identity's K block the TMA box of x (zeros past C
    and the grid), the scatter and the inline modes each row's source
    pixel (slot) gathered, quantized by the Pallas multiply; B the K-major
    wkm's 128 K bytes a block."""
    n, hi, wi, cx = x.shape
    c, o4 = wqm.shape
    ho, wo = (2 * hi, 2 * wi) if scatter else (hi, wi)
    src = x
    if scatter:
        src = x.reshape(n, hi, wi, 2, 2, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(n, ho, wo, c)
    if act_scale is not None:
        src = ci.quant_inline(src, act_scale)
    wkm = ci.k_major(wqm)
    plan = ci.rows_s8_plan(n, ho, wo)
    assert plan.th * plan.tw <= 128
    out = torch.zeros((n, ho, wo, o4), dtype=torch.float64)
    for t in range(plan.count):
        n_, i0, j0 = plan.origin(t)
        acc = 0
        for kb in range(-(-c // KC)):
            a = _box(src, n_, i0, j0, plan.th, plan.tw, KC * kb)
            acc = acc + a @ _wk_box(wkm, KC * kb, 0, o4).T
        acc = acc.reshape(plan.th, plan.tw, o4)
        r1, c1 = min(plan.th, ho - i0), min(plan.tw, wo - j0)
        out[n_, i0:i0 + r1, j0:j0 + c1] = acc[:r1, :c1]
    return ci._finish(out, mul, add, True)


@pytest.mark.parametrize("scatter,c,o4,pallas", [(False, 128, 256, True),
                                                 (True, 64, 128, True),
                                                 (False, 144, 128, False)],
                         ids=["upconv3", "upconv4", "C=144"])
@pytest.mark.parametrize("inline", [False, True])
def test_emulated_rows_s8_matches_plain_and_pallas(np_rng, scatter, c, o4,
                                                   pallas, inline):
    """upconv3's identity (C = 128), upconv4's scatter (C = 64) and a
    partial second K block: the emulation equals the plain version; at the
    two sites the Pallas int8 modes in interpret mode too (the padded-flat
    identity, or the 4-D one where it quantizes inline; the pf2
    scatter)."""
    from segmentation_tpu.nn.pallas import conv as jconv

    hi, wi = 5, 7
    shape = (2, hi, wi, 4 * c if scatter else c)
    x = _acts(np_rng, *shape) if inline else _codes(np_rng, *shape)
    wqm = _wq(np_rng, c, o4)
    cs = (np_rng.random(o4).astype(np.float32) + 0.5) * np.float32(
        OUT_S * 60.0 / (5376.0 * np.sqrt(c)))
    b = np_rng.normal(0, 10 * OUT_S, o4).astype(np.float32)
    act = ACT_S if inline else None
    mul, add = _affine(_t(cs), _t(b), OUT_S)
    got = _emulate_rows(x, wqm, mul, add, scatter, act)
    want = ci.rows_matmul_s8_plain(x, wqm, mul, add, scatter=scatter,
                                   act_scale=act)
    assert torch.equal(got, want)
    if not pallas:
        return
    quant = {"chan_scale": jnp.asarray(cs), "out_scale": OUT_S}
    if inline:
        quant["act_scale"] = ACT_S
    s = jcf.stride_for(wi, jnp.int8)
    if scatter:
        pal = jcf.deconv_packed_padflat(
            jcf.pad_rows(_jx(x), s), _jx(wqm), jnp.asarray(b), i_in=hi,
            j_in=wi, s_i=s, r_block=4, pf2_out=True, quant=quant,
            interpret=True)
        pal = jcf.unpad_pairs(pal, s, 2 * hi, 2 * wi)
    elif inline:
        pal = jconv.matmul_rows_flat(_jx(x), _jx(wqm), jnp.asarray(b),
                                     quant=quant, interpret=True)
    else:
        pal = jcf.matmul_rows_padflat(
            jcf.pad_rows(_jx(x), s), _jx(wqm), jnp.asarray(b), quant=quant,
            interpret=True)
        pal = jcf.unpad_rows(pal, s, hi, wi)
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(pal, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
