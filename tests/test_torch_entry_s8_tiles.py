"""H5's tile and H3's int8 loads on the CPU.

H5 (csrc/entry_chain.cu) computes the int8 level 1 in one persistent
kernel, two products a tile: a tile of th × tw conv1_2 outputs
(``tiles.entry_tile_plan``, laid out as th · (tw + 1) GEMM rows) gathers the
im2col rows of its (th + 1) × (tw + 1) halo of conv1_1 pixels (K = 48 of a
64-value bf16 row, zero past the grid), multiplies them by w4 (f32
accumulation), requantizes each row and writes its 128 codes back over the
same slot row in the 128-byte swizzle; conv1_2's four taps then read the slot
as row shifts (u · (tw + 1) + v) against the K-major copy wk of its weight,
one 128-byte K block a tap, and the int8 epilogue and slot-max pool finish
the tile. H3's int8 modes (csrc/strided_conv4x4s2.cu) read x into a
slot of one 128-byte row per space-to-depth pixel of the tile's halo, row
parity major (64 channels of (b, c) each), gathered by the producer warps
16 channels at a time (s8 codes, or bf16 quantized: the inline mode), and
the four taps read it as row shifts against the K-major
``strided_k_major(wq4)``.

Here torch emulations of those loads, slots and epilogues, whose products
are exact (float64 sums), must give the plain versions' outputs bit for bit,
and the codes of JAX's Pallas kernels in interpret mode within the int8
tolerance (one code, on at most 1e-3 of them: XLA rounds the f32 epilogue
and conv1_1's bf16 sums in its own order): ``entry_chain_pf2`` for H5;
``conv4x4s2_padflat`` and ``conv4x4s2_flat`` for H3 (int8 and inline modes;
both take 2C % 64 == 0 only, so C = 16 and 48 are held against the plain
version alone). Then: H5's plan covers every output once and reports the
recompute share its halos make; ``UNetS2DInt8.plan`` makes ``conv2_1/wk4``
in the kernel's order, once; and the gather's address rule is read from
the .cu and drives the emulation.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_tpu.nn.pallas import conv as jconv
from segmentation_tpu.nn.pallas import conv_flat as jcf
from segmentation_tpu_torch.models.unet_fast import pack_conv3_weight_s2_t
from segmentation_tpu_torch.models.unet_int8 import _affine
from segmentation_tpu_torch.nn.kernels import conv_flat as cf
from segmentation_tpu_torch.nn.kernels import conv_int8 as ci
from segmentation_tpu_torch.nn.kernels import tiles

KC = 128  # bytes of a K block: one 128-byte swizzled row
OUT_S = 0.05
ACT_S = 1 / 16.0  # inv = 16 exactly: (k + 1/2) / 16 is a tie
CSRC = Path(cf.__file__).resolve().parents[2] / "csrc"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


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


def _finish(acc, mul, add):
    """The int8 epilogue as the kernels run it: f32(acc) · mul + add, two
    f32 roundings, ReLU, round half to even, clip."""
    v = torch.relu(acc.float() * mul + add)
    return torch.clamp(torch.round(v), -127, 127)


def _assert_same(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _codes_close(got, want):
    """Codes against Pallas's: within one, on at most 1e-3 of them."""
    for g, w in zip(got, want, strict=True):
        g, w = g.numpy().astype(np.int32), np.asarray(w).astype(np.int32)
        assert g.shape == w.shape
        d = np.abs(g - w)
        assert d.max() <= 1
        assert (d > 0).mean() <= 1e-3


def _sw128(addr):
    """The 128-byte swizzle of a shared address (1024-byte aligned base)."""
    return addr ^ (((addr >> 7) & 7) << 4)


# ------------------------------------------------------------- H5's tile
def _halo_rows(x, n, i0, j0, eh, ew, ho, wo):
    """The gathered slot rows (im2col.cuh): row a · ew + b is window (i0 +
    a, j0 + b) of conv1_1's grid [ho, wo], its 48 values k = kh 12 + kw 3 +
    ch = x[n, 2i + kh, 2j + kw, ch], zero past the grid."""
    rows = torch.zeros(eh * ew, 48, dtype=torch.float64)
    for a in range(eh):
        for b in range(ew):
            i, j = i0 + a, j0 + b
            if i < ho and j < wo:
                win = x[n, 2 * i:2 * i + 4, 2 * j:2 * j + 4, :]
                rows[a * ew + b] = win.double().reshape(48)
    return rows


def _slot_write(slot, rows, codes):
    """conv1_1's codes written back over their rows, as the consumer
    stores them: column col of row r at r·128 + ((col / 16) ^ (r & 7))·16 +
    col % 16 (FwdOut's s8 staging rule)."""
    col = np.arange(128)
    for r in range(rows):
        addr = r * 128 + (((col // 16) ^ (r & 7)) << 4) + col % 16
        slot[addr] = codes[r].numpy().astype(np.int64)


def _slot_view(slot, start, rows):
    """A K-major view of the slot from row ``start`` as wgmma's 128-byte
    swizzle descriptor reads it: element (m, k) at the canonical address
    (start + m)·128 + k (8-row groups 1024 bytes apart), swizzled."""
    m = np.arange(rows)[:, None]
    k = np.arange(128)[None, :]
    return torch.from_numpy(slot[_sw128((start + m) * 128 + k)].astype(
        np.float64))


def _entry_emulate(x, w4, mul1, add1, wq2, mul2, add2):
    """H5 tile by tile, each halo recomputed: (y, pooled) as it stores
    them."""
    n_img, h, w, _ = x.shape
    h1, w1 = (h - 2) // 2, (w - 2) // 2
    ho, wo = h1 - 1, w1 - 1
    plan = tiles.entry_tile_plan(n_img, ho, wo)
    th, tw, ew = plan.th, plan.tw, plan.tw + 1
    bm = tiles.ENTRY_TILE_ROWS
    wk = ci.k_major(wq2).double()  # [128, 4 · 128]
    w4m = w4.double().reshape(48, 128)
    y = torch.full((n_img, ho, wo, 128), float("nan"))
    for t in range(plan.count):
        n, i0, j0 = plan.origin(t)
        halo = (th + 1) * ew
        acc1 = _halo_rows(x, n, i0, j0, th + 1, ew, h1, w1) @ w4m
        slot = np.zeros(tiles.ENTRY_SLOT_ROWS * 128, np.int64)
        _slot_write(slot, halo, _finish(acc1, mul1, add1).to(torch.int8))
        acc = torch.zeros(bm, 128, dtype=torch.float64)
        for tap in range(4):
            shift = (tap >> 1) * ew + (tap & 1)
            b = wk[:, 128 * tap:128 * tap + 128].t()
            acc += _slot_view(slot, shift, bm) @ b
        v = _finish(acc, mul2, add2)[:th * ew].view(th, ew, 128)[:, :tw]
        hi, wi = min(th, ho - i0), min(tw, wo - j0)
        y[n, i0:i0 + hi, j0:j0 + wi] = v[:hi, :wi]
    assert not y.isnan().any()  # every output was stored
    y = y.to(torch.int8)
    return y, y.reshape(n_img, ho, wo, 4, 32).amax(3)


def test_emulated_entry_tile_matches_pallas_and_plain(np_rng):
    """17 × 254 outputs: 6 × 20 tiles, ragged in both directions."""
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
    got_y, got_p = jcf.entry_chain_pf2(
        jcf.entry_transform_pf2(_jx(xb)), we, wh, wl,
        jnp.tile(jnp.asarray(b1), 4), jnp.asarray(w2), jnp.asarray(b2),
        h_img=h_img, out_scale1=out_s1,
        quant2={"chan_scale": jnp.asarray(cs2), "out_scale": OUT_S},
        r_block=4, interpret=True,
    )
    h2, w2o, g = (h_img - 2) // 2 - 1, (w_img - 2) // 2 - 1, w_img // 4
    want = [jcf.unpad_pairs(v, g, h2, w2o) for v in (got_y, got_p)]

    w4 = pack_conv3_weight_s2_t(_t(w3)).to(torch.bfloat16)
    mul1, add1 = _affine(torch.ones(o4), _t(np.tile(b1, 4)), out_s1)
    mul2, add2 = _affine(_t(cs2), _t(b2), OUT_S)
    plan = tiles.entry_tile_plan(1, h2, w2o)
    assert (plan.th, plan.tw) == (6, 20)
    assert h2 % plan.th and w2o % plan.tw  # ragged both ways
    got = _entry_emulate(xb, w4, mul1, add1, w2, mul2, add2)
    _assert_same(got, ci.entry_chain_plain(xb, w4, mul1, add1, w2, mul2,
                                           add2))
    _codes_close(got, want)


@pytest.mark.parametrize("n,h,w", [(2, 38, 70), (1, 8, 14), (3, 21, 40)])
def test_emulated_entry_tile_matches_plain(np_rng, n, h, w):
    """Several tiles, one tile, N = 3 at an odd grid."""
    x = torch.from_numpy(np_rng.random((n, h, w, 3)).astype(
        np.float32)).bfloat16()
    w4 = (torch.from_numpy(np_rng.normal(size=(4, 4, 3, 128)).astype(
        np.float32)) / 48**0.5).bfloat16()
    mul1 = torch.full((128,), 50.0)
    add1 = torch.from_numpy(np_rng.normal(size=128).astype(np.float32)) * 5
    wq2 = _wq(np_rng, 2, 2, 128, 128)
    mul2, add2 = _affine(*(_t(v) for v in _scales(np_rng, 512, 128)), OUT_S)
    _assert_same(_entry_emulate(x, w4, mul1, add1, wq2, mul2, add2),
                 ci.entry_chain_plain(x, w4, mul1, add1, wq2, mul2, add2))


@pytest.mark.parametrize("shape", [(8, 254, 254), (1, 9, 254), (2, 190, 254),
                                   (3, 17, 33), (1, 2, 5), (1, 1, 1),
                                   (1, 257, 3), (1, 36, 33)])
def test_entry_tile_plan_covers_once_and_counts_its_recompute(shape):
    """Every output once; the tile's GEMM rows, halo and largest tap shift
    within the slot; the recompute share the plan reports is its halos'
    conv1_1 rows over the conv1_1 pixels, counted tile by tile."""
    n, ho, wo = shape
    plan = tiles.entry_tile_plan(*shape)
    th, tw = plan.th, plan.tw
    assert th * (tw + 1) <= tiles.ENTRY_TILE_ROWS
    assert (th + 1) * (tw + 1) <= tiles.ENTRY_SLOT_ROWS
    assert tiles.ENTRY_TILE_ROWS - 1 + tw + 2 < tiles.ENTRY_SLOT_ROWS
    hits = np.zeros(shape, np.int64)
    computed = 0
    for t in range(plan.count):
        b, i0, j0 = plan.origin(t)
        hits[b, i0:i0 + th, j0:j0 + tw] += 1
        computed += (th + 1) * (tw + 1)
    assert (hits == 1).all()
    share = computed / (n * (ho + 1) * (wo + 1)) - 1
    assert tiles.entry_recompute(plan) == pytest.approx(share, abs=1e-12)
    if ho % th == 0 and wo % tw == 0:  # the halo arithmetic
        want = (th + 1) * (tw + 1) * ho * wo / (th * tw * (ho + 1) * (wo + 1))
        assert tiles.entry_recompute(plan) == pytest.approx(want - 1)


def test_entry_tile_plan_at_512():
    """The 512² level: 8 × 15 tiles, 144 conv1_1 rows for 120 outputs,
    three m64 chunks; 20.5 % of conv1_1 computed twice."""
    plan = tiles.entry_tile_plan(8, 254, 254)
    assert (plan.th, plan.tw, plan.count) == (8, 15, 8 * 32 * 17)
    assert tiles.entry_halo_chunks(plan.th, plan.tw) == 3
    assert tiles.entry_recompute(plan) == pytest.approx(
        8 * 32 * 17 * 144 / (8 * 255 * 255) - 1)


def test_requant_pair_rounds_as_finish():
    """conv1_1's codes in H5 (entry_chain.cu requant_pair): min(relu(acc ·
    mul + add), 127) + 1.5 · 2^23 in f32 leaves round-half-to-even of the
    clipped value in the low byte, the codes of finish's rint-then-clip
    (the requant entry's), ties and values past 127 included."""
    src = (CSRC / "entry_chain.cu").read_text()
    body = re.search(r"uint32_t requant_pair\((.*?)\n\}", src, re.S).group(1)
    assert "fminf(affine_relu(a0, m.x, b.x), 127.0f)" in body
    assert "__fadd_rn(t0, 12582912.0f)" in body and "0x0040" in body
    assert np.float32(12582912.0) == np.float32(1.5 * 2**23)
    v = np.concatenate([np.arange(-40, 300) / np.float32(2),
                        np.random.default_rng(0).normal(60, 60, 4096)])
    v = v.astype(np.float32)
    t = np.minimum(np.maximum(v, np.float32(0)), np.float32(127))
    low = ((t + np.float32(12582912.0)).view(np.uint32) & 0xFF)
    want = _finish(torch.from_numpy(v).double(), torch.ones(1),
                   torch.zeros(1))
    np.testing.assert_array_equal(low.astype(np.int64),
                                  want.numpy().astype(np.int64))


def test_entry_slot_constants_match_the_kernel():
    """The slot's rows and the tile rule in csrc/entry_chain.cu are the
    plan's."""
    src = (CSRC / "entry_chain.cu").read_text()
    assert re.search(r"static constexpr int A_ROWS = (\d+);",
                     src).group(1) == str(tiles.ENTRY_SLOT_ROWS)
    assert "(th + 1) * (tw + 1) > rows || tw + 2 + 128 > rows" in src
    assert "for (int ks = 0; ks < 3; ++ks)  // K = 48" in src
    assert "FwdOut<128, kEntryEpi, 1>" in src


# ---------------------------------------------------------- H3 int8 loads
def _gather_rule():
    """The source offset (in elements) of a gathered chunk, as
    StridedS8Tiles::gather_a in csrc/strided_conv4x4s2.cu writes it: the
    image and parity base, then the pixel's."""
    src = (CSRC / "strided_conv4x4s2.cu").read_text()
    body = src[src.index("struct StridedS8Tiles"):]
    base = re.search(r"xs \+ \((.*?)\) \* es;", body, re.S).group(1)
    pix = re.search(r"xn \+ \((.*?)\) \* c \* es\);", body, re.S).group(1)
    chunk = re.search(r"const int par = (.*?), bc = (.*?);", body)

    def clean(e):
        return re.sub(r"\s+", " ", re.sub(r"\(long long\)|LL", "", e))

    return (clean(base), clean(pix), clean(chunk.group(1)),
            clean(chunk.group(2)))


def _s8_rows(x, n, i0, j0, th, tw, kb, act_scale=None):
    """H3 int8's gathered A slot of K block kb for tile (n, i0, j0), built
    by the kernel's address rule (read from the .cu): chunk q of halo row
    (bi, bj) is the 16 values of x from element ``base + pix``, zero past 2C
    and outside the space-to-depth grid, quantized where x is bf16; then
    tw + 1 zero rows (a tap's view runs past the halo)."""
    nn, h, w, c = x.shape
    base_e, pix_e, par_e, bc_e = _gather_rule()
    flat = x.reshape(-1)
    inv = torch.tensor(ci.act_inverse(act_scale or 1.0), dtype=torch.float32)
    wrow = tw + 1
    rows = torch.zeros((th + 2) * wrow, KC, dtype=torch.float64)
    for row in range((th + 1) * wrow):
        bi, bj = divmod(row, wrow)
        i, j = i0 + bi, j0 + bj
        if i >= h // 2 or j >= w // 2:
            continue
        for chunk in range(8):
            env = {"n": n, "h": h, "w": w, "c": c, "kb": kb, "chunk": chunk,
                   "i": i, "j": j}
            env["par"] = eval(par_e, {}, env)
            env["bc"] = eval(bc_e, {}, env)
            if env["bc"] >= 2 * c:
                continue
            off = eval(base_e, {}, env) + eval(pix_e, {}, env) * c
            v = flat[off:off + 16]
            if act_scale is not None:
                v = torch.clamp(torch.round(v.float() * inv), -127, 127)
            rows[row, 16 * chunk:16 * chunk + 16] = v.double()
    return rows


def _strided_s8_emulate(x, wq4, mul, add, act_scale=None):
    """H3 int8 tile by tile: the K blocks of each tap as row shifts of the
    slot, B the (tap · kps + kb)-th 128 K bytes of wk4 (load_b)."""
    n_img, h, w, c = x.shape
    o4 = wq4.shape[-1]
    ho, wo = (h - 2) // 2, (w - 2) // 2
    plan = ci.strided_s8_plan(x)
    th, tw, wrow = plan.th, plan.tw, plan.tw + 1
    kps = -(-2 * c // 64)
    wk4 = ci.strided_k_major(wq4).double()
    assert wk4.shape == (o4, 4 * kps * KC) == (o4, ci.strided_k_width(c))
    src = (CSRC / "strided_conv4x4s2.cu").read_text()
    assert "tma_load_2d(b, &wmap, bar, 128 * (tap * kps + kb), 0);" in src
    y = torch.full((n_img, ho, wo, o4), float("nan"))
    rows = th * wrow
    for t in range(plan.count):
        n, i0, j0 = plan.origin(t)
        acc = torch.zeros(rows, o4, dtype=torch.float64)
        for kb in range(kps):
            a = _s8_rows(x, n, i0, j0, th, tw, kb, act_scale)
            for tap in range(4):
                shift = (tap >> 1) * wrow + (tap & 1)
                k0 = KC * (tap * kps + kb)
                acc += a[shift:shift + rows] @ wk4[:, k0:k0 + KC].t()
        v = _finish(acc, mul, add).view(th, wrow, o4)[:, :tw]
        hi, wi = min(th, ho - i0), min(tw, wo - j0)
        y[n, i0:i0 + hi, j0:j0 + wi] = v[:hi, :wi]
    assert not y.isnan().any()
    return y.to(torch.int8)


# (N, H, W): several tiles with ragged ones, odd H and W (the VALID conv
# never reads the last row and column)
STRIDED = [(2, 20, 38), (1, 23, 29)]


@pytest.mark.parametrize("inline", [False, True])
@pytest.mark.parametrize("c", [16, 32, 48])
@pytest.mark.parametrize("shape", STRIDED)
def test_emulated_strided_s8_matches_plain(np_rng, shape, c, inline):
    """C = 16 (each parity's 64 box bytes half zeros), 32 (conv2_1), 48 (a
    second K block, half zeros), resident codes and inline."""
    o4 = 128 if c == 48 else 256
    x = (_acts if inline else _codes)(np_rng, *shape, c)
    wq4 = _wq(np_rng, 4, 4, c, o4)
    mul, add = _affine(*(_t(v) for v in _scales(np_rng, 16 * c, o4)), OUT_S)
    act = ACT_S if inline else None
    got = _strided_s8_emulate(x, wq4, mul, add, act)
    _assert_same([got], [ci.strided_conv4x4s2_s8_plain(
        x, wq4, mul, add, act_scale=act, wk4=ci.strided_k_major(wq4))])


@pytest.mark.parametrize("inline", [False, True])
@pytest.mark.parametrize("route", ["padflat", "flat"])
def test_emulated_strided_s8_matches_pallas(np_rng, route, inline):
    """conv2_1's site (C = 32, 4O = 256): the padded-flat paired input
    (conv4x4s2_padflat) and the 4-D route's (conv4x4s2_flat), s8 codes or
    bf16 quantized inline."""
    h, w_in, c, o4 = 14, 18, 32, 256
    x = (_acts if inline else _codes)(np_rng, 2, h, w_in, c)
    wq4 = _wq(np_rng, 4, 4, c, o4)
    cs, b = _scales(np_rng, 16 * c, o4)
    quant = {"chan_scale": jnp.asarray(cs), "out_scale": OUT_S}
    if inline:
        quant["act_scale"] = ACT_S
    if route == "padflat":
        xp = _jx(x).reshape(2, h, w_in // 2, 2 * c)  # column pairs
        s2 = jcf.stride_for(w_in // 2, xp.dtype)
        want = jcf.conv4x4s2_padflat(
            jcf.pad_rows(xp, s2), jnp.asarray(wq4.numpy()), jnp.asarray(b),
            h=h, w2_real=w_in // 2, s2=s2, r_block=3, quant=quant,
            interpret=True)
        want = jcf.unpad_rows(want, s2, (h - 2) // 2, (w_in - 2) // 2)
    else:
        want = jconv.conv4x4s2_flat(_jx(x), jnp.asarray(wq4.numpy()),
                                    jnp.asarray(b), r_block=3, quant=quant,
                                    interpret=True)
    mul, add = _affine(_t(cs), _t(b), OUT_S)
    got = _strided_s8_emulate(x, wq4, mul, add, ACT_S if inline else None)
    _codes_close([got], [want])


@pytest.mark.parametrize("c", [16, 32, 48, 64])
def test_strided_s8_gather_reads_the_pixel_pairs(c):
    """The gather's address rule, read from the .cu: chunk q of space-to-
    depth pixel (i, j) starts at x[n, 2i + a, 2j + b, c'] with a = q / 4
    and bc = b C + c' = 64 kb + 16 (q % 4), its 16 values one run of the
    pixel pair (2C % 16 == 0), 16-byte aligned for s8 and bf16."""
    n, h, w = 3, 23, 30
    base_e, pix_e, par_e, bc_e = _gather_rule()
    x = torch.arange(n * h * w * c).reshape(n, h, w, c)
    flat = x.reshape(-1)
    for bn, i, j, kb, chunk in [(2, 5, 7, 0, 7), (0, 0, 0, 0, 0),
                                (1, 10, 14, 1, 5), (2, 10, 13, 0, 2)]:
        env = {"n": bn, "h": h, "w": w, "c": c, "kb": kb, "chunk": chunk,
               "i": i, "j": j}
        env["par"] = a = eval(par_e, {}, env)
        env["bc"] = bc = eval(bc_e, {}, env)
        assert (a, bc) == (chunk // 4, 64 * kb + 16 * (chunk % 4))
        if bc >= 2 * c:
            continue
        off = eval(base_e, {}, env) + eval(pix_e, {}, env) * c
        assert off % 16 == 0
        b_, cc = divmod(bc, c)
        assert flat[off] == x[bn, 2 * i + a, 2 * j + b_, cc]
        run = x[bn, 2 * i + a, 2 * j:2 * j + 2].reshape(-1)[bc:bc + 16]
        assert torch.equal(flat[off:off + 16], run)


def test_strided_k_major_order(np_rng):
    """wk4[o, (tap · kps + kb) · 128 + 64 a + r] = wq4[2u + a, 2v + b, c,
    o] for bc = 64 kb + r = b C + c < 2C, else 0; at C = 32 that is
    wk4[o, tap · 4C + a · 2C + b · C + c]. The C = 3 entry: the im2col
    order, wq4.reshape(16C, 4O).T."""
    for c in (16, 32, 48):
        wq4 = _wq(np_rng, 4, 4, c, 128)
        wk4 = ci.strided_k_major(wq4)
        kps = -(-2 * c // 64)
        assert wk4.is_contiguous() and wk4.shape == (128, 4 * kps * 128)
        want = torch.zeros_like(wk4)
        for tap in range(4):
            u, v = divmod(tap, 2)
            for kb in range(kps):
                for a in range(2):
                    for r in range(64):
                        bc = 64 * kb + r
                        if bc < 2 * c:
                            b, cc = divmod(bc, c)
                            want[:, (tap * kps + kb) * 128 + 64 * a + r] = \
                                wq4[2 * u + a, 2 * v + b, cc]
        assert torch.equal(wk4, want), c
        if c == 32:
            assert wk4[7, 3 * 128 + 64 + 32 + 5] == wq4[3, 3, 5, 7]
    wq4 = _wq(np_rng, 4, 4, 3, 256)
    assert torch.equal(ci.strided_k_major(wq4), wq4.reshape(48, 256).T)


def test_plan_makes_conv2_1_wk4_once(np_rng, monkeypatch):
    """``UNetS2DInt8.plan`` adds conv2_1's K-major copy in the kernel's
    order; a request makes none (the forward never calls
    strided_k_major) and leaves the planned dict as it was."""
    from segmentation_tpu_torch.core.config import ModelConfig
    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.models import unet_int8
    from segmentation_tpu_torch.models.unet import init_params

    cfg = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=32)
    model = unet_int8.UNetS2DInt8(cfg)
    x = torch.rand(1, 188, 188, 3, generator=generator(3))
    p = model.prepare(init_params(cfg, generator(0)), calib_batches=[x])
    wk4 = p["conv2_1/wk4"]
    assert wk4.dtype == torch.int8 and wk4.is_contiguous()
    assert wk4.shape == (256, 512)
    assert torch.equal(wk4, ci.strided_k_major(p["conv2_1/wq4"]))
    assert "conv1_1/wk4" not in p  # conv1_1 stays bf16 (C = 3)

    def made(*_):
        raise AssertionError("a K-major copy made per request")

    monkeypatch.setattr(unet_int8, "strided_k_major", made)
    monkeypatch.setattr(unet_int8, "k_major", made)
    keys = {k: v.data_ptr() for k, v in p.items()
            if isinstance(v, torch.Tensor)}
    model.apply_argmax(p, x.to(torch.bfloat16))
    assert {k: v.data_ptr() for k, v in p.items()
            if isinstance(v, torch.Tensor)} == keys
