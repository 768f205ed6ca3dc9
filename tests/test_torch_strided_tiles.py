"""H3's and H4's tile plans, boxes, gather, B rows and box rule on the CPU.

The bf16 card kernels (csrc/strided_conv4x4s2.cu and csrc/rows_matmul.cu,
on csrc/sm90_igemm.cuh with the output side of csrc/packed_conv2x2_fwd.cuh)
walk th × tw tiles of the output grid (``tiles.tile_plan``) and load, per
64-channel K block:

- H3 boxed (``tiles.strided_boxable``): x [N, H, W, C] seen without a copy
  as the 5-D [N, H/2, 2 (a), W/2, 2C]; K block (a, k0) is the box [th + 1,
  tw + 1, 64] at (n, i0, a, j0, k0), each tap (u, v) its rows shifted by
  u (tw + 1) + v, against the rows ((2u + a) 4 + 2v) C + k0 of w4 viewed
  as [16C, 4O];
- H3 gathered: one tap, the im2col rows of the tile's pixels (k = kh 4C +
  kw C + ch), against the rows 64 kb of the same view of w4;
- H4 identity: the box [th, tw, 64] of x; scatter: x viewed as [N I, J, 2,
  2, C], one box [tw / 2, 2, 64] per output row 2i + a of the tile, in
  (j, b) order; both against the rows 64 kb of wm.

TMA fills zeros outside each tensor. A torch emulation of those loads
(``_run_tiles``) must equal JAX's Pallas kernels (``conv4x4s2_padflat``,
``conv4x4s2_flat``, ``conv3entry_pf2``, ``matmul_rows_padflat``,
``deconv_packed_padflat`` with both ``pf2_out``; interpret mode) in f32 at
rtol = atol = 1e-4, as tests/test_torch_fwd_tiles.py holds H1's; shapes
the Pallas kernels do not take (partial K blocks, odd W, C = 5) are held
against the port's plain versions. The plans must cover every output
pixel of the four sites and of the card tests' shapes exactly once, and
``strided_boxable`` must be the rule the kernel applies.
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
from segmentation_tpu_torch.nn.kernels import conv_flat as cf
from segmentation_tpu_torch.nn.kernels.tiles import strided_boxable, tile_plan

TOL = 1e-4
ROWS = cf.FWD_TILE_ROWS
# the output grid [N, ho, wo] of the four sites at 512², B = 8, with the
# plan's halo and column step: conv1_1 (C = 3, gathered), conv2_1 (C = 32,
# boxed), upconv3 (identity), upconv4 (scatter: tw a multiple of 8)
SITES = {"conv1_1": ((8, 255, 255), 0, 1),
         "conv2_1": ((8, 126, 126), 1, 1),
         "upconv3": ((8, 84, 84), 0, 1),
         "upconv4": ((8, 164, 164), 0, 8)}
# the output grids of tests/test_torch_cuda.py's H3 cases (boxed and
# gathered) and H4 cases (identity, and the scatter's doubled grids)
H3_GRIDS = [(2, 10, 9), (2, 10, 8), (1, 1, 1), (1, 43, 64), (2, 29, 34)]
H4_GRIDS = [(2, 7, 9), (1, 43, 37), (1, 1, 1), (3, 10, 21), (2, 23, 29)]
RAGGED = ([(g, 1, 1) for g in H3_GRIDS] + [(g, 0, 1) for g in H3_GRIDS]
          + [(g, 0, 1) for g in H4_GRIDS]
          + [((n, 2 * h, 2 * w), 0, 8) for n, h, w in H4_GRIDS])


def _coverage(plan):
    hits = np.zeros((plan.n, plan.hx, plan.wx), np.int64)
    for t in range(plan.count):
        n, i0, j0 = plan.origin(t)
        assert 0 <= i0 < plan.hx and 0 <= j0 < plan.wx, (t, i0, j0)
        hits[n, i0:i0 + plan.th, j0:j0 + plan.tw] += 1
    return hits


def _check_plan(plan, halo, step):
    assert plan.th * (plan.tw + halo) <= ROWS, plan
    assert max(plan.th, plan.tw) + halo <= 256, plan
    assert plan.tw % step == 0, plan
    assert (_coverage(plan) == 1).all()


@pytest.mark.parametrize("site", list(SITES))
def test_tile_plan_covers_the_sites_once(site):
    grid, halo, step = SITES[site]
    plan = tile_plan(*grid, ROWS, halo, step)
    _check_plan(plan, halo, step)
    # padded rows: at most 10 % of the wgmma rows store no output pixel
    assert plan.count * ROWS <= 1.10 * np.prod(grid), plan


@pytest.mark.parametrize("grid,halo,step", RAGGED)
def test_tile_plan_covers_ragged_shapes_once(grid, halo, step):
    _check_plan(tile_plan(*grid, ROWS, halo, step), halo, step)


@pytest.mark.parametrize("grid", [g for g, _, step in RAGGED if step == 8]
                         + [SITES["upconv4"][0]])
def test_scatter_row_boxes_start_on_1024_bytes(grid):
    """The scatter's tiles load one box per output row at A-slot row r ·
    tw; with th > 1 each must start on a 1024-byte boundary (8 rows of 128
    bytes), where TMA's 128-byte swizzle starts its pattern; tw is even."""
    plan = tile_plan(*grid, ROWS, 0, 8)
    assert plan.tw % 2 == 0
    if plan.th > 1:
        assert all(r * plan.tw * 128 % 1024 == 0 for r in range(plan.th))


def test_tile_plan_keeps_the_four_tap_plans():
    """halo = 1, step = 1 is H1's, H2's and H6's plan as it was: the fewest
    tiles of th (tw + 1) rows, split evenly."""
    plan = tile_plan(8, 254, 254, ROWS)
    assert (plan.th, plan.tw, plan.count) == (1, 127, 4064)
    plan = tile_plan(8, 83, 83, ROWS)
    assert (plan.th, plan.tw, plan.count) == (7, 17, 480)


# ------------------------------------------------------------ the emulation
def _box(src, lo, size):
    """The box of ``size`` at coordinates ``lo`` of src (any rank), zero
    outside src (TMA's fill)."""
    out = torch.zeros(size)
    s = [slice(max(a, 0), min(a + n, d)) for a, n, d in
         zip(lo, size, src.shape)]
    if all(sl.start < sl.stop for sl in s):
        out[tuple(slice(sl.start - a, sl.stop - a) for sl, a in
                  zip(s, lo))] = src[tuple(s)]
    return out


def _b_rows(wflat, row):
    """64 rows of a weight viewed as [K, 4O] from ``row``, zero past K."""
    k, o4 = wflat.shape
    out = torch.zeros(64, o4)
    if row < k:
        out[:min(row + 64, k) - row] = wflat[row:row + 64]
    return out


def _run_tiles(plan, o4, bias, *, halo, taps, k_blocks, a_of, b_of):
    """The kernels' arithmetic on their own loads, in f32, one tile at a
    time: a_of(n, i0, j0, kb) gives an A slot's rows, b_of(kb, tap) the B
    rows; tap (u, v) reads the slot from row u (tw + halo) + v. Returns y
    as the kernel stores it (f32 here)."""
    th, wrow = plan.th, plan.tw + halo
    rows = th * wrow
    y = torch.full((plan.n, plan.hx, plan.wx, o4), float("nan"))
    for t in range(plan.count):
        n, i0, j0 = plan.origin(t)
        acc = torch.zeros(rows, o4)
        for kb in range(k_blocks):
            # a tap's view runs past the box: zero rows (junk rows only)
            a = torch.cat([a_of(n, i0, j0, kb), torch.zeros(wrow + 1, 64)])
            for tap in range(taps):
                shift = (tap >> 1) * wrow + (tap & 1)
                acc += a[shift:shift + rows] @ b_of(kb, tap)
        acc = torch.relu(acc + bias).view(th, wrow, o4)[:, :plan.tw]
        hi, wi = min(th, plan.hx - i0), min(plan.tw, plan.wx - j0)
        y[n, i0:i0 + hi, j0:j0 + wi] = acc[:hi, :wi]
    assert not y.isnan().any()  # every pixel was stored
    return y


def _s2d_view(x):
    """x [N, H, W, C] as H3's 5-D map reads it, by its strides (no copy):
    [N, H // 2, 2 (a), W // 2, 2C]."""
    n, h, w, c = x.shape
    return x.as_strided((n, h // 2, 2, w // 2, 2 * c),
                        (h * w * c, 2 * w * c, w * c, 2 * c, 1))


def emulate_strided_boxed(x, w4, b, plan):
    """H3 boxed (StridedTiles<O4, true>): K block kb = (a, k0 / 64)."""
    c, o4 = x.shape[-1], w4.shape[-1]
    v, kps = _s2d_view(x), -(-2 * c // 64)
    wflat = w4.reshape(16 * c, o4)
    th, tw = plan.th, plan.tw

    def a_of(n, i0, j0, kb):
        a, k = divmod(kb, kps)
        return _box(v, (n, i0, a, j0, 64 * k),
                    (1, th + 1, 1, tw + 1, 64)).reshape(-1, 64)

    def b_of(kb, tap):
        a, k = divmod(kb, kps)
        u, vv = tap >> 1, tap & 1
        return _b_rows(wflat, ((2 * u + a) * 4 + 2 * vv) * c + 64 * k)

    return _run_tiles(plan, o4, b, halo=1, taps=4, k_blocks=2 * kps,
                      a_of=a_of, b_of=b_of)


def emulate_strided_gathered(x, w4, b, plan):
    """H3 gathered (StridedTiles<O4, false>::im2col): one tap; row m =
    pixel (i0 + m // tw, j0 + m % tw), k read at x's flat element
    ((n H + 2i) W + 2j) C + kh W C + (k - kh 4C), kh = k // 4C; zero past
    16C and for pixels past the output."""
    n_, h, w, c = x.shape
    o4 = w4.shape[-1]
    xf, wflat = x.reshape(-1), w4.reshape(16 * c, o4)
    th, tw = plan.th, plan.tw

    def a_of(n, i0, j0, kb):
        m = torch.arange(th * tw)
        i, j = i0 + m // tw, j0 + m % tw
        k = 64 * kb + torch.arange(64)
        kh = k // (4 * c)
        idx = (((n * h + 2 * i) * w + 2 * j) * c)[:, None] + \
            (kh * w * c + k - kh * 4 * c)[None, :]
        live = ((i < plan.hx) & (j < plan.wx))[:, None] & (k < 16 * c)
        return torch.where(live, xf[idx.clamp(0, xf.numel() - 1)], 0.0)

    return _run_tiles(plan, o4, b, halo=0, taps=1,
                      k_blocks=-(-16 * c // 64), a_of=a_of,
                      b_of=lambda kb, tap: _b_rows(wflat, 64 * kb))


def emulate_rows(x, wm, b, plan, scatter):
    """H4 (RowsTiles): identity, the box [th, tw, 64] of x; scatter, x
    viewed as [N I, J, 2 (a), 2 (b), C] and per output row R = i0 + r the
    box [tw / 2, 2, 64] at (n I + R // 2, j0 / 2, R % 2, 0, k0)."""
    c, o4 = wm.shape
    th, tw = plan.th, plan.tw
    if scatter:
        n_, hi, wi, _ = x.shape
        v = x.reshape(n_ * hi, wi, 2, 2, c)

    def a_of(n, i0, j0, kb):
        if not scatter:
            return _box(x, (n, i0, j0, 64 * kb), (1, th, tw, 64)).reshape(
                -1, 64)
        return torch.cat([
            _box(v, (n * hi + (i0 + r) // 2, j0 // 2, (i0 + r) % 2, 0,
                     64 * kb), (1, tw // 2, 1, 2, 64)).reshape(-1, 64)
            for r in range(th)])

    return _run_tiles(plan, o4, b, halo=0, taps=1, k_blocks=-(-c // 64),
                      a_of=a_of, b_of=lambda kb, tap: _b_rows(wm, 64 * kb))


def _strided_plan(x):
    n, h, w, _ = x.shape
    return tile_plan(n, (h - 2) // 2, (w - 2) // 2, ROWS,
                     int(strided_boxable(x)))


def _rows_plan(x, scatter):
    n, h, w, _ = x.shape
    if scatter:
        return tile_plan(n, 2 * h, 2 * w, ROWS, 0, 8)
    return tile_plan(n, h, w, ROWS, 0)


def _operands(rng, k_shape, o4, scale=0.05):
    w = (rng.standard_normal((*k_shape, o4)) * scale).astype(np.float32)
    b = rng.standard_normal((o4,)).astype(np.float32)
    return w, b


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


# ------------------------------------------------------------------ H3
# x [N, H, W, C] the Pallas kernels take (W even, 2C % 64 == 0): odd H,
# several tiles per image, ragged ones; C = 64 has two K blocks a parity
STRIDED_PALLAS = [(2, 30, 44, 32, 128), (1, 25, 40, 64, 256),
                  (2, 21, 30, 32, 256)]


@pytest.mark.parametrize("n,h,w,c,o4", STRIDED_PALLAS)
def test_emulated_boxes_match_pallas_conv4x4s2_padflat(np_rng, n, h, w, c,
                                                       o4):
    x = np_rng.standard_normal((n, h, w, c)).astype(np.float32)
    w4, b = _operands(np_rng, (4, 4, c), o4)
    xp = jnp.asarray(x).reshape(n, h, w // 2, 2 * c)  # column pairs
    s2 = jcf.stride_for(w // 2, jnp.float32)
    want = jcf.conv4x4s2_padflat(jcf.pad_rows(xp, s2), w4, b, h=h,
                                 w2_real=w // 2, s2=s2, r_block=3,
                                 interpret=True)
    want = jcf.unpad_rows(want, s2, (h - 2) // 2, (w - 2) // 2)
    xt = _t(x)
    assert strided_boxable(xt)
    plan = _strided_plan(xt)
    assert plan.count > n  # several tiles per image
    _close(emulate_strided_boxed(xt, _t(w4), _t(b), plan), want)


@pytest.mark.parametrize("n,h,w,c,o4", STRIDED_PALLAS[:2])
def test_emulated_boxes_match_pallas_conv4x4s2_flat(np_rng, n, h, w, c, o4):
    x = np_rng.standard_normal((n, h, w, c)).astype(np.float32)
    w4, b = _operands(np_rng, (4, 4, c), o4)
    want = jconv.conv4x4s2_flat(jnp.asarray(x), jnp.asarray(w4),
                                jnp.asarray(b), r_block=3, interpret=True)
    xt = _t(x)
    _close(emulate_strided_boxed(xt, _t(w4), _t(b), _strided_plan(xt)),
           want)


# shapes the Pallas kernels do not take: C = 16 (a partial K block, 2C =
# 32 of 64: its B rows past 2C are the next kw pair's, or zeros past 16C),
# C = 4, odd W (the view's last packed column is never read), odd H and W
@pytest.mark.parametrize("n,h,w,c,o4", [(2, 22, 20, 16, 128),
                                        (1, 23, 19, 16, 256),
                                        (2, 22, 20, 4, 128),
                                        (1, 24, 27, 32, 256),
                                        (1, 4, 4, 32, 128)])
def test_emulated_boxes_match_plain(np_rng, n, h, w, c, o4):
    xt = _t(np_rng.standard_normal((n, h, w, c)))
    w4, b = (_t(v) for v in _operands(np_rng, (4, 4, c), o4))
    assert strided_boxable(xt)
    got = emulate_strided_boxed(xt, w4, b, _strided_plan(xt))
    _close(got, cf.strided_conv4x4s2_plain(xt, w4, b))


def test_emulated_im2col_matches_pallas_entry(np_rng):
    """C = 3: the fused pf2 entry (3×3 conv + s2d fold, its bf16 mode: no
    quant) with the same 3×3 weights, folded by pack_conv3_weight_s2_t; the
    kernel gathers the 48 values of each window as one K block."""
    h_img, w_img, o = 10, 512, 32  # the entry kernel needs W % 128 == 0
    x = np_rng.standard_normal((1, h_img, w_img, 3)).astype(np.float32)
    w3 = (np_rng.standard_normal((3, 3, 3, o)) * 0.2).astype(np.float32)
    b = np_rng.standard_normal((o,)).astype(np.float32)
    we, wh, wl = map(jnp.asarray, jcf.entry_weights_pf2(w3))
    want = jcf.conv3entry_pf2(jcf.entry_transform_pf2(jnp.asarray(x)), we,
                              wh, wl, jnp.tile(jnp.asarray(b), 4),
                              h_img=h_img, r_block=3, interpret=True)
    want = jcf.unpad_pairs(want, w_img // 4, (h_img - 2) // 2,
                           (w_img - 2) // 2)
    xt = _t(x)
    assert not strided_boxable(xt)
    got = emulate_strided_gathered(xt, pack_conv3_weight_s2_t(_t(w3)),
                                   _t(np.tile(b, 4)), _strided_plan(xt))
    _close(got, want)


# the gather at other C: 5 (K = 80: two blocks), 4 with odd W (2WC not a
# multiple of 16 bytes), 3 with odd H and W, and one output pixel
@pytest.mark.parametrize("n,h,w,c,o4", [(2, 22, 20, 5, 256),
                                        (1, 23, 19, 4, 128),
                                        (2, 23, 19, 3, 128),
                                        (1, 4, 4, 3, 256)])
def test_emulated_im2col_matches_plain(np_rng, n, h, w, c, o4):
    xt = _t(np_rng.standard_normal((n, h, w, c)))
    w4, b = (_t(v) for v in _operands(np_rng, (4, 4, c), o4))
    assert not strided_boxable(xt)
    got = emulate_strided_gathered(xt, w4, b, _strided_plan(xt))
    _close(got, cf.strided_conv4x4s2_plain(xt, w4, b))


# ------------------------------------------------------------------ H4
@pytest.mark.parametrize("o4", [128, 256])
def test_emulated_identity_boxes_match_pallas(np_rng, o4):
    """upconv3's product (C = 128: two K blocks) on a grid of several
    ragged tiles."""
    n, h, w, c = 2, 9, 23, 128
    x = np_rng.standard_normal((n, h, w, c)).astype(np.float32)
    wm, b = _operands(np_rng, (c,), o4)
    s = jcf.stride_for(w, jnp.float32)
    want = jcf.matmul_rows_padflat(jcf.pad_rows(jnp.asarray(x), s), wm, b,
                                   interpret=True)
    want = jcf.unpad_rows(want, s, h, w)
    plan = _rows_plan(_t(x), False)
    assert plan.count > n
    _close(emulate_rows(_t(x), _t(wm), _t(b), plan, False), want)


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("pf2_out", [False, True])
def test_emulated_scatter_boxes_match_pallas(np_rng, pf2_out, o4):
    """upconv4's slot scatter (C = 64), read by one box per output row."""
    i_in, j_in, c = 5, 11, 64
    x = np_rng.standard_normal((2, i_in, j_in, 4 * c)).astype(np.float32)
    wm, b = _operands(np_rng, (c,), o4)
    s_i = jcf.stride_for(j_in, jnp.float32)
    want = jcf.deconv_packed_padflat(
        jcf.pad_rows(jnp.asarray(x), s_i), wm, b, i_in=i_in, j_in=j_in,
        s_i=s_i, r_block=4, pf2_out=pf2_out, interpret=True)
    if pf2_out:
        want = jcf.unpad_pairs(want, s_i, 2 * i_in, 2 * j_in)
    else:
        want = jcf.unpad_rows(want, jcf.stride_for(2 * j_in, jnp.float32),
                              2 * i_in, 2 * j_in)
    plan = _rows_plan(_t(x), True)
    assert plan.th > 1 and plan.count > 2
    _close(emulate_rows(_t(x), _t(wm), _t(b), plan, True), want)


# C = 72 (a partial second K block), C = 8 (one block of 8 channels), one
# pixel, ragged tiles
@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("n,h,w,c", [(2, 7, 9, 72), (1, 5, 6, 8),
                                     (1, 1, 1, 64), (1, 21, 18, 24)])
def test_emulated_rows_match_plain(np_rng, n, h, w, c, scatter):
    xt = _t(np_rng.standard_normal((n, h, w, 4 * c if scatter else c)))
    wm, b = (_t(v) for v in _operands(np_rng, (c,), 128))
    got = emulate_rows(xt, wm, b, _rows_plan(xt, scatter), scatter)
    _close(got, cf.rows_matmul_plain(xt, wm, b, scatter=scatter))


# ------------------------------------------------------------ TMA's rule
def _strides_in(src, anchor):
    """The four expressions of the first ``strides[4] = {...}`` after
    ``anchor``."""
    body = src[src.index(anchor):]
    inner = re.search(r"strides\[4\] = \{([^}]*)\}", body).group(1)
    return [re.sub(r"\(cuuint64_t\)|LL", "", e).strip().strip("()")
            for e in inner.split(",")]


def _kernel_source():
    return (Path(cf.__file__).resolve().parents[2] / "csrc" /
            "strided_conv4x4s2.cu").read_text()


@pytest.mark.parametrize("c", [3, 4, 5, 16, 32])
@pytest.mark.parametrize("w", [19, 20])
def test_strided_boxable_rule(c, w):
    """Box where every byte stride of the view is a multiple of 16 (C % 4
    == 0 and W C % 8 == 0); the entry's C = 3 and C = 5 are gathered, C =
    4 only at odd W."""
    x = torch.zeros(2, 22, w, c, dtype=torch.bfloat16)
    want = {3: False, 4: w % 2 == 0, 5: False, 16: True, 32: True}[c]
    assert strided_boxable(x) == want


def test_strided_boxable_refuses_a_misaligned_x():
    size = 2 * 22 * 20 * 32
    buf = torch.zeros(size + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    x = buf[1:1 + size].view(2, 22, 20, 32)
    assert x.is_contiguous() and not strided_boxable(x)
    assert strided_boxable(buf[8:8 + size].view(2, 22, 20, 32))


@pytest.mark.parametrize("h,w,c", [(22, 20, 32), (23, 19, 4), (4, 4, 3),
                                   (512, 512, 3), (254, 254, 32)])
def test_strided_boxable_mirrors_the_kernel(h, w, c):
    """The kernel's rule (strided_mode in csrc/strided_conv4x4s2.cu) and
    the strides of its 5-D map are the view's byte strides that the
    Python rule checks."""
    src = _kernel_source()
    rule = _strides_in(src, "inline int strided_mode(")
    mapped = _strides_in(src, "int run_strided(")
    env = {"c": c, "h": h, "w": w, "wdt": w}
    got = [eval(e, {}, env) for e in rule]
    assert got == [eval(e, {}, env) for e in mapped]
    assert got == [4 * c, 2 * w * c, 4 * w * c, 2 * h * w * c]
    x = torch.zeros(1, h, w, c, dtype=torch.bfloat16)
    v = _s2d_view(x)
    assert [2 * s for s in v.stride()[::-1][1:]] == got
    assert strided_boxable(x) == all(s % 16 == 0 for s in got)
