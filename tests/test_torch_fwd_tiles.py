"""H1's and H2's tile plan, box rule and B layout on the CPU.

The bf16 card kernels (csrc/packed_conv2x2_fwd.cuh on csrc/sm90_igemm.cuh)
walk output tiles of th × tw pixels of one image, chosen by
``tiles.tile_plan`` over the output grid, as th · (tw + 1) GEMM rows, and
read A as one halo box per 64-channel K block, zero outside the tensor
(TMA's fill), whose rows shifted by u · (tw + 1) + v are tap (u, v)'s
operand. H2's skip box sits at the crop's packed origin; for C % 64 == 0
each K block is one output slot's box at that slot's origin and source
channel, and an odd offset with C % 64 != 0 gathers the block chunk by
chunk. B is the packed weight viewed as [4 · 4C, 4O], 64 rows a K block
and tap, read MN-major.

At 4O = 512 (n_kernels 64's level 2) a wgmma product is at most 256
columns wide, so each pixel tile is walked as two column tiles of 256
(``FwdOut::ctile``, ``FwdOut::col``): column tile ct holds channels 64 ct
.. 64 ct + 63 of each of the four slots, so that one thread's pool sees a
channel's four slots.

Here the plan must cover every output pixel exactly once, the column
tiles every (pixel, column) of a 4O = 512 output once, and a torch
emulation of those loads (``_emulate``, column tile by column tile) must
equal JAX's Pallas kernels (``conv2x2_padflat`` plain, with pool, with
head, and with the pool's index as JAX's ``_pool4_argmax`` takes it from
the Pallas y; ``conv2x2_dual_padflat`` with even ``a_offset`` and odd
``a_slot_phase``, 4C = 128 to 512, 4O = 128 to 512; interpret mode) in f32
at rtol = atol = 1e-4, as tests/test_torch_kernels.py holds the plain
versions; partial K blocks, which the Pallas kernels do not take, are held
against the port's plain version. Masks may differ only where the head's
f32 margin is within summation-order noise, pool indices only where two
slots lie within it. Last, the MN-major descriptor's strides (read from
csrc/sm90_igemm.cuh) must address every element of a k16 step where TMA's
128-byte swizzle put it.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_tpu.models.unet_fast import _pool4_argmax
from segmentation_tpu.nn.pallas.conv_flat import (
    conv2x2_dual_padflat,
    conv2x2_padflat,
    pad_rows,
    stride_for,
    unpad_rows,
)
from segmentation_tpu_torch.nn.kernels import conv_flat as cf
from segmentation_tpu_torch.nn.kernels.tiles import tile_plan

TOL = 1e-4
# the output grid [N, ho, wo] at the six 512² sites (B = 8); every site
# has tiles of cf.FWD_TILE_ROWS wgmma rows
SITES = {"conv1_2": (8, 254, 254),
         "conv2_2": (8, 125, 125),
         "conv8_1": (8, 83, 83),
         "conv8_2": (8, 82, 82),
         "conv9_1": (8, 163, 163),
         "conv9_2": (8, 162, 162)}
# the output grids of tests/test_torch_cuda.py's H1 and H2 cases: ragged
# tiles, one row, one column, one pixel, N = 3
RAGGED = [(1, 125, 125), (2, 12, 20), (1, 43, 64), (1, 1, 39), (1, 39, 1),
          (2, 1, 1), (3, 19, 44), (2, 8, 12), (1, 8, 12), (2, 8, 10),
          (3, 23, 48)]


def _coverage(plan):
    hits = np.zeros((plan.n, plan.hx, plan.wx), np.int64)
    for t in range(plan.count):
        n, i0, j0 = plan.origin(t)
        assert 0 <= i0 < plan.hx and 0 <= j0 < plan.wx, (t, i0, j0)
        hits[n, i0:i0 + plan.th, j0:j0 + plan.tw] += 1
    return hits


@pytest.mark.parametrize("site", list(SITES))
def test_tile_plan_covers_the_sites_once(site):
    n, ho, wo = SITES[site]
    rows = cf.FWD_TILE_ROWS
    plan = tile_plan(n, ho, wo, rows)
    assert plan.th * (plan.tw + 1) <= rows and max(plan.th, plan.tw) < 256
    assert (_coverage(plan) == 1).all()
    # padded rows: at most 15 % of the wgmma rows store no output pixel
    assert plan.count * rows <= 1.15 * n * ho * wo, plan


@pytest.mark.parametrize("shape", RAGGED)
def test_tile_plan_covers_ragged_shapes_once(shape):
    rows = cf.FWD_TILE_ROWS
    plan = tile_plan(*shape, rows)
    assert plan.th * (plan.tw + 1) <= rows
    assert (_coverage(plan) == 1).all()


def test_card_cases_leave_ragged_last_tiles():
    """The card tests' "ragged tiles" cases, output [1, 43, 64], cut the
    last tile short in both directions."""
    plan = tile_plan(1, 43, 64, cf.FWD_TILE_ROWS)
    assert 43 % plan.th and 64 % plan.tw, plan


# the output grids of level 2's 4O = 512 sites at 512² (N = 1, n_kernels
# 64), a ragged one and one pixel
WIDE = {"conv2_1": (1, 126, 126), "conv2_2": (1, 125, 125),
        "upconv3": (1, 84, 84), "conv8_1": (1, 83, 83),
        "conv8_2": (1, 82, 82), "ragged": (3, 19, 44),
        "one pixel": (2, 1, 1)}


def _column_tiles(o4):
    """The output columns of each column tile of a pixel tile, in the
    kernels' walk (tile t is column tile t % CT of pixel tile t // CT):
    every column at 4O <= 256; at 4O = 512 channels 64 ct .. 64 ct + 63 of
    each of the four slots (FwdOut::col)."""
    if o4 <= 256:
        return [list(range(o4))]
    o = o4 // 4
    return [[s * o + c for s in range(4) for c in range(c0, c0 + 64)]
            for c0 in range(0, o, 64)]


@pytest.mark.parametrize("site", list(WIDE))
def test_column_tiles_store_every_output_once(site):
    """Over the walk every (pixel, column) of a 4O = 512 output is stored
    exactly once, and each column tile holds 64 channels of all four
    slots."""
    n, ho, wo = WIDE[site]
    plan = tile_plan(n, ho, wo, cf.FWD_TILE_ROWS)
    ctiles = _column_tiles(512)
    for ct, cols in enumerate(ctiles):
        assert sorted(cols) == [s * 128 + c for s in range(4)
                                for c in range(64 * ct, 64 * ct + 64)]
    hits = np.zeros((n, ho, wo, 512), np.uint8)
    for t in range(plan.count * len(ctiles)):
        b, i0, j0 = plan.origin(t // len(ctiles))
        hits[b, i0:i0 + plan.th, j0:j0 + plan.tw,
             ctiles[t % len(ctiles)]] += 1
    assert (hits == 1).all()


# ------------------------------------------------------------ the emulation
def _box(src, n, i0, j0, th, wrow, chans):
    """The halo box [th + 1, wrow] of src [N, H, W, C] at (n, i0, j0), on
    the channels ``chans`` (a list, -1 past C), zero outside src, flat to
    rows, with ``wrow`` more zero rows: a tap's view runs past the box."""
    _, h, w, c = src.shape
    box = torch.zeros(th + 2, wrow, len(chans))
    ci = torch.tensor([k if 0 <= k < c else 0 for k in chans])
    live = torch.tensor([0 <= k < c for k in chans], dtype=src.dtype)
    si, sj = max(i0, 0), max(j0, 0)
    ei, ej = min(i0 + th + 1, h), min(j0 + wrow, w)
    if si < ei and sj < ej:
        box[si - i0:ei - i0, sj - j0:ej - j0] = \
            src[n, si:ei, sj:ej][..., ci] * live
    return box.reshape(-1, len(chans))


def _skip_box(skip, c4, offset, n, i0, j0, th, wrow, kb):
    """The skip's K block kb as the kernel loads it (FwdTiles::load_a,
    gather_a): one box at the crop's packed origin (even offset), one box
    per output slot (C % 64 == 0), else gathered chunk by chunk."""
    oh, ow = offset
    cs, k0 = c4 // 4, 64 * kb
    if oh % 2 == 0 and ow % 2 == 0 and cs % 64:
        return _box(skip, n, oh // 2 + i0, ow // 2 + j0, th, wrow,
                    list(range(k0, k0 + 64)))
    if cs % 64 == 0:
        s = k0 // cs
        yy, xx = oh + (s >> 1), ow + (s & 1)
        ch = (2 * (yy & 1) + (xx & 1)) * cs + k0 - s * cs
        return _box(skip, n, (yy >> 1) + i0, (xx >> 1) + j0, th, wrow,
                    list(range(ch, ch + 64)))
    _, hpa, wpa, _ = skip.shape
    rows = torch.zeros((th + 2) * wrow, 64)
    for row in range((th + 1) * wrow):
        bi, bj = divmod(row, wrow)
        for chunk in range(8):
            k = k0 + 8 * chunk
            if k >= c4:
                continue
            s = k // cs
            yy = oh + 2 * (i0 + bi) + (s >> 1)
            xx = ow + 2 * (j0 + bj) + (s & 1)
            if (yy >> 1) < hpa and (xx >> 1) < wpa:
                c = (2 * (yy & 1) + (xx & 1)) * cs + k - s * cs
                rows[row, 8 * chunk:8 * chunk + 8] = \
                    skip[n, yy >> 1, xx >> 1, c:c + 8]
    return rows


def _b_rows(w, kb, tap):
    """B of (K block, tap): 64 rows of w viewed as [4 · 4C, 4O] from row
    tap · 4C + 64 kb, zero past the weight (FwdTiles::load_b)."""
    c4, o4 = w.shape[2], w.shape[3]
    flat = torch.cat([w.reshape(4 * c4, o4), torch.zeros(64, o4)])
    r = tap * c4 + 64 * kb
    return flat[r:r + 64]


def _emulate(x, w, b, plan, *, skip=None, wa=None, offset=(0, 0),
             pool=False, pool_index=False, head=None):
    """The kernel's arithmetic on its own loads, in f32, one pixel tile and
    column tile at a time, the pool and its index over the column tile's
    four slots: (y, mask, pooled, idx) as the kernel stores them (y f32
    here)."""
    n, hp, wp, c4 = x.shape
    o4 = w.shape[-1]
    kps = -(-c4 // 64)
    th, wrow = plan.th, plan.tw + 1  # GEMM row m = a · wrow + b
    rows = th * wrow
    ctiles = _column_tiles(o4)
    shp = (n, plan.hx, plan.wx)
    y = torch.full(shp + (o4,), float("nan"))
    pooled = torch.full(shp + (o4 // 4,), float("nan"))
    idx = torch.full(shp + (o4 // 4,), -1, dtype=torch.int8)
    for t in range(plan.count * len(ctiles)):
        bn, i0, j0 = plan.origin(t // len(ctiles))
        ct, cols = t % len(ctiles), ctiles[t % len(ctiles)]
        acc = torch.zeros(rows, len(cols))
        sides = [(x, w, lambda kb: _box(x, bn, i0, j0, th, wrow,
                                         list(range(64 * kb, 64 * kb + 64))))]
        if skip is not None:
            sides.insert(0, (skip, wa, lambda kb: _skip_box(
                skip, c4, offset, bn, i0, j0, th, wrow, kb)))
        for _, ws, load in sides:
            for kb in range(kps):
                a = load(kb)
                for tap in range(4):
                    shift = (tap >> 1) * wrow + (tap & 1)
                    acc += a[shift:shift + rows] @ _b_rows(ws, kb, tap)[:, cols]
        acc = torch.relu(acc + b[cols]).view(th, wrow, -1)[:, :plan.tw]
        hi, wi = min(th, plan.hx - i0), min(plan.tw, plan.wx - j0)
        acc = acc[:hi, :wi]
        y[bn, i0:i0 + hi, j0:j0 + wi][..., cols] = acc
        # the pool: the first slot above every earlier one (strict >)
        s4 = acc.reshape(hi, wi, 4, -1)
        best = s4[:, :, 0].clone()
        first = torch.zeros(best.shape, dtype=torch.int8)
        for sl in range(1, 4):
            first[s4[:, :, sl] > best] = sl
            best = torch.maximum(best, s4[:, :, sl])
        ch = slice(ct * s4.shape[-1], (ct + 1) * s4.shape[-1])
        pooled[bn, i0:i0 + hi, j0:j0 + wi, ch] = best
        idx[bn, i0:i0 + hi, j0:j0 + wi, ch] = first
    assert not y.isnan().any()  # every pixel was stored
    outs = [y]
    if head is not None:
        wd, bd = head
        yb = y.to(torch.bfloat16).float()
        outs.append(((yb @ wd.to(torch.bfloat16).float() + bd) > 0)
                    .to(torch.uint8))
    if pool or pool_index:
        outs.append(pooled)
    if pool_index:
        outs.append(idx)
    return outs


def _weights(rng, c4, o4):
    w = (rng.standard_normal((2, 2, c4, o4)) * 0.05).astype(np.float32)
    b = rng.standard_normal((o4,)).astype(np.float32)
    return w, b


def _mask_close(got, want, y, wd, bd):
    """Masks equal except where the head's f32 margin is within noise."""
    got, want = np.asarray(got), np.asarray(want)
    yb = y.to(torch.bfloat16).float().numpy()
    wdb = torch.from_numpy(wd).to(torch.bfloat16).float().numpy()
    margin = yb @ wdb + bd
    diff = got != want
    assert np.all(np.abs(margin[diff]) < TOL), np.abs(margin[diff]).max()
    assert diff.mean() < 1e-3


def _index_close(got, want, y):
    """Pool indices equal except where the two slots' f32 values lie
    within summation-order noise of each other."""
    got, want = np.asarray(got), np.asarray(want)
    s4 = np.asarray(y).reshape(*y.shape[:3], 4, -1)
    diff = got != want
    a = np.take_along_axis(s4, got[..., None, :].astype(np.int64), 3)[..., 0, :]
    b = np.take_along_axis(s4, want[..., None, :].astype(np.int64), 3)[..., 0, :]
    assert np.all(np.abs(a - b)[diff] <= TOL)
    assert diff.mean() < 1e-3


# output grids whose plans have several tiles per image, ragged ones
# included: (N, hp, wp) of x, 4C, 4O; 4O = 512 in every mode it has (no
# head: the head is level 1's)
EMULATED = [(2, 20, 38, 128, 128), (1, 12, 22, 256, 256),
            (2, 18, 24, 128, 256), (2, 10, 16, 256, 512)]
MODES = [shape + (mode,) for shape in EMULATED
         for mode in ("plain", "pool", "head")
         if not (mode == "head" and shape[-1] == 512)]
MODES += [shape + ("pool_index",) for shape in EMULATED]


@pytest.mark.parametrize("n,hp,wp,c4,o4,mode", MODES)
def test_emulated_boxes_match_pallas_conv2x2(np_rng, n, hp, wp, c4, o4,
                                             mode):
    x = np_rng.standard_normal((n, hp, wp, c4)).astype(np.float32)
    w, b = _weights(np_rng, c4, o4)
    wd = np_rng.standard_normal((o4, 4)).astype(np.float32)
    bd = np_rng.standard_normal((4,)).astype(np.float32)
    kw = {"pool": mode == "pool"}
    if mode == "head":
        kw["head"] = (wd, bd)
    s = stride_for(wp, jnp.float32)
    want = conv2x2_padflat(pad_rows(jnp.asarray(x), s), w, b, h=hp,
                           w_real=wp, s=s, r_block=4, interpret=True, **kw)
    want = want if isinstance(want, tuple) else (want,)
    want = [np.asarray(unpad_rows(v, s, hp - 1, wp - 1)) for v in want]
    if mode == "pool_index":  # JAX's train pool: index from the Pallas y
        kw = {"pool_index": True}
        want += [np.asarray(v) for v in _pool4_argmax(jnp.asarray(want[0]))]
    plan = tile_plan(n, hp - 1, wp - 1, cf.FWD_TILE_ROWS)
    assert plan.count > n  # several tiles per image
    if mode == "head":
        kw["head"] = (torch.from_numpy(wd), torch.from_numpy(bd))
    got = _emulate(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), plan, **kw)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=TOL, atol=TOL)
    if mode == "head":
        _mask_close(got[1], want[1], got[0], wd, bd)
    if mode in ("pool", "pool_index"):
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=TOL,
                                   atol=TOL)
    if mode == "pool_index":
        _index_close(got[2], want[2], got[0])


# (up's N, hp, wp), the skip 4 packed pixels larger, 4C, 4O, offset
# (4O = 512: where the skip is boxed, an even offset or C % 64 == 0 at an
# odd one, as conv8_1's (41, 41) at n_kernels 64)
DUAL = [((2, 14, 30), 128, 128, (4, 2)), ((2, 14, 30), 128, 128, (3, 5)),
        ((1, 9, 21), 128, 256, (6, 3)), ((1, 12, 22), 256, 256, (4, 6)),
        ((2, 12, 22), 256, 256, (5, 7)), ((1, 18, 20), 256, 128, (2, 1)),
        ((1, 10, 18), 128, 512, (4, 6)), ((2, 12, 16), 256, 512, (3, 5))]


@pytest.mark.parametrize("shape,c4,o4,offset", DUAL)
def test_emulated_boxes_match_pallas_dual(np_rng, shape, c4, o4, offset):
    n, hp, wp = shape
    ha, wa_ = hp + 4, wp + 4
    xa = np_rng.standard_normal((n, ha, wa_, c4)).astype(np.float32)
    xb = np_rng.standard_normal((n, hp, wp, c4)).astype(np.float32)
    wa, b = _weights(np_rng, c4, o4)
    wb, _ = _weights(np_rng, c4, o4)
    even = offset[0] % 2 == 0 and offset[1] % 2 == 0
    kw = (dict(a_offset=(offset[0] // 2, offset[1] // 2)) if even
          else dict(a_offset=(0, 0), a_slot_phase=offset))
    sa, sb = stride_for(wa_, jnp.float32), stride_for(wp, jnp.float32)
    xaf = pad_rows(jnp.asarray(xa), sa)
    want = conv2x2_dual_padflat(
        xaf, pad_rows(jnp.asarray(xb), sb), wa, wb, b, h=hp, w_real=wp,
        s=sb, s_a=sa, hp_a=xaf.shape[1] // sa, r_block=4, interpret=True,
        **kw)
    want = np.asarray(unpad_rows(want, sb, hp - 1, wp - 1))
    plan = tile_plan(n, hp - 1, wp - 1, cf.FWD_TILE_ROWS)
    assert plan.count > n
    (got,) = _emulate(torch.from_numpy(xb), torch.from_numpy(wb),
                      torch.from_numpy(b), plan, skip=torch.from_numpy(xa),
                      wa=torch.from_numpy(wa), offset=offset)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("c4", [8, 72])
@pytest.mark.parametrize("o4", [128, 256, 512])
def test_emulated_partial_k_block_matches_plain(np_rng, c4, o4):
    """4C = 72: the second K block holds 8 channels and 56 zeros, its B
    rows the next tap's; 4C = 8: one block of 8 channels."""
    x = torch.from_numpy(np_rng.standard_normal((2, 9, 13, c4))
                         .astype(np.float32))
    w, b = (torch.from_numpy(v) for v in _weights(np_rng, c4, o4))
    plan = tile_plan(2, 8, 12, cf.FWD_TILE_ROWS)
    got = _emulate(x, w, b, plan, pool=True)
    want = cf.packed_conv2x2_plain(x, w, b, pool=True)
    for g, wv in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), wv.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("offset", [(0, 0), (4, 6), (3, 5), (2, 1)])
def test_emulated_dual_partial_k_block_matches_plain(np_rng, offset):
    """4C = 96 (C = 24): the skip's second K block holds slots 2 and 3 of
    other origins and 32 zeros; even offsets read it as one box."""
    xa = torch.from_numpy(np_rng.standard_normal((2, 13, 15, 96))
                          .astype(np.float32))
    xb = torch.from_numpy(np_rng.standard_normal((2, 9, 11, 96))
                          .astype(np.float32))
    (wa, b), (wb, _) = (_weights(np_rng, 96, 128) for _ in range(2))
    wa, wb, b = (torch.from_numpy(v) for v in (wa, wb, b))
    plan = tile_plan(2, 8, 10, cf.FWD_TILE_ROWS)
    (got,) = _emulate(xb, wb, b, plan, skip=xa, wa=wa, offset=offset)
    want = cf.packed_conv2x2_dual_plain(xa, xb, wa, wb, b, offset=offset)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)


# ------------------------------------------------------------ B's layout
def _mn_desc_constants():
    """(LBO, SBO, k16 step) in bytes, as csrc/sm90_igemm.cuh writes them."""
    src = (Path(cf.__file__).resolve().parents[2] / "csrc" /
           "sm90_igemm.cuh").read_text()
    box = re.search(r"constexpr int kMnBox = (\d+) \* (\d+);", src)
    body = re.search(r"uint64_t sw128_mn_desc\(const void\* p\) \{(.*?)\}",
                     src, re.S).group(1)
    lbo = re.search(r"\(\(uint64_t\)\((\w+) >> 4\) << 16\)", body).group(1)
    sbo = re.search(r"\(\(uint64_t\)\((\d+) >> 4\) << 32\)", body).group(1)
    step = re.search(r"b_step = P::B_MN \? (\d+) >> 4", src).group(1)
    assert lbo == "kMnBox" and "<< 62" in body  # layout 1: 128-byte swizzle
    return int(box.group(1)) * int(box.group(2)), int(sbo), int(step)


def _sw128(addr):
    """The 128-byte swizzle of a shared address (1024-byte aligned base):
    its 16-byte chunk index XOR its 128-byte row index mod 8."""
    return addr ^ (((addr >> 7) & 7) << 4)


@pytest.mark.parametrize("nb", [128, 256])
def test_mn_major_descriptor_reads_where_tma_writes(nb):
    """Every element (k, c) of each k16 step of a B stage: the address
    wgmma's canonical MN-major 128-byte-swizzled layout gives it from the
    descriptor's start, LBO and SBO (8 columns of 2 bytes a 16-byte unit,
    8 units a 128-byte row of one K value, K rows 128 bytes apart, 8-row
    groups SBO apart, 64-column blocks LBO apart; then the swizzle) is the
    byte where TMA's 128-byte swizzle put it, box c // 64 holding rows k
    of columns c % 64."""
    lbo, sbo, step = _mn_desc_constants()
    assert lbo == 64 * 128  # one box: 64 K rows of 128 bytes
    k = np.arange(64)[:, None]
    c = np.arange(nb)[None, :]
    tma = (c // 64) * lbo + _sw128(k * 128 + (c % 64) * 2)
    for ks in range(4):
        kk = np.arange(16)[:, None]
        canon = ks * step + (c // 64) * lbo + (kk // 8) * sbo \
            + (kk % 8) * 128 + (c % 64) * 2
        np.testing.assert_array_equal(_sw128(canon), tma[16 * ks:16 * ks + 16])
    # each stage's bytes: NB / 64 boxes, the ring's B_BYTES = NB · 128
    assert (nb // 64) * lbo == nb * 128
