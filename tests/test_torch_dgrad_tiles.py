"""H6's tile plan and box rule on the CPU.

The card kernel (csrc/packed_conv2x2_dgrad.cu) walks output tiles of th ×
tw pixels of one image, chosen by ``tiles.tile_plan``, as th · (tw + 1)
GEMM rows, and reads its A operand as one halo box of g per 64-channel K
block, zero outside g (TMA's fill), whose rows shifted by (1 − u)(tw + 1)
+ 1 − v are tap (u, v)'s operand. Here the plan must cover every dx pixel
exactly once, and a torch emulation of the kernel's loads (this file's
``_emulate``: per tile and K block the halo box [th + 1, tw + 1] of g at
(n, i0 − 1, j0 − 1, k0), zero out of range, each tap's shifted rows times
its weight rows, the rows inside dx stored) must equal JAX's Pallas dgrads
(``conv2x2_dgrad_padflat``, ``conv2x2_dgrad_dual_padflat``, interpret
mode) in f32 at rtol = atol = 1e-4, as tests/test_torch_train_kernels.py
holds the plain versions. 4O = 72 (a partial K block), which the Pallas
kernels do not take, is held against the plain version instead. At 4C =
512 (n_kernels 64's level 2) each pixel tile is walked as two column tiles
of 256 channels of dx a side (``DgradTiles::c0``): the walk must store
every (pixel, channel) once and the emulation takes B's rows a column tile
at a time.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_tpu.nn.pallas.conv_flat import (
    pad_rows,
    stride_for,
    unpad_rows,
)
from segmentation_tpu.nn.pallas.conv_flat_bwd import (
    conv2x2_dgrad_dual_padflat,
    conv2x2_dgrad_padflat,
)
from segmentation_tpu_torch.nn.kernels import conv_bwd as cb

MODES = [(128, False), (256, False), (128, True), (256, True),
         (512, False), (512, True)]
# dx [N, hx, wx] at the six 512² sites (B = 8) with each site's mode
SITES = {"conv1_2": ((8, 255, 255), (128, False)),
         "conv2_2": ((8, 126, 126), (256, False)),
         "conv8_1": ((8, 84, 84), (256, True)),
         "conv8_2": ((8, 83, 83), (256, False)),
         "conv9_1": ((8, 164, 164), (128, True)),
         "conv9_2": ((8, 163, 163), (128, False))}
# g's shapes of tests/test_torch_cuda.py's dgrad cases: ragged tiles, one
# row, one column, one pixel, N = 3
RAGGED = [(2, 6, 10), (1, 4, 6), (2, 5, 9), (1, 3, 4), (1, 50, 70),
          (1, 37, 300), (1, 300, 37), (2, 1, 1), (1, 1, 9), (1, 7, 1),
          (3, 20, 45), (3, 9, 13), (2, 9, 13)]


def _coverage(plan):
    hits = np.zeros((plan.n, plan.hx, plan.wx), np.int64)
    for t in range(plan.count):
        n, i0, j0 = plan.origin(t)
        assert 0 <= i0 < plan.hx and 0 <= j0 < plan.wx, (t, i0, j0)
        hits[n, i0:i0 + plan.th, j0:j0 + plan.tw] += 1
    return hits


@pytest.mark.parametrize("site", list(SITES))
def test_tile_plan_covers_the_sites_once(site):
    (n, hx, wx), (c4, dual) = SITES[site]
    rows = cb.tile_rows(c4, dual)
    plan = cb.tile_plan(n, hx, wx, rows)
    assert plan.th * (plan.tw + 1) <= rows and max(plan.th, plan.tw) < 256
    assert (_coverage(plan) == 1).all()
    # padded rows: at most 15 % of the wgmma rows store no output pixel
    assert plan.count * rows <= 1.15 * n * hx * wx, plan


@pytest.mark.parametrize("c4,dual", MODES)
@pytest.mark.parametrize("shape", RAGGED)
def test_tile_plan_covers_ragged_shapes_once(shape, c4, dual):
    n, hg, wg = shape
    rows = cb.tile_rows(c4, dual)
    plan = cb.tile_plan(n, hg + 1, wg + 1, rows)
    assert plan.th * (plan.tw + 1) <= rows
    assert (_coverage(plan) == 1).all()


@pytest.mark.parametrize("c4,dual", MODES)
def test_card_cases_leave_ragged_last_tiles(c4, dual):
    """The card tests' "ragged tiles" case, g [1, 50, 70], cuts the last
    tile short in both directions for every tile size the plan takes."""
    n, hg, wg = 1, 50, 70
    plan = cb.tile_plan(n, hg + 1, wg + 1, cb.tile_rows(c4, dual))
    assert (hg + 1) % plan.th and (wg + 1) % plan.tw, plan


def _column_tiles(c4):
    """dx's channels of each column tile of a pixel tile, a side, in the
    kernel's walk (tile t is column tile t % CT of pixel tile t // CT):
    every channel at 4C <= 256, runs of 256 at 4C = 512 (DgradTiles::c0)."""
    cw = min(c4, 256)
    return [list(range(c0, c0 + cw)) for c0 in range(0, c4, cw)]


# dx [N, hx, wx] of level 2's 4C = 512 sites at 512² (N = 1, n_kernels 64)
# with each site's mode, a ragged one and one pixel
WIDE = {"conv2_2": ((1, 126, 126), False), "conv8_1": ((1, 84, 84), True),
        "conv8_2": ((1, 83, 83), False), "ragged": ((3, 19, 44), True),
        "one pixel": ((2, 1, 1), False)}


@pytest.mark.parametrize("site", list(WIDE))
def test_column_tiles_store_every_output_once(site):
    (n, hx, wx), dual = WIDE[site]
    plan = cb.tile_plan(n, hx, wx, cb.tile_rows(512, dual))
    ctiles = _column_tiles(512)
    hits = np.zeros((n, hx, wx, 512), np.uint8)
    for t in range(plan.count * len(ctiles)):
        b, i0, j0 = plan.origin(t // len(ctiles))
        hits[b, i0:i0 + plan.th, j0:j0 + plan.tw,
             ctiles[t % len(ctiles)]] += 1
    assert (hits == 1).all()


def _emulate(g, ws, plan):
    """The kernel's arithmetic on its own loads: f32, one pixel tile and
    column tile at a time (B: the tile's run of each side's rows)."""
    n, hg, wg, o4 = g.shape
    c4 = ws[0].shape[2]
    wcat = torch.cat(list(ws), dim=2)  # B rows [wa | wb]: [2, 2, NB, 4O]
    nb = wcat.shape[2]
    ctiles = [[side * c4 + c for side in range(len(ws)) for c in cols]
              for cols in _column_tiles(c4)]
    outs = torch.full((n, plan.hx, plan.wx, nb), float("nan"))
    kb = -(-o4 // 64)
    gk = torch.zeros(n, hg, wg, kb * 64)  # channels past 4O: TMA's zeros
    gk[..., :o4] = g
    wk = torch.zeros(2, 2, nb, kb * 64)
    wk[..., :o4] = wcat
    th, wrow = plan.th, plan.tw + 1  # GEMM row m = a · wrow + b
    rows = th * wrow
    for t in range(plan.count * len(ctiles)):
        b, i0, j0 = plan.origin(t // len(ctiles))
        cols = ctiles[t % len(ctiles)]
        acc = torch.zeros(rows, len(cols))
        for k in range(kb):
            ks = slice(64 * k, 64 * k + 64)
            # the halo box [th + 1, tw + 1] at (i0 - 1, j0 - 1), zero outside
            # g, and one more zero row: tap (0, 0)'s view runs one row past
            halo = torch.zeros((th + 1) * wrow + 1, 64)
            box = halo[:-1].view(th + 1, wrow, 64)
            si, sj = max(i0 - 1, 0), max(j0 - 1, 0)
            ei, ej = min(i0 + th, hg), min(j0 + plan.tw, wg)
            if si < ei and sj < ej:
                box[si - i0 + 1:ei - i0 + 1, sj - j0 + 1:ej - j0 + 1] = \
                    gk[b, si:ei, sj:ej, ks]
            for tap in range(4):
                u, v = tap >> 1, tap & 1
                shift = (1 - u) * wrow + 1 - v
                acc += halo[shift:shift + rows] @ wk[u, v, cols, ks].T
        acc = acc.view(th, wrow, -1)[:, :plan.tw]  # the junk column goes
        hi, wi = min(th, plan.hx - i0), min(plan.tw, plan.wx - j0)
        outs[b, i0:i0 + hi, j0:j0 + wi][..., cols] = acc[:hi, :wi]
    assert not outs.isnan().any()  # every pixel was stored
    return [outs[..., c4 * s:c4 * (s + 1)] for s in range(len(ws))]


def _operands(rng, n, hx, wx, c4, o4, nw):
    ws = [(rng.standard_normal((2, 2, c4, o4)) * 0.1).astype(np.float32)
          for _ in range(nw)]
    g = rng.standard_normal((n, hx - 1, wx - 1, o4)).astype(np.float32)
    return g, ws


# dx shapes whose plans have several tiles per image, ragged ones included
EMULATED = [(2, 19, 37, 128, 128), (1, 11, 21, 256, 256),
            (3, 17, 23, 128, 128), (2, 13, 17, 512, 256)]


@pytest.mark.parametrize("n,hx,wx,c4,o4", EMULATED)
def test_emulated_boxes_match_pallas_dgrad(np_rng, n, hx, wx, c4, o4):
    g, (wk,) = _operands(np_rng, n, hx, wx, c4, o4, 1)
    s = stride_for(wx, jnp.float32)
    want = unpad_rows(conv2x2_dgrad_padflat(
        pad_rows(jnp.asarray(g), s), jnp.asarray(wk), h_out=hx, w_out=wx,
        s=s, interpret=True), s, hx, wx)
    plan = cb.tile_plan(n, hx, wx, cb.tile_rows(c4, False))
    assert plan.count > n  # several tiles per image
    (got,) = _emulate(torch.from_numpy(g), [torch.from_numpy(wk)], plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n,hx,wx,c4,o4", EMULATED)
def test_emulated_boxes_match_pallas_dgrad_dual(np_rng, n, hx, wx, c4, o4):
    g, (wa, wb) = _operands(np_rng, n, hx, wx, c4, o4, 2)
    s = stride_for(wx, jnp.float32)
    want = conv2x2_dgrad_dual_padflat(
        pad_rows(jnp.asarray(g), s), jnp.asarray(wa), jnp.asarray(wb),
        h_out=hx, w_out=wx, s=s, interpret=True)
    plan = cb.tile_plan(n, hx, wx, cb.tile_rows(c4, True))
    assert plan.count > n
    got = _emulate(torch.from_numpy(g),
                   [torch.from_numpy(wa), torch.from_numpy(wb)], plan)
    for gt, wt in zip(got, want, strict=True):
        np.testing.assert_allclose(gt.numpy(),
                                   np.asarray(unpad_rows(wt, s, hx, wx)),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c4,dual", MODES)
def test_emulated_partial_k_block_matches_plain(np_rng, c4, dual):
    """4O = 72: the second K block holds 8 channels and 56 zeros."""
    g, ws = _operands(np_rng, 2, 10, 14, c4, 72, 1 + dual)
    g, ws = torch.from_numpy(g), [torch.from_numpy(w) for w in ws]
    plan = cb.tile_plan(2, 10, 14, cb.tile_rows(c4, dual))
    got = _emulate(g, ws, plan)
    for gt, w in zip(got, ws, strict=True):
        want = cb.packed_conv2x2_dgrad_plain(g, w)
        np.testing.assert_allclose(gt.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)
