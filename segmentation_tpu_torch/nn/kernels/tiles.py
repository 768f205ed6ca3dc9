"""The output tiles of the Hopper kernels on ``csrc/sm90_igemm.cuh`` (the
forward of H1–H4, H5, H6 dgrad, H8), and TMA's rule on what it can box.

Each kernel walks th × tw pixel rectangles of one image of its output
grid and reads its A operand per K block as one TMA halo box (the four
taps of H1–H3 and H6, H8's nine), as boxes of the tile itself (H4) or
gathered (H3's entry).
The plan is made here, once per shape, and handed to the kernel as (th,
tw).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class TilePlan:
    """Output tiles of th × tw pixels of one image, row-major over [N,
    tiles_h, tiles_w]; tile t starts at ``origin(t)``. The kernel lays a
    tile out as th · (tw + halo) GEMM rows (with halo 1, one junk column
    per image row, so that every tap reads the same halo box shifted by
    whole rows) and walks the same map (``DgradTiles::origin``,
    ``FwdOut::origin``)."""

    n: int
    hx: int
    wx: int
    th: int
    tw: int

    @property
    def tiles_h(self) -> int:
        return -(-self.hx // self.th)

    @property
    def tiles_w(self) -> int:
        return -(-self.wx // self.tw)

    @property
    def count(self) -> int:
        return self.n * self.tiles_h * self.tiles_w

    def origin(self, t: int):
        """(n, i0, j0) of tile t."""
        n, r = divmod(t, self.tiles_h * self.tiles_w)
        ti, tj = divmod(r, self.tiles_w)
        return n, ti * self.th, tj * self.tw


@functools.lru_cache(maxsize=64)
def tile_plan(n: int, hx: int, wx: int, rows: int, halo: int = 1,
              step: int = 1, max_w: int = 256) -> TilePlan:
    """The tiles of an [n, hx, wx] output for a kernel tile of ``rows``
    GEMM rows: th · (tw + halo) <= rows, tw a multiple of ``step``, and a
    box of th + halo rows and tw + halo columns at most 256 a side (TMA's
    limit), its rows at most ``max_w`` wide (tw + halo; the kernel's A slot
    holds the largest tap shift of such a row). The fewest tiles (each
    costs ``rows`` wgmma rows however many it fills), ties to the wider
    tile; then th and tw shrink to the least that keeps the count, so the
    tiles split the image evenly."""
    best = None
    for tw in range(step, min(wx, 255) + step, step):
        th = min(rows // (tw + halo), hx, 256 - halo)
        if th == 0 or tw + halo > min(256, max_w):
            break
        nh, nw = -(-hx // th), -(-wx // tw)
        if best is None or nh * nw <= best[0] * best[1]:
            best = (nh, nw)
    nh, nw = best
    tw = -(-(-(-wx // nw)) // step) * step
    return TilePlan(n, hx, wx, -(-hx // nh), tw)


def std_tile(o: int, accumulators: int):
    """(NB, BM, W_MAX) of H8's tiles for O output channels, in each of its
    kernels (csrc/std_conv3x3_s8.cu StdTiles, csrc/std_conv3x3_bf16.cu
    StdBf16Tiles): column tiles of NB = 256 where that divides O (O = 512:
    two a pixel tile), else 128; BM GEMM rows a tile, 256 at NB = 128 (two
    m64n128 a consumer warpgroup) and 128 at NB = 256 (one m64n256), over
    the ``accumulators`` a consumer holds (the s8 dual's two, one a side;
    the s8 single's and both bf16 modes' one); rows of the tile's halo box
    at most W_MAX wide."""
    nb = 256 if o % 256 == 0 else 128
    bm = (256 if nb == 128 else 128) // accumulators
    return nb, bm, 128 if bm >= 128 else 64


def std_plan(n, ho, wo, o, accumulators: int) -> TilePlan:
    """H8's output tiles: th · (tw + 2) <= BM GEMM rows (two junk columns a
    row: the nine taps are row shifts of one halo box), tw + 2 <= W_MAX."""
    _, bm, w_max = std_tile(o, accumulators)
    return tile_plan(n, ho, wo, bm, halo=2, max_w=w_max)


# H5 (csrc/entry_chain.cu): a tile's GEMM rows (conv1_2's two m64 groups),
# the rows of its shared-memory slot (the halo's conv1_1 pixels in m64
# chunks), and the wgmma k-steps of conv1_2 a tile (4 taps x 4 k32 steps
# per m64 group) and of conv1_1 an m64 chunk (3 k16 steps)
ENTRY_TILE_ROWS, ENTRY_SLOT_ROWS = 128, 256
ENTRY_CONV1_2_STEPS, ENTRY_CONV1_1_STEPS = 32, 3


def entry_halo_chunks(th: int, tw: int) -> int:
    """The m64 chunks of conv1_1 rows that H5 computes for one tile."""
    return -(-(th + 1) * (tw + 1) // 64)


@functools.lru_cache(maxsize=64)
def entry_tile_plan(n: int, ho: int, wo: int) -> TilePlan:
    """H5's tiles of its [n, ho, wo] output (conv1_2's): th · (tw + 1) <=
    ENTRY_TILE_ROWS GEMM rows, the (th + 1) × (tw + 1) halo of conv1_1
    pixels within the slot, and the largest tap shift too (tw + 130 <=
    ENTRY_SLOT_ROWS). Each tile recomputes its halo, which its neighbours
    compute as well, so the plan weighs both products: the fewest wgmma
    k-steps over the tiles (conv1_2's fixed 32, conv1_1's 3 per m64 chunk
    of halo rows), ties to the fewer halo rows; then th and tw shrink to
    the least that keeps the tile counts. At 512² (254 × 254 outputs): 8 ×
    15, 144 halo rows for 120 outputs."""
    best = None
    for tw in range(1, min(wo, ENTRY_SLOT_ROWS - ENTRY_TILE_ROWS - 2) + 1):
        for th in range(1, min(ho, ENTRY_TILE_ROWS // (tw + 1)) + 1):
            if (th + 1) * (tw + 1) > ENTRY_SLOT_ROWS:
                break
            nh, nw = -(-ho // th), -(-wo // tw)
            steps = ENTRY_CONV1_2_STEPS + ENTRY_CONV1_1_STEPS * \
                entry_halo_chunks(th, tw)
            key = (nh * nw * steps, nh * nw * (th + 1) * (tw + 1))
            if best is None or key < best[0]:
                best = (key, nh, nw)
    _, nh, nw = best
    return TilePlan(n, ho, wo, -(-ho // nh), -(-wo // nw))


def entry_recompute(plan: TilePlan) -> float:
    """H5's recompute share: the conv1_1 rows its tiles compute (each
    tile's (th + 1) × (tw + 1) halo, ragged tiles' rows past the grid
    included) over the conv1_1 pixels the level reads ((ho + 1) × (wo +
    1) an image), less one."""
    rows = plan.count * (plan.th + 1) * (plan.tw + 1)
    return rows / (plan.n * (plan.hx + 1) * (plan.wx + 1)) - 1.0


def strided_boxable(x: torch.Tensor) -> bool:
    """Whether TMA can box H3's space-to-depth view of x [N, H, W, C] (the
    5-D [N, H/2, 2, W/2, 2C], no copy): every byte stride of the view (the
    pixel pair 4C, the row parity 2WC, the packed row 4WC, the image
    2HWC) a multiple of 16, and x 16-byte aligned. Else the kernel
    gathers A (``strided_mode`` in csrc/strided_conv4x4s2.cu applies the
    same rule)."""
    _, h, w, c = x.shape
    strides = (4 * c, 2 * w * c, 4 * w * c, 2 * h * w * c)
    return all(s % 16 == 0 for s in strides) and x.data_ptr() % 16 == 0


def aligned(name: str, *ts: torch.Tensor) -> None:
    """Raise unless every tensor starts on 16 bytes (a TMA base)."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: operands must be 16-byte aligned (TMA)")
