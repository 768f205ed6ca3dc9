"""The output tiles of the Hopper kernels on ``csrc/sm90_igemm.cuh`` (the
bf16 forward of H1–H4, H6 dgrad), and TMA's rule on what it can box.

Each kernel walks th × tw pixel rectangles of one image of its output
grid and reads its A operand per K block as one TMA halo box (the four
taps' kernels), as boxes of the tile itself (H4) or gathered (H3's entry).
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
              step: int = 1) -> TilePlan:
    """The tiles of an [n, hx, wx] output for a kernel tile of ``rows``
    GEMM rows: th · (tw + halo) <= rows, tw a multiple of ``step``, and a
    box of th + halo rows and tw + halo columns at most 256 a side (TMA's
    limit). The fewest tiles (each costs ``rows`` wgmma rows however many
    it fills), ties to the wider tile; then th and tw shrink to the least
    that keeps the count, so the tiles split the image evenly."""
    best = None
    for tw in range(step, min(wx, 255) + step, step):
        th = min(rows // (tw + halo), hx, 256 - halo)
        if th == 0 or tw + halo > 256:
            break
        nh, nw = -(-hx // th), -(-wx // tw)
        if best is None or nh * nw <= best[0] * best[1]:
            best = (nh, nw)
    nh, nw = best
    tw = -(-(-(-wx // nw)) // step) * step
    return TilePlan(n, hx, wx, -(-hx // nh), tw)


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
