"""The output tiles of the Hopper kernels on ``csrc/sm90_igemm.cuh`` (H1
and H2 forward, H6 dgrad).

Each kernel walks th × tw pixel rectangles of one image of its output
grid and reads its A operand as one TMA halo box per K block. The plan is
made here, once per shape, and handed to the kernel as (th, tw).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class TilePlan:
    """Output tiles of th × tw pixels of one image, row-major over [N,
    tiles_h, tiles_w]; tile t starts at ``origin(t)``. The kernel lays a
    tile out as th · (tw + 1) GEMM rows (one junk column per image row,
    so that every tap reads the same halo box shifted by whole rows) and
    walks the same map (``DgradTiles::origin``, ``FwdTiles::origin``)."""

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
def tile_plan(n: int, hx: int, wx: int, rows: int) -> TilePlan:
    """The tiles of an [n, hx, wx] output for a kernel tile of ``rows``
    GEMM rows: th · (tw + 1) <= rows, and the halo box of th + 1 rows and
    tw + 1 columns at most 256 a side (TMA's limit). The fewest tiles
    (each costs ``rows`` wgmma rows however many it fills), ties to the
    wider tile; then th and tw shrink to the least that keeps the count,
    so the tiles split the image evenly."""
    best = None
    for tw in range(1, min(wx, 255) + 1):
        th = min(rows // (tw + 1), hx, 255)
        if th == 0:
            break
        nh, nw = -(-hx // th), -(-wx // tw)
        if best is None or nh * nw <= best[0] * best[1]:
            best = (nh, nw)
    nh, nw = best
    return TilePlan(n, hx, wx, -(-hx // nh), -(-wx // nw))


def aligned(name: str, *ts: torch.Tensor) -> None:
    """Raise unless every tensor starts on 16 bytes (a TMA base)."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: operands must be 16-byte aligned (TMA)")
