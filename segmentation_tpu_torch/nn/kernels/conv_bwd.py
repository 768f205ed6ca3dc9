"""The backward of the packed 2×2 conv sites
(segmentation_tpu.nn.pallas.conv_flat_bwd).

  H6 packed_conv2x2_dgrad       dx of H1's conv: g [N,hg,wg,4O] and
                                w2 [2,2,4C,4O] → dx [N,hg+1,wg+1,4C]
     packed_conv2x2_dgrad_dual  (dxa, dxb) of H2's dual conv in one launch
                                (g read once for both)
  conv2x2_wgrad                 dw, four torch.matmuls (a library product,
                                as the JAX package leaves it to XLA dots)
  bias_grad                     db, an f32 sum

The dgrad wrapper launches ``csrc/packed_conv2x2_dgrad.cu`` for a CUDA
tensor, or raises; for a tensor on the CPU it runs the plain version. Each
launch adds one to ``launches[<name>]``. Kernel operands: bf16, contiguous,
16-byte aligned; g is the ReLU-masked cotangent. The kernel's output tiles
are pixel rectangles of one image, chosen by ``tiles.tile_plan``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from segmentation_tpu_torch.nn.kernels import _build
from segmentation_tpu_torch.nn.kernels._build import (
    _on_cpu,
    _ptr,
    _require,
    _stream,
)
from segmentation_tpu_torch.nn.kernels.tiles import aligned, tile_plan

NAMES = ("packed_conv2x2_dgrad", "packed_conv2x2_dgrad_dual")
launches = dict.fromkeys(NAMES, 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------------ plain versions
def packed_conv2x2_dgrad_plain(g, w2):
    """The transposed conv of g with w2 (HWIO), in g's dtype."""
    dx = F.conv_transpose2d(g.permute(0, 3, 1, 2),
                            w2.permute(3, 2, 0, 1).to(g.dtype))
    return dx.permute(0, 2, 3, 1).contiguous()


def packed_conv2x2_dgrad_dual_plain(g, wa, wb):
    return packed_conv2x2_dgrad_plain(g, wa), packed_conv2x2_dgrad_plain(g, wb)


def conv2x2_wgrad(x, g):
    """dw [2,2,4C,4O] of the 2×2 VALID conv of x [N,hp,wp,4C], for the
    cotangent g [N,hp-1,wp-1,4O]: g zero-padded to [N,hp,wp,4O] and
    flattened to rows meets x flattened to rows and shifted by the tap,
    u·wp + v. A real g row never wraps; the last wp + 1 rows are padding
    and are dropped, so every shifted view stays inside x."""
    n, hp, wp, c4 = x.shape
    o4 = g.shape[-1]
    gp = F.pad(g, (0, 0, 0, 1, 0, 1)).reshape(-1, o4)
    xf = x.reshape(-1, c4)
    t = gp.shape[0] - (wp + 1)
    taps = [xf[u * wp + v : u * wp + v + t].T @ gp[:t]
            for u in range(2) for v in range(2)]
    return torch.stack(taps).reshape(2, 2, c4, o4)


def bias_grad(g):
    return g.sum((0, 1, 2), dtype=torch.float32)


# ------------------------------------------------------------ tile plan
def tile_rows(c4: int, dual: bool) -> int:
    """The kernel's tile of output pixels (its wgmma rows) for 4C and the
    mode: 4C = 128 → 256, 4C = 256 → 128, dual 4C = 128 → 128 (over
    [wa | wb]), dual 4C = 256 → 64 (one consumer per half)."""
    ncols = c4 * (2 if dual else 1)
    return {128: 256, 256: 128, 512: 64}[ncols]


# ------------------------------------------------------------ kernel wrapper
def _dgrad(name, g, ws):
    n, hg, wg, o4 = g.shape
    c4 = ws[0].shape[2]
    dev = g.device
    if c4 not in (128, 256) or o4 % 8 or min(n, hg, wg) < 1:
        raise ValueError(f"{name}: g {tuple(g.shape)}, 4C = {c4}; the "
                         f"kernel takes 4C = 128 or 256 and 4O % 8 == 0")
    _require(g, "g", torch.bfloat16, g.shape, dev)
    for w in ws:
        _require(w, "w2", torch.bfloat16, (2, 2, c4, o4), dev)
    aligned(name, g, *ws)
    dual = len(ws) == 2
    plan = tile_plan(n, hg + 1, wg + 1, tile_rows(c4, dual))
    outs = [torch.empty((n, hg + 1, wg + 1, c4), dtype=torch.bfloat16,
                        device=dev) for _ in ws]
    with torch.cuda.device(dev):
        err = _build.library().seg_packed_conv2x2_dgrad(
            _ptr(g), _ptr(ws[0]), _ptr(ws[1]) if dual else None,
            _ptr(outs[0]), _ptr(outs[1]) if dual else None, n, hg, wg, o4,
            c4, plan.th, plan.tw, _stream(g),
        )
    _build.check(err, name)
    launches[name] += 1
    return outs


def packed_conv2x2_dgrad(g, w2):
    """H6: g [N,hg,wg,4O], w2 [2,2,4C,4O] → dx [N,hg+1,wg+1,4C]."""
    if _on_cpu(g):
        return packed_conv2x2_dgrad_plain(g, w2)
    return _dgrad("packed_conv2x2_dgrad", g, [w2])[0]


def packed_conv2x2_dgrad_dual(g, wa, wb):
    """H6 dual: (dxa, dxb) for the dual conv's two weights, one launch."""
    if _on_cpu(g):
        return packed_conv2x2_dgrad_dual_plain(g, wa, wb)
    return tuple(_dgrad("packed_conv2x2_dgrad_dual", g, [wa, wb]))

