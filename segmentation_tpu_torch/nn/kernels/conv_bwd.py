"""The backward of the packed 2×2 conv sites
(segmentation_tpu.nn.pallas.conv_flat_bwd).

  H6 packed_conv2x2_dgrad       dx of H1's conv: g [N,hg,wg,4O] and
                                w2 [2,2,4C,4O] → dx [N,hg+1,wg+1,4C]
     packed_conv2x2_dgrad_dual  (dxa, dxb) of H2's dual conv in one launch
                                (g read once for both); in training dxa
                                goes into the crop window of the skip's
                                gradient (``skip_shape``, ``offset``), whose
                                margin train_glue.crop_margin_zero zeros
  H9 packed_conv2x2_wgrad       dw [2,2,4C,4O] of H1's conv from x and the
                                masked cotangent in its zero-margined
                                buffer, read in place: the four taps from
                                one read of each, summed in f32
     packed_conv2x2_wgrad_dual  (dwa, dwb) of H2's dual conv in one launch,
                                the skip read in place through its crop

The wrappers launch ``csrc/packed_conv2x2_dgrad.cu`` and
``csrc/packed_conv2x2_wgrad.cu`` for a CUDA tensor, or raise; for a tensor
on the CPU they run the plain versions (conv2x2_wgrad and
conv2x2_wgrad_crop for H9: four products, one a tap, as the JAX package's
four XLA dots). Each launch adds one to ``launches[<name>]`` (H9's name
counts its single and dual launches, six a train step). Kernel operands:
bf16, 16-byte aligned, contiguous but for H6's g, which may be the [N, hg,
wg] window of the zero-margined buffer train_glue.relu_bias_grad writes
(its rows are then read through their pitch); g is the ReLU-masked
cotangent. H6's output tiles are pixel rectangles of one image, chosen by
``tiles.tile_plan``; H9's blocks and K split by ``tap_grad_plan``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

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
from segmentation_tpu_torch.nn.kernels.train_glue import crop_margin_zero
from segmentation_tpu_torch.nn.packing import crop_packed, uncrop_packed

NAMES = ("packed_conv2x2_dgrad", "packed_conv2x2_dgrad_dual")
WGRAD = "packed_conv2x2_wgrad"  # H9's launches, single and dual alike
launches = dict.fromkeys(NAMES + (WGRAD,), 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------------ plain versions
def packed_conv2x2_dgrad_plain(g, w2):
    """The transposed conv of g with w2 (HWIO), in g's dtype."""
    dx = F.conv_transpose2d(g.permute(0, 3, 1, 2),
                            w2.permute(3, 2, 0, 1).to(g.dtype))
    return dx.permute(0, 2, 3, 1).contiguous()


def packed_conv2x2_dgrad_dual_plain(g, wa, wb, *, skip_shape=None,
                                    offset=(0, 0)):
    dxa = packed_conv2x2_dgrad_plain(g, wa)
    if skip_shape is not None and tuple(skip_shape) != tuple(dxa.shape):
        dxa = uncrop_packed(dxa, skip_shape, offset)
    return dxa, packed_conv2x2_dgrad_plain(g, wb)


def conv2x2_wgrad(x, gp):
    """dw [2,2,4C,4O] of the 2×2 VALID conv of x [N,hp,wp,4C], for the
    cotangent in its zero-margined buffer gp [N,hp,wp,4O] (the real
    [N,hp-1,wp-1] and a zero last row and column,
    train_glue.relu_bias_grad's ``pad``): gp flattened to rows meets x
    flattened to rows and shifted by the tap, u·wp + v. A real g row never
    wraps; the last wp + 1 rows are margin and are dropped, so every
    shifted view stays inside x."""
    n, hp, wp, c4 = x.shape
    o4 = gp.shape[-1]
    if tuple(gp.shape) != (n, hp, wp, o4):
        raise ValueError(f"conv2x2_wgrad: the cotangent's buffer "
                         f"{tuple(gp.shape)} is not x's grid {(n, hp, wp)}")
    gf = gp.reshape(-1, o4)
    xf = x.reshape(-1, c4)
    t = gf.shape[0] - (wp + 1)
    taps = [_mm(xf[u * wp + v : u * wp + v + t].T, gf[:t])
            for u in range(2) for v in range(2)]
    return torch.stack(taps).reshape(2, 2, c4, o4).to(x.dtype)


def _mm(a, b):
    """a @ b summed at f32 or wider: bf16 operands on the card are summed
    and returned in f32 (cuBLAS's split-K partials too), rounded once by
    the caller's cast."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a @ b


def conv2x2_wgrad_crop(skip, gp, offset):
    """dwa [2,2,4C,4O] of a dual site's skip side, conv(crop(skip), wa):
    conv2x2_wgrad on a copy of the skip's crop at the unpacked ``offset``
    (even: a window of packed pixels; odd: a slot phase), the cotangent's
    zero-margined buffer gp [N,hp,wp,4O] giving the crop's grid (H9 reads
    the skip in place instead)."""
    n, hp, wp, o4 = gp.shape
    crop = crop_packed(skip, (n, hp, wp, skip.shape[-1]), offset)
    return conv2x2_wgrad(crop.contiguous(), gp)


def conv2x2_wgrad_dual_plain(skip, up, gp, *, offset=(0, 0)):
    """(dwa, dwb) of the dual conv(crop(skip), wa) + conv(up, wb): the
    skip's side through its crop at the unpacked ``offset``, up's on gp's
    grid."""
    return conv2x2_wgrad_crop(skip, gp, offset), conv2x2_wgrad(up, gp)


# ------------------------------------------------------------ tile plan
def tile_rows(c4: int, dual: bool) -> int:
    """The kernel's tile of output pixels (its wgmma rows) for 4C and the
    mode: 4C = 128 → 256, 4C = 256 → 128, dual 4C = 128 → 128 (over
    [wa | wb]), dual 4C = 256 → 64 (one consumer per half); 4C = 512 as
    4C = 256, in each of a pixel tile's two column tiles of 256 channels
    a side (``DgradTiles::c0``)."""
    ncols = min(c4, 256) * (2 if dual else 1)
    return {128: 256, 256: 128, 512: 64}[ncols]


# ------------------------------------------------------------ kernel wrapper
def _pitch(name, g):
    """(rows, cols) of the buffer g [N, hg, wg, 4O] is a window of: its
    channels and pixels dense, its rows and images at any pitch."""
    n, hg, wg, o4 = g.shape
    sn, sh, sw, sc = g.stride()
    if sc != 1 or sw != o4 or sh % o4 or sh // o4 < wg or (
            n > 1 and (sn % sh or sn // sh < hg)):
        raise ValueError(f"{name}: g {tuple(g.shape)} with strides "
                         f"{g.stride()} is not a window of a contiguous "
                         f"buffer")
    return (sn // sh if n > 1 else hg), sh // o4


def _dgrad(name, g, ws, skip_shape=None, offset=(0, 0)):
    n, hg, wg, o4 = g.shape
    c4 = ws[0].shape[2]
    dev = g.device
    if c4 not in (128, 256, 512) or o4 % 8 or min(n, hg, wg) < 1:
        raise ValueError(f"{name}: g {tuple(g.shape)}, 4C = {c4}; the "
                         f"kernel takes 4C = 128 or 256, or 512, and 4O "
                         f"% 8 == 0")
    if g.device != dev or g.dtype != torch.bfloat16:
        raise TypeError(f"{name}: g must be bf16 on {dev}")
    rows, cols = _pitch(name, g)
    for w in ws:
        _require(w, "w2", torch.bfloat16, (2, 2, c4, o4), dev)
    aligned(name, g, *ws)
    dual = len(ws) == 2
    shape = (n, hg + 1, wg + 1, c4)
    a_shape = shape if skip_shape is None else tuple(skip_shape)
    oh, ow = (int(v) for v in offset)
    if (a_shape[0] != n or a_shape[3] != c4 or oh < 0 or ow < 0
            or oh + 2 * shape[1] > 2 * a_shape[1]
            or ow + 2 * shape[2] > 2 * a_shape[2]):
        raise ValueError(f"{name}: the crop {offset} of {a_shape} does not "
                         f"cover dx {shape}")
    plan = tile_plan(n, hg + 1, wg + 1, tile_rows(c4, dual))
    outs = [torch.empty(a_shape, dtype=torch.bfloat16, device=dev)]
    if dual:
        outs.append(torch.empty(shape, dtype=torch.bfloat16, device=dev))
    if a_shape != shape:
        crop_margin_zero(outs[0], hg + 1, wg + 1, (oh, ow))
    with torch.cuda.device(dev):
        err = _build.library().seg_packed_conv2x2_dgrad(
            _ptr(g), _ptr(ws[0]), _ptr(ws[1]) if dual else None,
            _ptr(outs[0]), _ptr(outs[1]) if dual else None, n, hg, wg, o4,
            c4, plan.th, plan.tw, rows, cols, a_shape[1], a_shape[2], oh, ow,
            _stream(g),
        )
    _build.check(err, name)
    launches[name] += 1
    return outs


def packed_conv2x2_dgrad(g, w2):
    """H6: g [N,hg,wg,4O], w2 [2,2,4C,4O] → dx [N,hg+1,wg+1,4C]."""
    if _on_cpu(g):
        return packed_conv2x2_dgrad_plain(g, w2)
    return _dgrad("packed_conv2x2_dgrad", g, [w2])[0]


def packed_conv2x2_dgrad_dual(g, wa, wb, *, skip_shape=None, offset=(0, 0)):
    """H6 dual: (dxa, dxb) for the dual conv's two weights, one launch.
    With ``skip_shape`` [N,hpa,wpa,4C], dxa is the gradient of the skip
    that the dual read through its crop at the unpacked ``offset``: the
    window written by the kernel, zeros elsewhere."""
    if _on_cpu(g):
        return packed_conv2x2_dgrad_dual_plain(g, wa, wb,
                                               skip_shape=skip_shape,
                                               offset=offset)
    return tuple(_dgrad("packed_conv2x2_dgrad_dual", g, [wa, wb],
                        skip_shape, offset))


# ------------------------------------------------------------ H9 plan
# csrc/packed_conv2x2_wgrad.cu: a block's tile of dw (128 channels of x by
# 128 of g, kTile), the pixel rows of a K block (kKRows), and the 64
# channels of a TMA box
TAP_TILE = 128
TAP_K_ROWS = 128
TAP_CHUNK = 64


@dataclass(frozen=True)
class TapGradPlan:
    """H9's grid: ``splits`` K ranges × the two u taps × the 4C / 128 by
    4O / 128 tiles of dw, one block each (``blocks``), each block summing
    its range of every side in turn; side s walks ``k_blocks[s]`` K blocks,
    split t taking [t K / S, (t + 1) K / S) of them (``k_range``)."""

    row_tiles: int
    col_tiles: int
    k_blocks: Tuple[int, ...]
    splits: int

    @property
    def sides(self) -> int:
        return len(self.k_blocks)

    @property
    def blocks(self) -> int:
        return self.splits * 2 * self.row_tiles * self.col_tiles

    def k_range(self, side: int, split: int) -> Tuple[int, int]:
        k = self.k_blocks[side]
        return split * k // self.splits, (split + 1) * k // self.splits


def tap_k_blocks(n: int, hp: int, wp: int, crop: bool) -> int:
    """K blocks of one side on g's grid [n, hp, wp]: TAP_K_ROWS rows of the
    flattened grid (the margin's zero rows included), or, read through a
    crop, segments of TAP_K_ROWS columns of each real row of each image
    (hp − 1 rows of wp − 1 columns)."""
    if crop:
        return n * (hp - 1) * -(-(wp - 1) // TAP_K_ROWS)
    return -(-(n * hp * wp) // TAP_K_ROWS)


def tap_grad_plan(n: int, hp: int, wp: int, c4: int, o4: int,
                  crops: Tuple[bool, ...], sms: int = 132) -> TapGradPlan:
    """H9's grid for x's 4C and g's 4O channels on g's grid [n, hp, wp],
    one side a crop flag (``crops``: one, or the dual's two): the tiles of
    dw and as many K splits as fill the ``sms`` SMs once (at least one,
    and no more than a side's fewest K blocks). A dual's block sums both
    sides, so every block has the same work however the sides' speeds
    differ."""
    k_blocks = tuple(tap_k_blocks(n, hp, wp, c) for c in crops)
    units = 2 * (c4 // TAP_TILE) * (o4 // TAP_TILE)
    splits = max(1, min(sms // units, min(k_blocks)))
    return TapGradPlan(c4 // TAP_TILE, o4 // TAP_TILE, k_blocks, splits)


def crop_chunks(c4: int, offset) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """(di, dj, cc) of each 64 channels of the crop of a skip [.., 4C] at
    the unpacked ``offset`` (crop_packed's rule): channel chunk q of the
    crop's pixel (i, j) is 64 channels of the skip's packed pixel (i + di,
    j + dj) from channel cc. An even crop is one window; an odd one reads
    each slot (d, e) from slot ((oh + d) % 2, (ow + e) % 2) at ((oh + d) //
    2, (ow + e) // 2), which a chunk can only follow where a slot's C
    channels are whole chunks. None where they are not (C % 64 != 0 at an
    odd offset)."""
    oh, ow = (int(v) for v in offset)
    c, q = c4 // 4, c4 // TAP_CHUNK
    if oh % 2 == 0 and ow % 2 == 0:
        return ((oh // 2,) * q, (ow // 2,) * q,
                tuple(TAP_CHUNK * k for k in range(q)))
    if c % TAP_CHUNK:
        return None
    di, dj, cc = [], [], []
    for k in range(q):
        s, r = divmod(TAP_CHUNK * k, c)
        yy, xx = oh + (s >> 1), ow + (s & 1)
        di.append(yy // 2)
        dj.append(xx // 2)
        cc.append((2 * (yy % 2) + xx % 2) * c + r)
    return tuple(di), tuple(dj), tuple(cc)


# ------------------------------------------------------------ H9 wrapper
def tap_grad_operands(name, gp, xs, offset=(0, 0)):
    """H9's checks: gp [N,hp,wp,4O] the whole zero-margined buffer, xs the
    single site's x, or the dual's (skip, up), x and up on gp's grid, the
    skip [N,hpa,wpa,4C] covering its crop at the unpacked ``offset``; bf16,
    contiguous, 16-byte aligned, on one device; 4C and 4O multiples of 128
    up to 512; an odd crop's slots whole 64-channel chunks (the U-Net's odd
    crop is level 2's, C = 64 or 128). Returns the skip's ``crop_chunks``
    where the dual reads it through a crop, else None."""
    n, hp, wp, o4 = gp.shape
    x = xs[-1]
    c4 = x.shape[-1]
    dev = gp.device
    if (c4 % TAP_TILE or o4 % TAP_TILE or not 0 < c4 <= 512
            or not 0 < o4 <= 512 or n < 1 or min(hp, wp) < 2):
        raise ValueError(f"{name}: x [.., {c4}], g {tuple(gp.shape)}; the "
                         f"kernel takes 4C and 4O of 128, 256 or 512 and "
                         f"a grid of at least 2 × 2")
    _require(gp, "g", torch.bfloat16, (n, hp, wp, o4), dev)
    _require(x, "x", torch.bfloat16, (n, hp, wp, c4), dev)
    chunks = None
    if len(xs) == 2:
        skip = xs[0]
        _, hpa, wpa, _ = skip.shape
        _require(skip, "skip", torch.bfloat16, (n, hpa, wpa, c4), dev)
        oh, ow = (int(v) for v in offset)
        if (oh < 0 or ow < 0 or oh + 2 * hp > 2 * hpa
                or ow + 2 * wp > 2 * wpa):
            raise ValueError(f"{name}: the crop {offset} of "
                             f"{tuple(skip.shape)} does not cover "
                             f"{(n, hp, wp, c4)}")
        if (hpa, wpa, oh, ow) != (hp, wp, 0, 0):
            chunks = crop_chunks(c4, (oh, ow))
            if chunks is None:
                raise ValueError(f"{name}: the odd crop {offset} splits C = "
                                 f"{c4 // 4} channels a slot into 64-"
                                 f"channel boxes")
    aligned(name, gp, *xs)
    return chunks


def _tap_grad(name, gp, xs, offset=(0, 0)):
    chunks = tap_grad_operands(name, gp, xs, offset)
    n, hp, wp, o4 = gp.shape
    c4 = xs[0].shape[-1]
    dual = len(xs) == 2
    crops = (chunks is not None, False) if dual else (False,)
    dev = gp.device
    plan = tap_grad_plan(n, hp, wp, c4, o4, crops,
                         torch.cuda.get_device_properties(dev)
                         .multi_processor_count)
    part = torch.empty((plan.sides, plan.splits, 4, c4, o4),
                       dtype=torch.float32, device=dev)
    dw = torch.empty((plan.sides, 2, 2, c4, o4), dtype=torch.bfloat16,
                     device=dev)
    table = None
    if chunks is not None:
        flat = [v for run in chunks for v in run]
        table = (ctypes.c_int * len(flat))(*flat)
    _, hpa, wpa, _ = xs[0].shape
    with torch.cuda.device(dev):
        err = _build.library().seg_packed_tap_grad(
            _ptr(xs[0]), _ptr(xs[1]) if dual else None, _ptr(gp),
            _ptr(part), _ptr(dw), n, hp, wp, c4, o4, plan.splits, hpa, wpa,
            table, _stream(gp),
        )
    _build.check(err, name)
    launches[WGRAD] += 1
    return tuple(dw)


def packed_conv2x2_wgrad(x, gp):
    """H9: x [N,hp,wp,4C] and the masked cotangent's zero-margined buffer
    gp [N,hp,wp,4O] → dw [2,2,4C,4O] in x's dtype."""
    if _on_cpu(x):
        return conv2x2_wgrad(x, gp)
    return _tap_grad("packed_conv2x2_wgrad", gp, (x,))[0]


def packed_conv2x2_wgrad_dual(skip, up, gp, *, offset=(0, 0)):
    """H9 dual: (dwa, dwb) of conv(crop(skip), wa) + conv(up, wb) in one
    launch, the skip [N,hpa,wpa,4C] read in place through its crop at the
    unpacked ``offset``, up [N,hp,wp,4C] on gp's grid."""
    if _on_cpu(up):
        return conv2x2_wgrad_dual_plain(skip, up, gp, offset=offset)
    return _tap_grad("packed_conv2x2_wgrad_dual", gp, (skip, up), offset)
