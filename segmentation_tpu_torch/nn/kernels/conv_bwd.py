"""The backward of the packed 2×2 conv sites
(segmentation_tpu.nn.pallas.conv_flat_bwd).

  H6 packed_conv2x2_dgrad       dx of H1's conv: g [N,hg,wg,4O] and
                                w2 [2,2,4C,4O] → dx [N,hg+1,wg+1,4C]
     packed_conv2x2_dgrad_dual  (dxa, dxb) of H2's dual conv in one launch
                                (g read once for both); in training dxa
                                goes into the crop window of the skip's
                                gradient (``skip_shape``, ``offset``), whose
                                margin train_glue.crop_margin_zero zeros
  conv2x2_wgrad                 dw, four torch.mm (a library product, as
                                the JAX package leaves it to XLA dots),
                                summed in f32, on the zero-margined
                                cotangent, read in place
  conv2x2_wgrad_crop            dwa of a dual site: conv2x2_wgrad on a
                                copy of the skip's crop, made for it alone

The dgrad wrapper launches ``csrc/packed_conv2x2_dgrad.cu`` for a CUDA
tensor, or raises; for a tensor on the CPU it runs the plain version. Each
launch adds one to ``launches[<name>]``. Kernel operands: bf16, 16-byte
aligned, contiguous but for g, which may be the [N, hg, wg] window of the
zero-margined buffer train_glue.relu_bias_grad writes (its rows are then
read through their pitch); g is the ReLU-masked cotangent. The kernel's
output tiles are pixel rectangles of one image, chosen by
``tiles.tile_plan``.
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
from segmentation_tpu_torch.nn.kernels.train_glue import crop_margin_zero
from segmentation_tpu_torch.nn.packing import crop_packed, uncrop_packed

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
    zero-margined buffer gp [N,hp,wp,4O] giving the crop's grid. The copy
    [N,hp,wp,4C] is the wgrad's operand alone: the forward (H2) and dgrad
    (H6) read the skip in place."""
    n, hp, wp, o4 = gp.shape
    crop = crop_packed(skip, (n, hp, wp, skip.shape[-1]), offset)
    return conv2x2_wgrad(crop.contiguous(), gp)


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

