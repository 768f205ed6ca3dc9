"""The int8 path's kernels: int8 modes of H1–H4, the fused level-1 chain H5,
and the int8 3×3 conv of the standard levels.

As in conv_flat.py, each op has a wrapper and a plain PyTorch version of
the same function; the wrapper launches its CUDA kernel for a CUDA tensor,
or raises, and runs the plain version for a tensor on the CPU. Each launch
adds one to ``launches[<name>]``.

  H1 packed_conv2x2_s8      s8 2×2 packed conv (+ slot-max pool, + mask head)
  H2 packed_conv2x2_dual_s8 s8 dual decoder conv, one s32 accumulator a side
  H3 strided_conv4x4s2_s8   s8 4×4/2 conv, unpacked → packed
  H4 rows_matmul_s8         s8 per-pixel [C] → [4O], identity or slot scatter
  H5 entry_chain            level 1 in one launch: bf16 conv1_1 requantized
                            in shared memory, s8 conv1_2, slot-max pool

They replace the int8-resident modes of the Pallas kernels of
segmentation_tpu/nn/pallas/conv_flat.py and entry_chain_pf2 (:1644). The
products are exact (s8 × s8 summed in s32, or bf16 × bf16 in f32 for
conv1_1); every site ends in the epilogue of nn/pallas/conv.py
_epilogue_parts written as two per-channel f32 vectors,

    v = relu(acc · mul + add)          (two roundings: product, then sum)

with ``mul = chan_scale / out_scale`` and ``add = bias / out_scale`` at a
requantizing site (then round half to even, clip to ±127, s8) and ``mul =
chan_scale``, ``add = bias`` at a float site (then bf16). The dual mixes
its two accumulators first, ``acc_a · cs_a + acc_b · cs_b``, and applies
``mul = 1/out_scale`` to the mix. models/unet_int8.py computes the vectors
from the calibrated scales.

The plain versions compute the integer products in float64 (exact) and
the epilogue in f32 torch ops in the same order.

``conv3x3_s8`` is the standard levels' int8 VALID 3×3 conv, which the JAX
package leaves to XLA: on a CUDA tensor it runs im2col and cuBLASLt's s8
GEMM (``torch._int_mm``, s32 out), not a hand kernel; its plain version is
the float64 conv.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from segmentation_tpu_torch.nn.kernels import _build
from segmentation_tpu_torch.nn.kernels._build import (
    _on_cpu,
    _ptr,
    _require,
    _stream,
)
from segmentation_tpu_torch.nn.kernels.conv_flat import (
    _conv_nhwc,
    _head_mask,
    _o4_ok,
)
from segmentation_tpu_torch.nn.packing import crop_packed, unpack2

NAMES = ("entry_chain", "packed_conv2x2_s8", "packed_conv2x2_dual_s8",
         "strided_conv4x4s2_s8", "rows_matmul_s8")
launches = dict.fromkeys(NAMES, 0)
S8, BF16, F32 = torch.int8, torch.bfloat16, torch.float32


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------------ plain versions
def _int_conv(x, w_hwio, stride=1):
    """Exact integer conv of s8 (or bf16) NHWC operands, as float64."""
    return _conv_nhwc(x.double(), w_hwio.double(), stride)


def _finish(acc, mul, add, requant):
    """The int8 epilogue on an f32-convertible accumulator."""
    v = torch.relu(acc.float() * mul + add)
    if requant:
        return torch.clamp(torch.round(v), -127, 127).to(S8)
    return v.to(BF16)


def _slot_max(y):
    n, h, w, o4 = y.shape
    return y.reshape(n, h, w, 4, o4 // 4).amax(3)


def packed_conv2x2_s8_plain(x, wq, mul, add, *, requant=True, pool=False,
                            head=None, head_only=False):
    if head_only and head is None:
        raise ValueError("head_only needs head=(wd, bd)")
    y = _finish(_int_conv(x, wq), mul, add, requant)
    outs = [] if head_only else [y]
    if head is not None:
        outs.append(_head_mask(y, head))
    if pool:
        outs.append(_slot_max(y))
    return outs[0] if len(outs) == 1 else tuple(outs)


def packed_conv2x2_dual_s8_plain(skip, up, wqa, wqb, cs_a, cs_b, mul, add,
                                 *, offset):
    acc_a = _int_conv(crop_packed(skip, up.shape, offset), wqa).float()
    acc_b = _int_conv(up, wqb).float()
    return _finish(acc_a * cs_a + acc_b * cs_b, mul, add, True)


def strided_conv4x4s2_s8_plain(x, wq4, mul, add):
    return _finish(_int_conv(x, wq4, 2), mul, add, True)


def rows_matmul_s8_plain(x, wqm, mul, add, *, scatter=False):
    if scatter:
        n, i, j, c4 = x.shape
        x = unpack2(x.reshape(n, i, j, 4, c4 // 4))
    return _finish(x.double() @ wqm.double(), mul, add, True)


def entry_chain_plain(x, w4, mul1, add1, wq2, mul2, add2):
    q1 = _finish(_int_conv(x, w4, 2), mul1, add1, True)
    y = _finish(_int_conv(q1, wq2), mul2, add2, True)
    return y, _slot_max(y)


def conv3x3_s8_plain(x, wq):
    """s8 [N,H,W,C] ⊛ s8 [3,3,C,O] VALID → exact s32 [N,H-2,W-2,O]."""
    return _int_conv(x, wq).to(torch.int32)


# ------------------------------------------------------------ kernel wrappers
def _vec(t, name, o4, dev):
    _require(t, name, F32, (o4,), dev)


def packed_conv2x2_s8(x, wq, mul, add, *, requant=True, pool=False,
                      head=None, head_only=False):
    """H1 int8: x s8 [N,hp,wp,4C], wq s8 [2,2,4C,4O], mul/add f32 [4O] →
    y [N,hp-1,wp-1,4O], s8 (``requant``) or bf16; with ``pool`` also the
    slot-max [..,O] of y; with ``head=(wd bf16 [4O,4], bd f32 [4])`` (a
    float site) also the u8 mask; ``head_only`` returns the mask alone.
    Outputs in the order (y, mask, pooled)."""
    if _on_cpu(x):
        return packed_conv2x2_s8_plain(x, wq, mul, add, requant=requant,
                                       pool=pool, head=head,
                                       head_only=head_only)
    if head_only and head is None:
        raise ValueError("head_only needs head=(wd, bd)")
    if requant and head is not None:
        raise ValueError("packed_conv2x2_s8: the head needs a float site")
    n, hp, wp, c4 = x.shape
    o4 = wq.shape[-1]
    dev = x.device
    _o4_ok(o4, "packed_conv2x2_s8")
    if c4 % 16 or hp < 2 or wp < 2:
        raise ValueError(f"packed_conv2x2_s8: bad input shape "
                         f"{tuple(x.shape)}")
    _require(x, "x", S8, x.shape, dev)
    _require(wq, "wq", S8, (2, 2, c4, o4), dev)
    _vec(mul, "mul", o4, dev)
    _vec(add, "add", o4, dev)
    out_t = S8 if requant else BF16
    wd = bd = mask = pooled = y = None
    shp = (n, hp - 1, wp - 1)
    if head is not None:
        wd, bd = head
        _require(wd, "wd", BF16, (o4, 4), dev)
        _require(bd, "bd", F32, (4,), dev)
        mask = torch.empty(shp + (4,), dtype=torch.uint8, device=dev)
    if not head_only:
        y = torch.empty(shp + (o4,), dtype=out_t, device=dev)
    if pool:
        pooled = torch.empty(shp + (o4 // 4,), dtype=out_t, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_packed_conv2x2_s8(
            _ptr(x), _ptr(wq), _ptr(mul), _ptr(add), _ptr(y), _ptr(pooled),
            _ptr(wd), _ptr(bd), _ptr(mask), n, hp, wp, c4, o4, int(requant),
            _stream(x),
        )
    _build.check(err, "packed_conv2x2_s8")
    launches["packed_conv2x2_s8"] += 1
    outs = [t for t in (y, mask, pooled) if t is not None]
    return outs[0] if len(outs) == 1 else tuple(outs)


def packed_conv2x2_dual_s8(skip, up, wqa, wqb, cs_a, cs_b, mul, add, *,
                           offset):
    """H2 int8: skip s8 [N,hpa,wpa,4C], up s8 [N,hp,wp,4C] → s8
    [N,hp-1,wp-1,4O] = requant(relu((conv(crop(skip), wqa)·cs_a +
    conv(up, wqb)·cs_b)·mul + add)), the skip cropped at the UNPACKED
    ``offset`` (even: a packed slice; odd: a slot phase)."""
    if _on_cpu(up):
        return packed_conv2x2_dual_s8_plain(skip, up, wqa, wqb, cs_a, cs_b,
                                            mul, add, offset=offset)
    n, hp, wp, c4 = up.shape
    _, hpa, wpa, _ = skip.shape
    o4 = wqa.shape[-1]
    oh, ow = (int(v) for v in offset)
    dev = up.device
    _o4_ok(o4, "packed_conv2x2_dual_s8")
    if c4 % 64 or hp < 2 or wp < 2:
        raise ValueError(
            f"packed_conv2x2_dual_s8: bad input shape {tuple(up.shape)}")
    if oh < 0 or ow < 0 or oh + 2 * hp > 2 * hpa or ow + 2 * wp > 2 * wpa:
        raise ValueError(f"packed_conv2x2_dual_s8: crop {offset} of "
                         f"{tuple(skip.shape)} does not cover "
                         f"{tuple(up.shape)}")
    _require(up, "up", S8, up.shape, dev)
    _require(skip, "skip", S8, (n, hpa, wpa, c4), dev)
    _require(wqa, "wqa", S8, (2, 2, c4, o4), dev)
    _require(wqb, "wqb", S8, (2, 2, c4, o4), dev)
    for t, name in ((cs_a, "cs_a"), (cs_b, "cs_b"), (mul, "mul"),
                    (add, "add")):
        _vec(t, name, o4, dev)
    y = torch.empty((n, hp - 1, wp - 1, o4), dtype=S8, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_packed_conv2x2_dual_s8(
            _ptr(skip), _ptr(up), _ptr(wqa), _ptr(wqb), _ptr(cs_a),
            _ptr(cs_b), _ptr(mul), _ptr(add), _ptr(y), n, hpa, wpa, hp, wp,
            c4, o4, oh, ow, _stream(up),
        )
    _build.check(err, "packed_conv2x2_dual_s8")
    launches["packed_conv2x2_dual_s8"] += 1
    return y


def strided_conv4x4s2_s8(x, wq4, mul, add):
    """H3 int8: x s8 [N,H,W,C] (C % 16 == 0), wq4 s8 [4,4,C,4O] → s8
    packed [N,(H-2)//2,(W-2)//2,4O]."""
    if _on_cpu(x):
        return strided_conv4x4s2_s8_plain(x, wq4, mul, add)
    n, h, w, c = x.shape
    o4 = wq4.shape[-1]
    dev = x.device
    _o4_ok(o4, "strided_conv4x4s2_s8")
    if h < 4 or w < 4 or c % 16:
        raise ValueError(f"strided_conv4x4s2_s8: bad input shape "
                         f"{tuple(x.shape)}")
    _require(x, "x", S8, x.shape, dev)
    _require(wq4, "wq4", S8, (4, 4, c, o4), dev)
    _vec(mul, "mul", o4, dev)
    _vec(add, "add", o4, dev)
    y = torch.empty((n, (h - 2) // 2, (w - 2) // 2, o4), dtype=S8,
                    device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_strided_conv4x4s2_s8(
            _ptr(x), _ptr(wq4), _ptr(mul), _ptr(add), _ptr(y), n, h, w, c,
            o4, _stream(x),
        )
    _build.check(err, "strided_conv4x4s2_s8")
    launches["strided_conv4x4s2_s8"] += 1
    return y


def rows_matmul_s8(x, wqm, mul, add, *, scatter=False):
    """H4 int8: per-pixel x @ wqm [C, 4O], s8 in and out. Identity: x
    [N,H,W,C] → [N,H,W,4O]. Scatter: x packed [N,i,j,4C] → [N,2i,2j,4O]."""
    if _on_cpu(x):
        return rows_matmul_s8_plain(x, wqm, mul, add, scatter=scatter)
    n, hi, wi, cx = x.shape
    c, o4 = wqm.shape
    dev = x.device
    _o4_ok(o4, "rows_matmul_s8")
    ho, wo = (2 * hi, 2 * wi) if scatter else (hi, wi)
    if cx != (4 * c if scatter else c) or c % 16:
        raise ValueError(f"rows_matmul_s8: x {tuple(x.shape)} vs wqm "
                         f"{tuple(wqm.shape)} (scatter={scatter})")
    _require(x, "x", S8, x.shape, dev)
    _require(wqm, "wqm", S8, (c, o4), dev)
    _vec(mul, "mul", o4, dev)
    _vec(add, "add", o4, dev)
    y = torch.empty((n, ho, wo, o4), dtype=S8, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_rows_matmul_s8(
            _ptr(x), _ptr(wqm), _ptr(mul), _ptr(add), _ptr(y), n, ho, wo, c,
            o4, int(scatter), _stream(x),
        )
    _build.check(err, "rows_matmul_s8")
    launches["rows_matmul_s8"] += 1
    return y


def entry_chain(x, w4, mul1, add1, wq2, mul2, add2):
    """H5: x bf16 [N,H,W,3] → (y s8 [N,h1-1,w1-1,128], pooled s8
    [N,h1-1,w1-1,32]), h1 = (H-2)//2: conv1_1 (w4 bf16 [4,4,3,128], f32
    accumulation, requant by mul1/add1), conv1_2 (wq2 s8 [2,2,128,128],
    requant by mul2/add2) and the slot-max pool in one launch."""
    if _on_cpu(x):
        return entry_chain_plain(x, w4, mul1, add1, wq2, mul2, add2)
    n, h, w, c = x.shape
    dev = x.device
    h1, w1 = (h - 2) // 2, (w - 2) // 2
    if c != 3 or h1 < 2 or w1 < 2:
        raise ValueError(f"entry_chain: bad input shape {tuple(x.shape)}")
    _require(x, "x", BF16, x.shape, dev)
    _require(w4, "w4", BF16, (4, 4, 3, 128), dev)
    _require(wq2, "wq2", S8, (2, 2, 128, 128), dev)
    for t, name in ((mul1, "mul1"), (add1, "add1"), (mul2, "mul2"),
                    (add2, "add2")):
        _vec(t, name, 128, dev)
    y = torch.empty((n, h1 - 1, w1 - 1, 128), dtype=S8, device=dev)
    pooled = torch.empty((n, h1 - 1, w1 - 1, 32), dtype=S8, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_entry_chain(
            _ptr(x), _ptr(w4), _ptr(mul1), _ptr(add1), _ptr(wq2),
            _ptr(mul2), _ptr(add2), _ptr(y), _ptr(pooled), n, h, w,
            _stream(x),
        )
    _build.check(err, "entry_chain")
    launches["entry_chain"] += 1
    return y, pooled


def conv3x3_s8(x, wq):
    """The standard levels' s8 3×3 VALID conv → s32. CUDA: im2col +
    cuBLASLt s8 GEMM (torch._int_mm; K = 9C and O must be multiples of 8,
    more than 16 output pixels)."""
    if _on_cpu(x):
        return conv3x3_s8_plain(x, wq)
    n, h, w, c = x.shape
    o = wq.shape[-1]
    if x.dtype != S8 or wq.dtype != S8 or tuple(wq.shape) != (3, 3, c, o):
        raise TypeError(f"conv3x3_s8: x {x.dtype} {tuple(x.shape)}, wq "
                        f"{wq.dtype} {tuple(wq.shape)}")
    cols = x.unfold(1, 3, 1).unfold(2, 3, 1)  # [N, H-2, W-2, C, 3, 3]
    a = cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, 9 * c)
    acc = torch._int_mm(a, wq.reshape(9 * c, o))
    return acc.reshape(n, h - 2, w - 2, o)


class Int8Ops(NamedTuple):
    """The ops the int8 forward runs through."""

    entry_chain: Callable
    packed_conv2x2: Callable
    packed_conv2x2_dual: Callable
    strided_conv4x4s2: Callable
    rows_matmul: Callable
    conv3x3: Callable


KERNEL_OPS = Int8Ops(entry_chain, packed_conv2x2_s8, packed_conv2x2_dual_s8,
                     strided_conv4x4s2_s8, rows_matmul_s8, conv3x3_s8)
PLAIN_OPS = Int8Ops(entry_chain_plain, packed_conv2x2_s8_plain,
                    packed_conv2x2_dual_s8_plain, strided_conv4x4s2_s8_plain,
                    rows_matmul_s8_plain, conv3x3_s8_plain)

