"""The int8 path's kernels: int8 modes of H1–H4, the fused level-1 chain H5,
the image entry's two int8 modes, and H8, the int8 3×3 conv of the
standard levels (single and dual).

As in conv_flat.py, each op has a wrapper and a plain PyTorch version of
the same function; the wrapper launches its CUDA kernel for a CUDA tensor,
or raises, and runs the plain version for a tensor on the CPU. Each launch
adds one to ``launches[<mode>]``, the count of its kernel mode (``NAMES``).

  H1 packed_conv2x2_s8      s8 2×2 packed conv (+ slot-max pool, + mask head)
  H2 packed_conv2x2_dual_s8 s8 dual decoder conv, one s32 accumulator a side
  H3 strided_conv4x4s2_s8   s8 4×4/2 conv, unpacked → packed
  H4 rows_matmul_s8         s8 per-pixel [C] → [4O], identity or slot scatter
  H5 entry_chain            level 1 in one launch: bf16 conv1_1 requantized
                            in shared memory, s8 conv1_2, slot-max pool
  H3 conv3entry_requant     the C = 3 image entry, bf16 product, s8 out
  H3 conv3entry_s8          the C = 3 image entry on s8 image codes
  H8 std_conv3x3_s8         s8 3×3 VALID conv of the standard levels, its
                            epilogue fused (requant to s8, or bf16)
  H8 std_conv3x3_dual_s8    the standard decoder's concat-free dual conv
                            (skip cropped in its loads; a bf16 side
                            quantized by the division as it is gathered)

Every s8 operand of H1–H4 is s8 codes (int8-resident), or a bf16 tensor
that the kernel quantizes as it loads it, given its scale (``act_scale``;
the dual's ``act_scale_a`` / ``act_scale_b``): the inline-quantize modes,
``quant_inline``, bit-equal to nn/pallas/conv.py _quant_rows (a multiply
by f32(1/act_scale)). H8's bf16 sides are quantized by ``quant_act``, the
XLA-side rule of the JAX package's std levels (a true division by
f32(act_scale)): another function. A bf16 operand without its scale
raises.

Every kernel mode runs on the Hopper mainloop (csrc/sm90_igemm.cuh with
csrc/packed_conv2x2_fwd.cuh's output side, or H8's own in
csrc/std_conv3x3_s8.cu: TMA halo boxes or operands gathered by the
producer warpgroup, s8 wgmma). s8 wgmma reads B K-major only, so the
wrappers take the K-major copy of each s8 weight beside it (``wk``:
``k_major(wq)``, the duals' ``wka`` / ``wkb``, H5's conv1_2 ``wk``; H3's
``wk4``: ``strided_k_major(wq4)``; H4's ``wkm``: ``k_major(wqm)``), made
once where the int8 weights are planned (models/unet_int8.py
``UNetS2DInt8.plan``); a CUDA call without it raises. The plain versions
take the same arguments and ignore the copy, so ``Int8Ops`` swaps the two
paths whole. Their output tiles are planned here (``tiles.tile_plan``;
H5's ``tiles.entry_tile_plan``; H8's ``tiles.std_plan``).

They replace the int8 modes of the Pallas kernels of
segmentation_tpu/nn/pallas/conv_flat.py (entry_chain_pf2 :1644,
conv3entry_pf2 :1738) and nn/pallas/conv.py. The products are exact (s8 ×
s8 summed in s32, or bf16 × bf16 in f32 for conv1_1); every site ends in
the epilogue of nn/pallas/conv.py _epilogue_parts written as two
per-channel f32 vectors,

    v = relu(acc · mul + add)          (two roundings: product, then sum)

with ``mul = chan_scale / out_scale`` and ``add = bias / out_scale`` at a
requantizing site (then round half to even, clip to ±127, s8) and ``mul =
chan_scale``, ``add = bias`` at a float site (then bf16). The dual mixes
its two accumulators first, ``acc_a · cs_a + acc_b · cs_b``, and applies
``mul = 1/out_scale`` to the mix. models/unet_int8.py computes the vectors
from the calibrated scales.

The plain versions compute the integer products in float64 (exact) and
the epilogue in f32 torch ops in the same order.

H8 replaces no Pallas kernel: the JAX package leaves the standard levels'
int8 3×3 conv to XLA (segmentation_tpu/models/unet_int8.py int8_conv :72,
int8_std_dual_conv :104), and PyTorch has no s8 conv on CUDA. Its plain
versions are those functions' arithmetic (models/unet_int8.py calls them
through ``Int8Ops``): the single's epilogue is the one above with ``mul =
f32(f32(w_scale · act_scale) / out_scale)``, ``add = f32(bias /
out_scale)`` (``mul = w_scale · act_scale``, ``add = bias`` at a float
site), computed on the host (``std_affine``); the dual rounds the skip's
partial to bf16, adds the up side's and the bias, and divides by
out_scale.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from segmentation_tpu_torch.nn.kernels import _build
from segmentation_tpu_torch.nn.kernels._build import (
    _on_cpu,
    _ptr,
    _require,
    _stream,
)
from segmentation_tpu_torch.nn.kernels.conv_flat import (
    FWD_TILE_ROWS,
    _conv_nhwc,
    _head_mask,
    _o4_ok,
)
from segmentation_tpu_torch.nn.kernels.tiles import (
    aligned,
    entry_tile_plan,
    std_plan,
    tile_plan,
)
from segmentation_tpu_torch.nn.packing import crop_packed, unpack2

# 4O of the s8 modes of H1–H4 (no column tiles: 4O = 512 is bf16 only)
O4_S8 = (128, 256)

# the kernel modes, each with its launch count: resident s8 operands, the
# pool of H1, the inline-quantize modes, the image entry's modes
NAMES = ("entry_chain", "packed_conv2x2_s8", "packed_conv2x2_s8_pool",
         "packed_conv2x2_s8_inline", "packed_conv2x2_dual_s8",
         "packed_conv2x2_dual_s8_inline", "strided_conv4x4s2_s8",
         "strided_conv4x4s2_s8_inline", "rows_matmul_s8",
         "rows_matmul_s8_inline", "conv3entry_requant", "conv3entry_s8",
         "std_conv3x3_s8", "std_conv3x3_dual_s8",
         "std_conv3x3_dual_s8_inline")
launches = dict.fromkeys(NAMES, 0)
S8, BF16, F32 = torch.int8, torch.bfloat16, torch.float32


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def wrapper_of(mode: str) -> str:
    """The wrapper function that launches kernel mode ``mode``."""
    return mode.removesuffix("_pool").removesuffix("_inline")


# ------------------------------------------------------------ plain versions
def act_inverse(act_scale) -> float:
    """f32(1 / act_scale), the divide done on the host in float64 (as
    nn/pallas/conv.py _smem_scalar(1.0 / act_scale) does): the one value
    both the kernels and the plain versions multiply by."""
    return float(np.float32(1.0 / float(act_scale)))


def quant_inline(x: torch.Tensor, act_scale) -> torch.Tensor:
    """The in-kernel quantize (nn/pallas/conv.py _quant_rows): clip(round(
    f32(x) · f32(1/act_scale)), ±127) s8, round half to even. A multiply
    by the inverse, not a division: the two differ on some inputs."""
    q = torch.round(x.float() * act_inverse(act_scale))
    return torch.clamp(q, -127, 127).to(S8)


def f32_scale(scale) -> torch.Tensor:
    """A scale as a 0-d f32 host tensor (f32(scale))."""
    return torch.tensor(np.float32(float(scale)))


def quant_act(x: torch.Tensor, scale) -> torch.Tensor:
    """The XLA-side quantize of the JAX package's std levels
    (segmentation_tpu/models/unet_int8.py _quant_act): clip(round(f32(x) /
    f32(scale)), ±127) s8, round half to even. The division is by a tensor
    on x's device: ATen's CUDA division by a Python float multiplies by its
    reciprocal, which rounds some quotients to another integer."""
    q = torch.round(x.float() / f32_scale(scale).to(x.device))
    return torch.clamp(q, -127, 127).to(S8)


def std_affine(w_scale, act_scale, b, out_scale=None):
    """(mul, add) of the std single conv's epilogue relu(acc · mul + add),
    computed on the host in f32 as segmentation_tpu/models/unet_int8.py
    int8_conv computes them: mul = f32(w_scale · act_scale) / out_scale,
    add = b / out_scale (true f32 divisions) at a requantizing site; mul =
    w_scale · act_scale, add = b at a float site. f32 host tensors."""
    ws = w_scale.detach().to("cpu", F32)
    bias = b.detach().to("cpu", F32)
    cs = ws * f32_scale(act_scale)
    if out_scale is None:
        return cs, bias
    out = f32_scale(out_scale)
    return cs / out, bias / out


def std_dual_scales(wsa, sk_scale, wsb, asb):
    """(cs_a, cs_b) of the std dual conv: each side's weight scales times
    its activation scale, f32 host tensors (int8_std_dual_conv's sk_scale ·
    wsa and asb · wsb)."""
    return (wsa.detach().to("cpu", F32) * f32_scale(sk_scale),
            wsb.detach().to("cpu", F32) * f32_scale(asb))


def _check_operand(x, act_scale, name):
    """An s8 site's operand is s8 codes, or a float tensor with its
    act_scale."""
    if act_scale is None and x.dtype != S8:
        raise TypeError(f"{name}: a {x.dtype} operand needs its act_scale "
                        "(the inline-quantize mode)")
    if act_scale is not None and not x.dtype.is_floating_point:
        raise TypeError(f"{name}: act_scale given for a {x.dtype} operand")


def _codes(x, act_scale, name):
    """The s8 operand a kernel multiplies: x itself (s8 codes), or x
    quantized inline at ``act_scale``."""
    _check_operand(x, act_scale, name)
    return x if act_scale is None else quant_inline(x, act_scale)


def _int_conv(x, w_hwio, stride=1):
    """Exact integer conv of s8 (or bf16) NHWC operands, as float64."""
    return _conv_nhwc(x.double(), w_hwio.double(), stride)


def _requant(y):
    """Round half to even, clip to ±127, s8."""
    return torch.clamp(torch.round(y), -127.0, 127.0).to(S8)


def _finish(acc, mul, add, requant):
    """The int8 epilogue on an f32-convertible accumulator."""
    v = torch.relu(acc.float() * mul + add)
    return _requant(v) if requant else v.to(BF16)


def _slot_max(y):
    n, h, w, o4 = y.shape
    return y.reshape(n, h, w, 4, o4 // 4).amax(3)


def k_major(wq: torch.Tensor) -> torch.Tensor:
    """The K-major copy [4O, 4·4C] of a packed s8 weight wq [2, 2, 4C, 4O]
    (row o holds column o's K = tap · 4C + c values), which H1's and H2's
    s8 wgmma reads: ``wq.reshape(4·4C, 4O).T``, contiguous. The same of
    H8's [3, 3, C, O] ([O, 9C], tap = 3u + v) and of H4's wqm [C, 4O]
    ([4O, C])."""
    return wq.reshape(-1, wq.shape[-1]).t().contiguous()


def strided_k_width(c: int) -> int:
    """K of H3's s8 product for x with C channels (the width of
    ``strided_k_major``): four taps of ceil(2C / 64) K blocks of 128 bytes
    (C % 16 == 0), or one im2col row of 16C values (the C = 3 entry)."""
    if c % 16 == 0:
        return 4 * -(-2 * c // 64) * 128
    return 16 * c


def strided_k_major(wq4: torch.Tensor) -> torch.Tensor:
    """The K-major copy [4O, strided_k_width(C)] of H3's s8 weight wq4 [4,
    4, C, 4O] in the order its kernel gathers A (csrc/strided_conv4x4s2.cu).
    C % 16 == 0: one 128-byte row per space-to-depth pixel, row parity a
    major, then bc = b·C + c of the pixel pair; a K block holds 64 of the
    2C values bc of both parities, so row o holds, at (tap · kps + kb) ·
    128 + 64 a + r, w4[2u + a, 2v + b, c, o] for bc = 64 kb + r < 2C (tap
    = 2u + v, kps = ceil(2C / 64)) and 0 past 2C. Else (the C = 3 entry's
    im2col rows) ``wq4.reshape(16C, 4O).T``."""
    _, _, c, o4 = wq4.shape
    if c % 16:
        return wq4.reshape(16 * c, o4).t().contiguous()
    kps = -(-2 * c // 64)
    w = wq4.reshape(2, 2, 2, 2 * c, o4).permute(0, 2, 1, 3, 4)  # u v a bc
    w = torch.nn.functional.pad(w, (0, 0, 0, 64 * kps - 2 * c))
    w = w.reshape(2, 2, 2, kps, 64, o4).permute(0, 1, 3, 2, 4, 5)
    return w.reshape(-1, o4).t().contiguous()


def dual_tile_rows(o4: int) -> int:
    """GEMM rows of an output tile of H2's s8 mode (FwdOut::BM): its two
    s32 accumulators fit as m64n128 a side, the tile's rows split between
    the consumers at 4O = 128, its columns at 4O = 256 (64 rows)."""
    return FWD_TILE_ROWS if o4 == 128 else FWD_TILE_ROWS // 2


def packed_conv2x2_s8_plain(x, wq, mul, add, *, requant=True, pool=False,
                            head=None, head_only=False, act_scale=None,
                            wk=None):
    """H1 int8's plain version (``wk``, the kernel's K-major copy, is not
    read)."""
    if head_only and head is None:
        raise ValueError("head_only needs head=(wd, bd)")
    x = _codes(x, act_scale, "packed_conv2x2_s8")
    y = _finish(_int_conv(x, wq), mul, add, requant)
    outs = [] if head_only else [y]
    if head is not None:
        outs.append(_head_mask(y, head))
    if pool:
        outs.append(_slot_max(y))
    return outs[0] if len(outs) == 1 else tuple(outs)


def packed_conv2x2_dual_s8_plain(skip, up, wqa, wqb, cs_a, cs_b, mul, add,
                                 *, offset, act_scale_a=None,
                                 act_scale_b=None, wka=None, wkb=None):
    """H2 int8's plain version (``wka``, ``wkb``: not read)."""
    skip = _codes(skip, act_scale_a, "packed_conv2x2_dual_s8 skip")
    up = _codes(up, act_scale_b, "packed_conv2x2_dual_s8 up")
    acc_a = _int_conv(crop_packed(skip, up.shape, offset), wqa).float()
    acc_b = _int_conv(up, wqb).float()
    return _finish(acc_a * cs_a + acc_b * cs_b, mul, add, True)


def strided_conv4x4s2_s8_plain(x, wq4, mul, add, *, act_scale=None,
                               wk4=None):
    """H3 int8's plain version (``wk4``: not read)."""
    x = _codes(x, act_scale, "strided_conv4x4s2_s8")
    return _finish(_int_conv(x, wq4, 2), mul, add, True)


def conv3entry_requant_plain(x, w4, mul, add):
    if x.dtype != BF16:
        raise TypeError(f"conv3entry_requant: x is {x.dtype}, not bf16")
    return _finish(_int_conv(x, w4, 2), mul, add, True)


def conv3entry_s8_plain(x, wq4, mul, add, *, wk4=None):
    return strided_conv4x4s2_s8_plain(x, wq4, mul, add)


def rows_matmul_s8_plain(x, wqm, mul, add, *, scatter=False, act_scale=None,
                         wkm=None):
    """H4 int8's plain version (``wkm``: not read)."""
    x = _codes(x, act_scale, "rows_matmul_s8")
    if scatter:
        n, i, j, c4 = x.shape
        x = unpack2(x.reshape(n, i, j, 4, c4 // 4))
    return _finish(x.double() @ wqm.double(), mul, add, True)


def entry_chain_plain(x, w4, mul1, add1, wq2, mul2, add2, *, wk=None):
    """H5's plain version (``wk``: not read)."""
    q1 = _finish(_int_conv(x, w4, 2), mul1, add1, True)
    y = _finish(_int_conv(q1, wq2), mul2, add2, True)
    return y, _slot_max(y)


def conv3x3_s8_plain(x, wq):
    """s8 [N,H,W,C] ⊛ s8 [3,3,C,O] VALID → exact s32 [N,H-2,W-2,O]."""
    return _int_conv(x, wq).to(torch.int32)


def std_conv3x3_s8_plain(x, wq, mul, add, *, requant=True, wk=None):
    """H8's plain version: int8_conv's arithmetic (``wk``: not read)."""
    if x.dtype != S8:
        raise TypeError(f"std_conv3x3_s8: x is {x.dtype}, not s8 codes")
    return _finish(_int_conv(x, wq), mul, add, requant)


def std_conv3x3_dual_s8_plain(sk, up, wqa, wqb, cs_a, cs_b, b, *,
                              out_scale=None, offset=(0, 0),
                              act_scale_a=None, act_scale_b=None, wka=None,
                              wkb=None):
    """H8 dual's plain version: int8_std_dual_conv's arithmetic on the skip
    cropped at ``offset`` (``wka``, ``wkb``: not read). A bf16 side is
    quantized by ``quant_act`` at its act_scale."""
    _check_operand(sk, act_scale_a, "std_conv3x3_dual_s8 skip")
    _check_operand(up, act_scale_b, "std_conv3x3_dual_s8 up")
    oh, ow = offset
    sk = sk[:, oh : oh + up.shape[1], ow : ow + up.shape[2]]
    ska = sk if act_scale_a is None else quant_act(sk, act_scale_a)
    upq = up if act_scale_b is None else quant_act(up, act_scale_b)
    ya = (_int_conv(ska, wqa).float() * cs_a).to(BF16)
    y = ya.float() + _int_conv(upq, wqb).float() * cs_b + b.float()
    if out_scale is None:
        return torch.relu(y).to(BF16)
    return _requant(torch.relu(y / f32_scale(out_scale).to(y.device)))


# ------------------------------------------------------------ kernel wrappers
def _vec(t, name, o4, dev):
    _require(t, name, F32, (o4,), dev)


def _operand(t, name, shape, act_scale, dev):
    """Check an s8 kernel operand: s8 codes, or bf16 with its scale.
    Returns the kernel's inverse scale, 0 for codes."""
    _require(t, name, S8 if act_scale is None else BF16, shape, dev)
    return 0.0 if act_scale is None else act_inverse(act_scale)


def _k_major_operand(wk, name, k, o4, dev):
    """Check the K-major copy [O, K] an s8 wgmma kernel reads."""
    if wk is None:
        raise ValueError(f"{name}: a CUDA call needs the K-major weight "
                         f"copy (k_major, [{o4}, {k}] s8)")
    _require(wk, name, S8, (o4, k), dev)


def _mode(name, act_scale):
    """The launch count of a kernel mode: an inline-quantize launch counts
    under its kernel's ``_inline`` mode (H1's pool included)."""
    if act_scale is None:
        return name
    return f"{name.removesuffix('_pool')}_inline"


def packed_conv2x2_s8(x, wq, mul, add, *, requant=True, pool=False,
                      head=None, head_only=False, act_scale=None, wk=None):
    """H1 int8: x [N,hp,wp,4C] s8 codes, or bf16 quantized inline at
    ``act_scale``; wq s8 [2,2,4C,4O] and its K-major copy ``wk`` (CUDA),
    mul/add f32 [4O] → y [N,hp-1,wp-1,4O], s8 (``requant``) or bf16; with
    ``pool`` also the slot-max [..,O] of y; with ``head=(wd bf16 [4O,4],
    bd f32 [4])`` (a float site) also the u8 mask; ``head_only`` returns
    the mask alone. Outputs in the order (y, mask, pooled)."""
    _check_operand(x, act_scale, "packed_conv2x2_s8")
    if _on_cpu(x):
        return packed_conv2x2_s8_plain(x, wq, mul, add, requant=requant,
                                       pool=pool, head=head,
                                       head_only=head_only,
                                       act_scale=act_scale)
    if head_only and head is None:
        raise ValueError("head_only needs head=(wd, bd)")
    if requant and head is not None:
        raise ValueError("packed_conv2x2_s8: the head needs a float site")
    n, hp, wp, c4 = x.shape
    o4 = wq.shape[-1]
    dev = x.device
    _o4_ok(o4, "packed_conv2x2_s8", O4_S8)
    if c4 % 16 or hp < 2 or wp < 2:
        raise ValueError(f"packed_conv2x2_s8: bad input shape "
                         f"{tuple(x.shape)}")
    inv = _operand(x, "x", x.shape, act_scale, dev)
    _require(wq, "wq", S8, (2, 2, c4, o4), dev)
    _k_major_operand(wk, "wk", 4 * c4, o4, dev)
    _vec(mul, "mul", o4, dev)
    _vec(add, "add", o4, dev)
    aligned("packed_conv2x2_s8", x, wk, mul, add)
    out_t = S8 if requant else BF16
    wd = bd = mask = pooled = y = None
    shp = (n, hp - 1, wp - 1)
    if head is not None:
        wd, bd = head
        _require(wd, "wd", BF16, (o4, 4), dev)
        _require(bd, "bd", F32, (4,), dev)
        aligned("packed_conv2x2_s8", wd)
        mask = torch.empty(shp + (4,), dtype=torch.uint8, device=dev)
    if not head_only:
        y = torch.empty(shp + (o4,), dtype=out_t, device=dev)
    if pool:
        pooled = torch.empty(shp + (o4 // 4,), dtype=out_t, device=dev)
    plan = tile_plan(n, hp - 1, wp - 1, FWD_TILE_ROWS)
    with torch.cuda.device(dev):
        err = _build.library().seg_packed_conv2x2_s8(
            _ptr(x), _ptr(wk), _ptr(mul), _ptr(add), _ptr(y), _ptr(pooled),
            _ptr(wd), _ptr(bd), _ptr(mask), n, hp, wp, c4, o4, int(requant),
            inv, plan.th, plan.tw, _stream(x),
        )
    _build.check(err, "packed_conv2x2_s8")
    launches[_mode("packed_conv2x2_s8_pool" if pool else "packed_conv2x2_s8",
                   act_scale)] += 1
    outs = [t for t in (y, mask, pooled) if t is not None]
    return outs[0] if len(outs) == 1 else tuple(outs)


def packed_conv2x2_dual_s8(skip, up, wqa, wqb, cs_a, cs_b, mul, add, *,
                           offset, act_scale_a=None, act_scale_b=None,
                           wka=None, wkb=None):
    """H2 int8: skip [N,hpa,wpa,4C], up [N,hp,wp,4C] → s8
    [N,hp-1,wp-1,4O] = requant(relu((conv(crop(skip), wqa)·cs_a +
    conv(up, wqb)·cs_b)·mul + add)), the skip cropped at the UNPACKED
    ``offset`` (even: a packed slice; odd: a slot phase). Each side is s8
    codes, or bf16 quantized inline at ``act_scale_a`` / ``act_scale_b``
    (after the crop's gather, with which it commutes). A CUDA call takes
    the weights' K-major copies ``wka``, ``wkb`` too."""
    _check_operand(skip, act_scale_a, "packed_conv2x2_dual_s8 skip")
    _check_operand(up, act_scale_b, "packed_conv2x2_dual_s8 up")
    if _on_cpu(up):
        return packed_conv2x2_dual_s8_plain(
            skip, up, wqa, wqb, cs_a, cs_b, mul, add, offset=offset,
            act_scale_a=act_scale_a, act_scale_b=act_scale_b)
    n, hp, wp, c4 = up.shape
    _, hpa, wpa, _ = skip.shape
    o4 = wqa.shape[-1]
    oh, ow = (int(v) for v in offset)
    dev = up.device
    _o4_ok(o4, "packed_conv2x2_dual_s8", O4_S8)
    if c4 % 64 or hp < 2 or wp < 2:
        raise ValueError(
            f"packed_conv2x2_dual_s8: bad input shape {tuple(up.shape)}")
    if oh < 0 or ow < 0 or oh + 2 * hp > 2 * hpa or ow + 2 * wp > 2 * wpa:
        raise ValueError(f"packed_conv2x2_dual_s8: crop {offset} of "
                         f"{tuple(skip.shape)} does not cover "
                         f"{tuple(up.shape)}")
    inv_b = _operand(up, "up", up.shape, act_scale_b, dev)
    inv_a = _operand(skip, "skip", (n, hpa, wpa, c4), act_scale_a, dev)
    _require(wqa, "wqa", S8, (2, 2, c4, o4), dev)
    _require(wqb, "wqb", S8, (2, 2, c4, o4), dev)
    _k_major_operand(wka, "wka", 4 * c4, o4, dev)
    _k_major_operand(wkb, "wkb", 4 * c4, o4, dev)
    for t, name in ((cs_a, "cs_a"), (cs_b, "cs_b"), (mul, "mul"),
                    (add, "add")):
        _vec(t, name, o4, dev)
    aligned("packed_conv2x2_dual_s8", skip, up, wka, wkb, cs_a, cs_b, mul,
            add)
    y = torch.empty((n, hp - 1, wp - 1, o4), dtype=S8, device=dev)
    plan = tile_plan(n, hp - 1, wp - 1, dual_tile_rows(o4))
    with torch.cuda.device(dev):
        err = _build.library().seg_packed_conv2x2_dual_s8(
            _ptr(skip), _ptr(up), _ptr(wka), _ptr(wkb), _ptr(cs_a),
            _ptr(cs_b), _ptr(mul), _ptr(add), _ptr(y), n, hpa, wpa, hp, wp,
            c4, o4, oh, ow, inv_a, inv_b, plan.th, plan.tw, _stream(up),
        )
    _build.check(err, "packed_conv2x2_dual_s8")
    inline = act_scale_a is not None or act_scale_b is not None
    launches["packed_conv2x2_dual_s8_inline" if inline
             else "packed_conv2x2_dual_s8"] += 1
    return y


def strided_s8_plan(x):
    """H3 int8's output tiles for x [N, H, W, C]: four taps over the tile's
    halo of gathered space-to-depth pixels (C % 16 == 0), one tap over the
    tile's im2col rows (the C = 3 entry's modes)."""
    n, h, w, c = x.shape
    return tile_plan(n, (h - 2) // 2, (w - 2) // 2, FWD_TILE_ROWS,
                     halo=int(c % 16 == 0))


def _strided_s8(x, wq4, mul, add, act_scale, mode, wk4):
    """Launch H3's s8 mode (codes, bf16 quantized inline, or the entry's
    C = 3 codes) with the K-major copy ``wk4``."""
    n, h, w, c = x.shape
    o4 = wq4.shape[-1]
    dev = x.device
    _o4_ok(o4, mode, O4_S8)
    if h < 4 or w < 4:
        raise ValueError(f"{mode}: input {tuple(x.shape)} < 4x4")
    inv = _operand(x, "x", x.shape, act_scale, dev)
    _require(wq4, "wq4", S8, (4, 4, c, o4), dev)
    if wk4 is None:
        raise ValueError(f"{mode}: a CUDA call needs the K-major weight copy "
                         f"(strided_k_major(wq4), [{o4}, "
                         f"{strided_k_width(c)}] s8)")
    _require(wk4, "wk4", S8, (o4, strided_k_width(c)), dev)
    _vec(mul, "mul", o4, dev)
    _vec(add, "add", o4, dev)
    aligned(mode, wk4, mul, add, *([x] if c % 16 == 0 else []))
    y = torch.empty((n, (h - 2) // 2, (w - 2) // 2, o4), dtype=S8,
                    device=dev)
    plan = strided_s8_plan(x)
    with torch.cuda.device(dev):
        err = _build.library().seg_strided_conv4x4s2_s8(
            _ptr(x), _ptr(wk4), _ptr(mul), _ptr(add), _ptr(y), n, h, w, c,
            o4, inv, plan.th, plan.tw, _stream(x),
        )
    _build.check(err, mode)
    launches[mode] += 1
    return y


def strided_conv4x4s2_s8(x, wq4, mul, add, *, act_scale=None, wk4=None):
    """H3 int8: x [N,H,W,C] (C % 16 == 0) s8 codes, or bf16 quantized
    inline at ``act_scale``; wq4 s8 [4,4,C,4O] and its K-major copy
    ``wk4`` (CUDA) → s8 packed [N,(H-2)//2,(W-2)//2,4O]."""
    _check_operand(x, act_scale, "strided_conv4x4s2_s8")
    if _on_cpu(x):
        return strided_conv4x4s2_s8_plain(x, wq4, mul, add,
                                          act_scale=act_scale)
    if x.shape[-1] % 16:
        raise ValueError(f"strided_conv4x4s2_s8: C = {x.shape[-1]}, not a "
                         "multiple of 16")
    return _strided_s8(x, wq4, mul, add, act_scale,
                       _mode("strided_conv4x4s2_s8", act_scale), wk4)


def conv3entry_s8(x, wq4, mul, add, *, wk4=None):
    """H3's s8-input entry (conv3entry_pf2's int8-in mode, u8-native image
    serving): x s8 image codes [N,H,W,3], wq4 s8 [4,4,3,4O] (the
    s2d-folded taps) and its K-major copy ``wk4`` (CUDA), mul =
    chan_scale/out_scale, add = bias/out_scale → s8 packed
    [N,(H-2)//2,(W-2)//2,4O]; the 3-byte pixels are gathered."""
    if _on_cpu(x):
        return conv3entry_s8_plain(x, wq4, mul, add)
    if x.shape[-1] != 3:
        raise ValueError(f"conv3entry_s8: C = {x.shape[-1]}, not 3")
    return _strided_s8(x, wq4, mul, add, None, "conv3entry_s8", wk4)


def conv3entry_requant(x, w4, mul, add):
    """H3's requant-only entry (conv3entry_pf2's bf16 → s8 mode): x bf16
    [N,H,W,3], w4 bf16 [4,4,3,4O], f32 accumulation, then the int8
    epilogue relu(acc·mul + add) → s8 [N,(H-2)//2,(W-2)//2,4O]: with mul =
    1/out_scale, add = bias/out_scale, the codes of H5's conv1_1."""
    if _on_cpu(x):
        return conv3entry_requant_plain(x, w4, mul, add)
    n, h, w, c = x.shape
    o4 = w4.shape[-1]
    dev = x.device
    _o4_ok(o4, "conv3entry_requant", O4_S8)
    if c != 3 or h < 4 or w < 4:
        raise ValueError(f"conv3entry_requant: bad input shape "
                         f"{tuple(x.shape)}")
    _require(x, "x", BF16, x.shape, dev)
    _require(w4, "w4", BF16, (4, 4, c, o4), dev)
    _vec(mul, "mul", o4, dev)
    _vec(add, "add", o4, dev)
    aligned("conv3entry_requant", w4, mul, add)
    y = torch.empty((n, (h - 2) // 2, (w - 2) // 2, o4), dtype=S8,
                    device=dev)
    plan = strided_s8_plan(x)  # one tap over the tile: gathered
    with torch.cuda.device(dev):
        err = _build.library().seg_strided_conv4x4s2_requant(
            _ptr(x), _ptr(w4), _ptr(mul), _ptr(add), _ptr(y), n, h, w, c,
            o4, plan.th, plan.tw, _stream(x),
        )
    _build.check(err, "conv3entry_requant")
    launches["conv3entry_requant"] += 1
    return y


def rows_s8_plan(n, ho, wo):
    """H4 int8's output tiles: one tap over the tile (its rows boxed, or
    gathered for the scatter and the inline modes)."""
    return tile_plan(n, ho, wo, FWD_TILE_ROWS, halo=0)


def rows_matmul_s8(x, wqm, mul, add, *, scatter=False, act_scale=None,
                   wkm=None):
    """H4 int8: per-pixel x @ wqm [C, 4O], s8 out; x s8 codes, or bf16
    quantized inline at ``act_scale``; on CUDA with the K-major copy
    ``wkm = k_major(wqm)`` [4O, C]. Identity: x [N,H,W,C] → [N,H,W,4O].
    Scatter: x packed [N,i,j,4C] → [N,2i,2j,4O]."""
    _check_operand(x, act_scale, "rows_matmul_s8")
    if _on_cpu(x):
        return rows_matmul_s8_plain(x, wqm, mul, add, scatter=scatter,
                                    act_scale=act_scale)
    n, hi, wi, cx = x.shape
    c, o4 = wqm.shape
    dev = x.device
    _o4_ok(o4, "rows_matmul_s8", O4_S8)
    ho, wo = (2 * hi, 2 * wi) if scatter else (hi, wi)
    if cx != (4 * c if scatter else c) or c % 16:
        raise ValueError(f"rows_matmul_s8: x {tuple(x.shape)} vs wqm "
                         f"{tuple(wqm.shape)} (scatter={scatter})")
    inv = _operand(x, "x", x.shape, act_scale, dev)
    _require(wqm, "wqm", S8, (c, o4), dev)
    _k_major_operand(wkm, "wkm", c, o4, dev)
    _vec(mul, "mul", o4, dev)
    _vec(add, "add", o4, dev)
    aligned("rows_matmul_s8", x, wkm, mul, add)
    y = torch.empty((n, ho, wo, o4), dtype=S8, device=dev)
    plan = rows_s8_plan(n, ho, wo)
    with torch.cuda.device(dev):
        err = _build.library().seg_rows_matmul_s8(
            _ptr(x), _ptr(wkm), _ptr(mul), _ptr(add), _ptr(y), n, ho, wo, c,
            o4, int(scatter), inv, plan.th, plan.tw, _stream(x),
        )
    _build.check(err, "rows_matmul_s8")
    launches[_mode("rows_matmul_s8", act_scale)] += 1
    return y


def entry_chain(x, w4, mul1, add1, wq2, mul2, add2, *, wk=None):
    """H5: x bf16 [N,H,W,3] → (y s8 [N,h1-1,w1-1,128], pooled s8
    [N,h1-1,w1-1,32]), h1 = (H-2)//2: conv1_1 (w4 bf16 [4,4,3,128], f32
    accumulation, requant by mul1/add1), conv1_2 (wq2 s8 [2,2,128,128]
    and, on CUDA, its K-major copy ``wk = k_major(wq2)``, requant by
    mul2/add2) and the slot-max pool in one launch, tiled by
    ``tiles.entry_tile_plan``."""
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
    _k_major_operand(wk, "wk", 4 * 128, 128, dev)
    for t, name in ((mul1, "mul1"), (add1, "add1"), (mul2, "mul2"),
                    (add2, "add2")):
        _vec(t, name, 128, dev)
    aligned("entry_chain", w4, wk, mul1, add1, mul2, add2)
    y = torch.empty((n, h1 - 1, w1 - 1, 128), dtype=S8, device=dev)
    pooled = torch.empty((n, h1 - 1, w1 - 1, 32), dtype=S8, device=dev)
    plan = entry_tile_plan(n, h1 - 1, w1 - 1)
    with torch.cuda.device(dev):
        err = _build.library().seg_entry_chain(
            _ptr(x), _ptr(w4), _ptr(mul1), _ptr(add1), _ptr(wk),
            _ptr(mul2), _ptr(add2), _ptr(y), _ptr(pooled), n, h, w,
            plan.th, plan.tw, _stream(x),
        )
    _build.check(err, "entry_chain")
    launches["entry_chain"] += 1
    return y, pooled


def _std_shape_ok(name, x, c, o):
    n, h, w, cx = x.shape
    if cx != c or c % 16 or o % 128 or h < 3 or w < 3:
        raise ValueError(f"{name}: bad input shape {tuple(x.shape)} "
                         f"(C % 16 == 0) for O = {o} (O % 128 == 0)")


def std_conv3x3_s8(x, wq, mul, add, *, requant=True, wk=None):
    """H8: the std levels' s8 3×3 VALID conv, x s8 codes [N,H,W,C], wq s8
    [3,3,C,O] and, on CUDA, its K-major copy ``wk = k_major(wq)`` [O, 9C];
    mul/add f32 [O] (``std_affine``) → relu(acc·mul + add) [N,H-2,W-2,O]
    requantized to s8 (``requant``) or bf16."""
    if _on_cpu(x):
        return std_conv3x3_s8_plain(x, wq, mul, add, requant=requant)
    n, h, w, c = x.shape
    o = wq.shape[-1]
    dev = x.device
    _std_shape_ok("std_conv3x3_s8", x, c, o)
    _require(x, "x", S8, x.shape, dev)
    _require(wq, "wq", S8, (3, 3, c, o), dev)
    _k_major_operand(wk, "wk", 9 * c, o, dev)
    _vec(mul, "mul", o, dev)
    _vec(add, "add", o, dev)
    aligned("std_conv3x3_s8", x, wk, mul, add)
    y = torch.empty((n, h - 2, w - 2, o), dtype=S8 if requant else BF16,
                    device=dev)
    plan = std_plan(n, h - 2, w - 2, o, 1)
    with torch.cuda.device(dev):
        err = _build.library().seg_std_conv3x3_s8(
            _ptr(x), _ptr(wk), _ptr(mul), _ptr(add), _ptr(y), n, h, w, c, o,
            int(requant), plan.th, plan.tw, _stream(x),
        )
    _build.check(err, "std_conv3x3_s8")
    launches["std_conv3x3_s8"] += 1
    return y


def std_conv3x3_dual_s8(sk, up, wqa, wqb, cs_a, cs_b, b, *, out_scale=None,
                        offset=(0, 0), act_scale_a=None, act_scale_b=None,
                        wka=None, wkb=None):
    """H8 dual: the std decoder's first conv on concat(crop(sk), up)
    without the concat. sk [N,hs,ws,C] cropped at ``offset`` (its origin)
    to up's [N,H,W,C]; each side s8 codes or bf16 quantized at
    ``act_scale_a`` / ``act_scale_b`` by the division (``quant_act``); wqa,
    wqb s8 [3,3,C,O] and, on CUDA, their K-major copies ``wka``, ``wkb``;
    cs_a, cs_b, b f32 [O] → [N,H-2,W-2,O], s8 requantized at
    ``out_scale``, or bf16 without it."""
    _check_operand(sk, act_scale_a, "std_conv3x3_dual_s8 skip")
    _check_operand(up, act_scale_b, "std_conv3x3_dual_s8 up")
    if _on_cpu(up):
        return std_conv3x3_dual_s8_plain(
            sk, up, wqa, wqb, cs_a, cs_b, b, out_scale=out_scale,
            offset=offset, act_scale_a=act_scale_a, act_scale_b=act_scale_b)
    n, h, w, c = up.shape
    _, hs, ws, _ = sk.shape
    o = wqa.shape[-1]
    oh, ow = (int(v) for v in offset)
    dev = up.device
    _std_shape_ok("std_conv3x3_dual_s8", up, c, o)
    if oh < 0 or ow < 0 or oh + h > hs or ow + w > ws:
        raise ValueError(f"std_conv3x3_dual_s8: crop {offset} of "
                         f"{tuple(sk.shape)} does not cover "
                         f"{tuple(up.shape)}")
    scale_a = 0.0 if act_scale_a is None else float(f32_scale(act_scale_a))
    scale_b = 0.0 if act_scale_b is None else float(f32_scale(act_scale_b))
    _require(sk, "skip", S8 if act_scale_a is None else BF16,
             (n, hs, ws, c), dev)
    _require(up, "up", S8 if act_scale_b is None else BF16, up.shape, dev)
    _require(wqa, "wqa", S8, (3, 3, c, o), dev)
    _require(wqb, "wqb", S8, (3, 3, c, o), dev)
    _k_major_operand(wka, "wka", 9 * c, o, dev)
    _k_major_operand(wkb, "wkb", 9 * c, o, dev)
    for t, name in ((cs_a, "cs_a"), (cs_b, "cs_b"), (b, "b")):
        _vec(t, name, o, dev)
    aligned("std_conv3x3_dual_s8", sk, up, wka, wkb, cs_a, cs_b, b)
    out = 0.0 if out_scale is None else float(f32_scale(out_scale))
    y = torch.empty((n, h - 2, w - 2, o),
                    dtype=BF16 if out_scale is None else S8, device=dev)
    plan = std_plan(n, h - 2, w - 2, o, 2)  # one accumulator a side
    with torch.cuda.device(dev):
        err = _build.library().seg_std_conv3x3_dual_s8(
            _ptr(sk), _ptr(up), _ptr(wka), _ptr(wkb), _ptr(cs_a),
            _ptr(cs_b), _ptr(b), _ptr(y), n, hs, ws, h, w, c, o, oh, ow,
            scale_a, scale_b, out, plan.th, plan.tw, _stream(up),
        )
    _build.check(err, "std_conv3x3_dual_s8")
    inline = act_scale_a is not None or act_scale_b is not None
    launches["std_conv3x3_dual_s8_inline" if inline
             else "std_conv3x3_dual_s8"] += 1
    return y


class Int8Ops(NamedTuple):
    """The ops the int8 forward runs through."""

    entry_chain: Callable
    packed_conv2x2: Callable
    packed_conv2x2_dual: Callable
    strided_conv4x4s2: Callable
    rows_matmul: Callable
    std_conv3x3: Callable
    std_conv3x3_dual: Callable


KERNEL_OPS = Int8Ops(entry_chain, packed_conv2x2_s8, packed_conv2x2_dual_s8,
                     strided_conv4x4s2_s8, rows_matmul_s8, std_conv3x3_s8,
                     std_conv3x3_dual_s8)
PLAIN_OPS = Int8Ops(entry_chain_plain, packed_conv2x2_s8_plain,
                    packed_conv2x2_dual_s8_plain, strided_conv4x4s2_s8_plain,
                    rows_matmul_s8_plain, std_conv3x3_s8_plain,
                    std_conv3x3_dual_s8_plain)

