"""The packed-site kernels of the U-Net serving forward, and H8's bf16
mode at its standard levels.

Each op has a wrapper and a plain PyTorch version of the same function.
The wrapper launches its CUDA kernel (``csrc/<name>.cu``) for a CUDA
tensor, or raises; for a tensor on the CPU it runs the plain version.
There is no fallback from a failed launch. Each launch adds one to
``launches[<name>]``.

  H1 packed_conv2x2      2×2 VALID conv, packed [N,hp,wp,4C] → [N,hp-1,wp-1,4O]
                         (+ slot-max pool, + its int8 index for training,
                         + binary mask head)
  H2 packed_conv2x2_dual conv(crop(skip), wa) + conv(up, wb), concat-free
  H3 strided_conv4x4s2   4×4/2 conv, unpacked [N,H,W,C] → packed 4O
  H4 rows_matmul         per-pixel [C] → [4O] (2×2/2 deconv), identity or
                         slot-scatter store
  H8 std_conv3x3         the std levels' 3×3 VALID conv, unpacked NHWC
  H8 std_conv3x3_dual    the std decoder's concat-free first conv: the skip
                         cropped in its loads, one f32 accumulator

and the Bayesian U-Net's MC-dropout forward (csrc/mc_dropout.cu, H1's MC
head), their masks drawn in the kernels from nn/mc_mask.py's stream:

     mc_fanout              the bottleneck's dropout, B images → S·B
                            masked copies (image s·B + n)
  H1 packed_conv2x2_mc_head conv9_2 + the decoder-end dropout + the
                            two-class head + sigmoid, f32 probabilities
     mc_moments             mean, variance and argmax over the S samples,
                            unpacked

Both duals take a skip batch that divides the up batch (up image i reads
skip image i mod the skip's batch): the MC decoder runs at S·B over the
encoder's B skips, which are never copied.

They replace the Pallas kernels of segmentation_tpu/nn/pallas/conv_flat.py
(padded-flat and paired-column layouts, which exist for the TPU's tiles);
every kernel here reads and writes plain NHWC. Every op ends in bias +
ReLU (every packed site of the forward does). Kernel operands: bf16
activations and weights, f32 bias; every tensor contiguous but H8's
weights (views of the HWIO weight: the dual's halves of the concat
weight). All run on the Hopper mainloop (csrc/sm90_igemm.cuh, H1–H4 with
the output side of csrc/packed_conv2x2_fwd.cuh, H8 with its own in
csrc/std_conv3x3_bf16.cu): their operands are TMA sources, 16-byte
aligned (H3's x only where TMA boxes it, ``tiles.strided_boxable``; else
the kernel gathers it), and their output tiles are planned here by
``tiles.tile_plan`` (``_fwd_plan``) and ``tiles.std_plan``.

H8's bf16 mode replaces no Pallas kernel: the JAX package leaves the
standard levels' convs to XLA (segmentation_tpu/models/unet_fast.py
_std_conv :1045, _std_dual_conv :1050). It computes their function with
one rounding: the f32 sum of the bf16 products, the f32 bias, ReLU,
rounded once to bf16 (XLA's path in the JAX package rounds the conv's
output, then the bias add: the two agree within those roundings).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from segmentation_tpu_torch.nn import mc_mask
from segmentation_tpu_torch.nn.kernels import _build
from segmentation_tpu_torch.nn.kernels._build import (
    _on_cpu,
    _ptr,
    _require,
    _stream,
)
from segmentation_tpu_torch.nn.kernels.conv_bwd import (
    conv2x2_wgrad,
    conv2x2_wgrad_dual_plain,
    packed_conv2x2_dgrad,
    packed_conv2x2_dgrad_dual,
    packed_conv2x2_dgrad_dual_plain,
    packed_conv2x2_dgrad_plain,
    packed_conv2x2_wgrad,
    packed_conv2x2_wgrad_dual,
)
from segmentation_tpu_torch.nn.kernels.train_glue import (
    relu_bias_grad,
    relu_bias_grad_plain,
)
from segmentation_tpu_torch.nn.kernels.tiles import (
    aligned,
    std_plan,
    strided_boxable,
    tile_plan,
)
from segmentation_tpu_torch.nn.packing import crop_packed, unpack2

NAMES = ("packed_conv2x2", "packed_conv2x2_dual", "strided_conv4x4s2",
         "rows_matmul", "packed_conv2x2_pool_index", "std_conv3x3",
         "std_conv3x3_dual", "packed_conv2x2_mc_head", "mc_fanout",
         "mc_moments")
# the training route's modes, which no server runs
TRAIN_ONLY = ("packed_conv2x2_pool_index",)
# the MC-dropout forward's kernels, which no deterministic server runs
MC_ONLY = ("packed_conv2x2_mc_head", "mc_fanout", "mc_moments")
launches = dict.fromkeys(NAMES, 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def wrapper_of(mode: str) -> str:
    """The wrapper function that launches kernel mode ``mode``."""
    return mode.removesuffix("_pool_index")


# ------------------------------------------------------------ plain versions
def _conv_nhwc(x, w_hwio, stride):
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1).to(x.dtype),
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def _epilogue(acc, b4, dtype):
    return torch.relu(acc.float() + b4.float()).to(dtype).contiguous()


def _head_mask(y, head):
    """The fused nc=2 head on the stored value, bf16 operands, f32 sum
    (conv_flat.py conv2x2_padflat's mk_mask)."""
    wd, bd = head
    hd = (y.to(torch.bfloat16).float() @ wd.to(torch.bfloat16).float()
          + bd.float())
    return (hd > 0).to(torch.uint8)


def pool_select(y):
    """The 2×2/2 max pool of a packed y [N,h,w,4O] (the max over its 4
    slots) and its int8 index: the first slot that attains the max (strict
    >), the rule of segmentation_tpu.models.unet_fast.pool4_select."""
    c = y.shape[-1] // 4
    best = y[..., :c]
    idx = torch.zeros(best.shape, dtype=torch.int8, device=y.device)
    for s in range(1, 4):
        sl = y[..., s * c : (s + 1) * c]
        idx.masked_fill_(sl > best, s)
        best = torch.maximum(best, sl)
    return best.contiguous(), idx


def packed_conv2x2_plain(x, w2, b4, *, pool=False, pool_index=False,
                         head=None, head_only=False):
    if head_only and head is None:
        raise ValueError("head_only needs head=(wd, bd)")
    y = _epilogue(_conv_nhwc(x, w2, 1), b4, x.dtype)
    outs = [] if head_only else [y]
    if head is not None:
        outs.append(_head_mask(y, head))
    if pool or pool_index:
        pooled, idx = pool_select(y)
        outs += [pooled, idx] if pool_index else [pooled]
    return outs[0] if len(outs) == 1 else tuple(outs)


def _skip_batch(name, skip, up):
    """The skip's batch, which divides up's (up image i reads skip image i
    mod it)."""
    ns, n = skip.shape[0], up.shape[0]
    if ns < 1 or n % ns:
        raise ValueError(f"{name}: the skip's batch {ns} does not divide "
                         f"the up batch {n}")
    return ns


def _add_broadcast(acc_up, acc_skip):
    """acc_up [n, ...] + acc_skip [ns, ...], image i of up with image i mod
    ns of the skip."""
    ns = acc_skip.shape[0]
    return (acc_up.view(-1, ns, *acc_up.shape[1:])
            + acc_skip.unsqueeze(0)).view(acc_up.shape)


def packed_conv2x2_dual_plain(skip, up, w2a, w2b, b4, *, offset):
    _skip_batch("packed_conv2x2_dual", skip, up)
    sk = crop_packed(skip, (skip.shape[0], *up.shape[1:]), offset)
    acc = _add_broadcast(_conv_nhwc(up, w2b, 1).float(),
                         _conv_nhwc(sk, w2a, 1).float())
    return _epilogue(acc, b4, up.dtype)


def strided_conv4x4s2_plain(x, w4, b4):
    return _epilogue(_conv_nhwc(x, w4, 2), b4, x.dtype)


def rows_matmul_plain(x, wm, b4, *, scatter=False):
    if scatter:
        n, i, j, c4 = x.shape
        x = unpack2(x.reshape(n, i, j, 4, c4 // 4))
    return _epilogue(torch.matmul(x, wm.to(x.dtype)), b4, x.dtype)


def std_conv3x3_plain(x, w, b):
    """H8 bf16's function: the f32 sum of the products of x [N,H,W,C] and
    w [3,3,C,O] (VALID), + b in f32, ReLU, rounded once to x's dtype. In
    f32 it is nn/layers.conv2d(x, w, b) exactly."""
    return _epilogue(_conv_nhwc(x.float(), w, 1), b, x.dtype)


def _std_crop_ok(name, skip, up, offset):
    """The std dual's crop of ``skip`` at ``offset`` covers ``up``."""
    oh, ow = offset
    if (oh < 0 or ow < 0 or oh + up.shape[1] > skip.shape[1]
            or ow + up.shape[2] > skip.shape[2]):
        raise ValueError(f"{name}: crop {offset} of {tuple(skip.shape)} "
                         f"does not cover {tuple(up.shape)}")


def std_conv3x3_dual_plain(skip, up, wa, wb, b, *, offset):
    """H8 bf16 dual's function: conv(crop(skip), wa) + conv(up, wb) summed
    in f32, the skip read at the crop origin ``offset`` (up image i reads
    skip image i mod the skip's batch); + b, ReLU, one rounding to up's
    dtype."""
    _std_crop_ok("std_conv3x3_dual", skip, up, offset)
    _skip_batch("std_conv3x3_dual", skip, up)
    oh, ow = offset
    sk = skip[:, oh : oh + up.shape[1], ow : ow + up.shape[2]]
    acc = _add_broadcast(_conv_nhwc(up.float(), wb, 1),
                         _conv_nhwc(sk.float(), wa, 1))
    return _epilogue(acc, b, up.dtype)


def mc_fanout_plain(x, *, seed, samples, rate):
    """x [B, H, W, C] → [samples · B, H, W, C] in x's dtype: image s·B + n
    is x[n] times the bottleneck stream (seed, s, n)'s mask, rounded
    once."""
    b = x.shape[0]
    m = mc_mask.batch_multiplier(seed, mc_mask.SITES["bottleneck"], samples,
                                 b, x.shape[1:], rate, x.device)
    return (x.float().repeat(samples, 1, 1, 1) * m).to(x.dtype)


def packed_conv2x2_mc_head_plain(x, w2, b4, wh, bh, *, seed, tiles, rate):
    """H1's MC head: y = relu(conv(x, w2) + b4), the f32 sum rounded once
    to x's dtype; the decoder-end dropout of each unpacked element of
    image i (sample i // tiles of tile i % tiles); then the two logits of
    each slot, f32 sums of the head's operands (y in x's dtype, wh [O, 2]
    in its own), + bh [2] f32, and their sigmoids: [N, hp-1, wp-1, 8] f32,
    slot-major (class 0, class 1) pairs."""
    y = _epilogue(_conv_nhwc(x.float(), w2, 1), b4, x.dtype)
    n, hp, wp, o4 = y.shape
    if n % tiles:
        raise ValueError(f"packed_conv2x2_mc_head: {n} images are not "
                         f"samples of {tiles} tiles")
    o = o4 // 4
    m = mc_mask.batch_multiplier(seed, mc_mask.SITES["head"], n // tiles,
                                 tiles, (2 * hp, 2 * wp, o), rate, x.device)
    yd = unpack2(y.float().view(n, hp, wp, 4, o)) * m
    logits = yd @ wh.float() + bh.float()
    probs = torch.sigmoid(logits).view(n, hp, 2, wp, 2, 2)
    return probs.permute(0, 1, 3, 2, 4, 5).reshape(n, hp, wp, 8)


def mc_moments_plain(probs, *, tiles):
    """probs [S · B, hp, wp, 8] f32 (slot-major class pairs) → (mean, var
    [B, 2hp, 2wp, 2] f32, the argmax of the mean [B, 2hp, 2wp] u8): over
    the S samples of each tile, the population variance (jnp.var's)."""
    n, hp, wp, _ = probs.shape
    p = unpack2(probs.float().view(n, hp, wp, 4, 2))
    p = p.view(n // tiles, tiles, 2 * hp, 2 * wp, 2)
    mean = p.mean(0)
    var = ((p - mean) ** 2).mean(0)
    return mean, var, mean.argmax(-1).to(torch.uint8)


# ------------------------------------------------------------ kernel wrappers
CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue

# 4O of H1–H4's bf16 modes. 512 (n_kernels 64's level 2) is two column
# tiles of 256 a pixel tile (csrc/packed_conv2x2_fwd.cuh); which modes have
# it is the dispatchers' rule alone (_check_o4)
O4_BF16 = (128, 256, 512)


def _o4_ok(o4, name, widths=O4_BF16):
    if o4 not in widths:
        raise ValueError(f"{name}: 4O = {o4}; the kernel takes "
                         f"{' or '.join(map(str, widths))}")


def _check_o4(err, name, o4):
    """``_build.check``, with a 4O past 256 that the mode's dispatcher has
    no instantiation for (it returns cudaErrorInvalidValue before any
    launch) raised as the ValueError it is."""
    if err == CUDA_ERROR_INVALID_VALUE and o4 > 256:
        raise ValueError(f"{name}: this mode has no 4O = {o4} (the "
                         f"dispatcher's rule: 128 or 256 only)")
    _build.check(err, name)


# H1–H4's output tile, its wgmma rows (FwdOut::BM): at 4O = 128 a consumer
# warpgroup takes a whole tile (two m64n128; the two take turns), at 4O =
# 256 each takes 64 of its rows (m64n256), at 4O = 512 likewise in each of
# a pixel tile's two column tiles
FWD_TILE_ROWS = 128


def _fwd_plan(n, ho, wo, o4, halo=1, step=1):
    """The output tiles of a bf16 forward kernel: th · (tw + halo) GEMM
    rows, halo 1 where four taps read one halo box, 0 where one tap reads
    the tile (H4, H3 gathered); tw a multiple of ``step``. (``o4``: the
    tile variants of profile_variants.py size the tiles by it.)"""
    return tile_plan(n, ho, wo, FWD_TILE_ROWS, halo, step)


def strided_plan(x, o4):
    """H3's output tiles for x [N, H, W, C]: four taps over a halo box
    where TMA boxes x (``strided_boxable``), one tap over the tile where
    the kernel gathers it."""
    n, h, w, _ = x.shape
    return _fwd_plan(n, (h - 2) // 2, (w - 2) // 2, o4,
                     halo=int(strided_boxable(x)))


def rows_plan(x, o4, scatter):
    """H4's output tiles: one tap over the tile; the scatter loads one box
    per output row of a tile, each on a 1024-byte boundary of the A slot,
    so its tw is a multiple of 8."""
    n, h, w, _ = x.shape
    if scatter:
        return _fwd_plan(n, 2 * h, 2 * w, o4, halo=0, step=8)
    return _fwd_plan(n, h, w, o4, halo=0)


def packed_conv2x2(x, w2, b4, *, pool=False, pool_index=False, head=None,
                   head_only=False):
    """H1: x [N,hp,wp,4C], w2 [2,2,4C,4O], b4 [4O] f32 → y [N,hp-1,wp-1,4O];
    with ``pool`` also the slot-max [..,O]; ``pool_index`` (training) also
    the pool's int8 index [..,O] (``pool_select``'s); with ``head=(wd
    [4O,4] bf16, bd [4] f32)`` also the u8 mask [..,4]; ``head_only``
    returns the mask alone. Outputs in the order (y, mask, pooled, idx)."""
    if _on_cpu(x):
        return packed_conv2x2_plain(x, w2, b4, pool=pool,
                                    pool_index=pool_index, head=head,
                                    head_only=head_only)
    if head_only and head is None:
        raise ValueError("head_only needs head=(wd, bd)")
    if pool_index and head is not None:
        raise ValueError("packed_conv2x2: pool_index takes no head")
    pool = pool or pool_index
    n, hp, wp, c4 = x.shape
    o4 = w2.shape[-1]
    dev = x.device
    _o4_ok(o4, "packed_conv2x2")
    if c4 % 8 or hp < 2 or wp < 2:
        raise ValueError(f"packed_conv2x2: bad input shape {tuple(x.shape)}")
    _require(x, "x", torch.bfloat16, x.shape, dev)
    _require(w2, "w2", torch.bfloat16, (2, 2, c4, o4), dev)
    _require(b4, "b4", torch.float32, (o4,), dev)
    wd = bd = mask = pooled = idx = y = None
    shp = (n, hp - 1, wp - 1)
    if head is not None:
        wd, bd = head
        _require(wd, "wd", torch.bfloat16, (o4, 4), dev)
        _require(bd, "bd", torch.float32, (4,), dev)
        mask = torch.empty(shp + (4,), dtype=torch.uint8, device=dev)
        aligned("packed_conv2x2", wd)
    aligned("packed_conv2x2", x, w2, b4)
    plan = _fwd_plan(n, hp - 1, wp - 1, o4)
    if not head_only:
        y = torch.empty(shp + (o4,), dtype=torch.bfloat16, device=dev)
    if pool:
        pooled = torch.empty(shp + (o4 // 4,), dtype=torch.bfloat16,
                             device=dev)
    if pool_index:
        idx = torch.empty(shp + (o4 // 4,), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_packed_conv2x2(
            _ptr(x), _ptr(w2), _ptr(b4), _ptr(y), _ptr(pooled), _ptr(idx),
            _ptr(wd), _ptr(bd), _ptr(mask), n, hp, wp, c4, o4, plan.th,
            plan.tw, _stream(x),
        )
    name = "packed_conv2x2_pool_index" if pool_index else "packed_conv2x2"
    _check_o4(err, name, o4)
    launches[name] += 1
    outs = [t for t in (y, mask, pooled, idx) if t is not None]
    return outs[0] if len(outs) == 1 else tuple(outs)


def packed_conv2x2_dual(skip, up, w2a, w2b, b4, *, offset: Tuple[int, int]):
    """H2: skip [Ns,hpa,wpa,4C], up [N,hp,wp,4C] → [N,hp-1,wp-1,4O] =
    conv(crop(skip), w2a) + conv(up, w2b) + b4, the skip cropped at the
    UNPACKED offset ``offset`` (even: a packed slice; odd: a slot phase);
    Ns divides N, up image i reading skip image i mod Ns (in place)."""
    if _on_cpu(up):
        return packed_conv2x2_dual_plain(skip, up, w2a, w2b, b4,
                                         offset=offset)
    n, hp, wp, c4 = up.shape
    ns, hpa, wpa, _ = skip.shape
    _skip_batch("packed_conv2x2_dual", skip, up)
    o4 = w2a.shape[-1]
    oh, ow = (int(v) for v in offset)
    dev = up.device
    _o4_ok(o4, "packed_conv2x2_dual")
    if c4 % 32 or hp < 2 or wp < 2:
        raise ValueError(
            f"packed_conv2x2_dual: bad input shape {tuple(up.shape)}")
    if oh < 0 or ow < 0 or oh + 2 * hp > 2 * hpa or ow + 2 * wp > 2 * wpa:
        raise ValueError(f"packed_conv2x2_dual: crop {offset} of "
                         f"{tuple(skip.shape)} does not cover "
                         f"{tuple(up.shape)}")
    _require(up, "up", torch.bfloat16, up.shape, dev)
    _require(skip, "skip", torch.bfloat16, (ns, hpa, wpa, c4), dev)
    _require(w2a, "w2a", torch.bfloat16, (2, 2, c4, o4), dev)
    _require(w2b, "w2b", torch.bfloat16, (2, 2, c4, o4), dev)
    _require(b4, "b4", torch.float32, (o4,), dev)
    aligned("packed_conv2x2_dual", skip, up, w2a, w2b, b4)
    plan = _fwd_plan(n, hp - 1, wp - 1, o4)
    y = torch.empty((n, hp - 1, wp - 1, o4), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_packed_conv2x2_dual(
            _ptr(skip), _ptr(up), _ptr(w2a), _ptr(w2b), _ptr(b4), _ptr(y),
            n, ns, hpa, wpa, hp, wp, c4, o4, oh, ow, plan.th, plan.tw,
            _stream(up),
        )
    _check_o4(err, "packed_conv2x2_dual", o4)
    launches["packed_conv2x2_dual"] += 1
    return y


def strided_conv4x4s2(x, w4, b4):
    """H3: x [N,H,W,C] unpacked, w4 [4,4,C,4O] → packed
    [N,(H-2)//2,(W-2)//2,4O]. Takes any C (C=3 at the entry): where TMA
    can box x's space-to-depth view (``strided_boxable``) the kernel reads
    it as H1 reads x, four taps over one halo box; else it gathers each
    output pixel's 4×4×C window as one row (one tap)."""
    if _on_cpu(x):
        return strided_conv4x4s2_plain(x, w4, b4)
    n, h, w, c = x.shape
    o4 = w4.shape[-1]
    dev = x.device
    _o4_ok(o4, "strided_conv4x4s2")
    if h < 4 or w < 4:
        raise ValueError(f"strided_conv4x4s2: input {tuple(x.shape)} < 4x4")
    _require(x, "x", torch.bfloat16, x.shape, dev)
    _require(w4, "w4", torch.bfloat16, (4, 4, c, o4), dev)
    _require(b4, "b4", torch.float32, (o4,), dev)
    aligned("strided_conv4x4s2", w4, b4)
    ho, wo = (h - 2) // 2, (w - 2) // 2
    plan = strided_plan(x, o4)
    y = torch.empty((n, ho, wo, o4), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_strided_conv4x4s2(
            _ptr(x), _ptr(w4), _ptr(b4), _ptr(y), n, h, w, c, o4, plan.th,
            plan.tw, _stream(x),
        )
    _check_o4(err, "strided_conv4x4s2", o4)
    launches["strided_conv4x4s2"] += 1
    return y


def rows_matmul(x, wm, b4, *, scatter=False):
    """H4: per-pixel x @ wm [C, 4O] + b4. Identity: x [N,H,W,C] →
    [N,H,W,4O]. Scatter: x packed [N,i,j,4C] → [N,2i,2j,4O], input slot
    (a,b) of pixel (i,j) landing at output pixel (2i+a, 2j+b)."""
    if _on_cpu(x):
        return rows_matmul_plain(x, wm, b4, scatter=scatter)
    n, hi, wi, cx = x.shape
    c, o4 = wm.shape
    dev = x.device
    _o4_ok(o4, "rows_matmul")
    ho, wo = (2 * hi, 2 * wi) if scatter else (hi, wi)
    if cx != (4 * c if scatter else c) or c % 8:
        raise ValueError(f"rows_matmul: x {tuple(x.shape)} vs wm "
                         f"{tuple(wm.shape)} (scatter={scatter})")
    _require(x, "x", torch.bfloat16, x.shape, dev)
    _require(wm, "wm", torch.bfloat16, (c, o4), dev)
    _require(b4, "b4", torch.float32, (o4,), dev)
    aligned("rows_matmul", x, wm, b4)
    plan = rows_plan(x, o4, scatter)
    y = torch.empty((n, ho, wo, o4), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_rows_matmul(
            _ptr(x), _ptr(wm), _ptr(b4), _ptr(y), n, ho, wo, c, o4,
            int(scatter), plan.th, plan.tw, _stream(x),
        )
    _check_o4(err, "rows_matmul", o4)
    launches["rows_matmul"] += 1
    return y


def _std_weight(w, name, c, o, dev):
    """An H8 bf16 weight operand: a [3, 3, C, O] bf16 view whose rows of O
    are contiguous and whose taps are evenly spaced (the HWIO weight, or a
    half of the dual's concat weight)."""
    if w.device != dev or w.dtype != torch.bfloat16 or \
            tuple(w.shape) != (3, 3, c, o):
        raise ValueError(f"{name}: {tuple(w.shape)} {w.dtype} on "
                         f"{w.device}, expected (3, 3, {c}, {o}) bf16 on "
                         f"{dev}")
    if w.stride(3) != 1 or w.stride(2) != o or w.stride(0) != 3 * w.stride(1):
        raise ValueError(f"{name}: strides {w.stride()} are not a view of "
                         f"an HWIO weight")


def _std_shape_ok(name, x, o):
    _, h, w, c = x.shape
    if c % 8 or o % 128 or h < 3 or w < 3:
        raise ValueError(f"{name}: bad input shape {tuple(x.shape)} (C % 8 "
                         f"== 0) for O = {o} (O % 128 == 0)")


def std_conv3x3(x, w, b):
    """H8 bf16: x [N,H,W,C] bf16, w [3,3,C,O] bf16 (a view whose rows are
    contiguous), b [O] f32 → relu(conv(x, w) + b) [N,H-2,W-2,O] bf16,
    rounded once."""
    if _on_cpu(x):
        return std_conv3x3_plain(x, w, b)
    n, h, wd, c = x.shape
    o = w.shape[-1]
    dev = x.device
    _std_shape_ok("std_conv3x3", x, o)
    _require(x, "x", torch.bfloat16, x.shape, dev)
    _std_weight(w, "w", c, o, dev)
    _require(b, "b", torch.float32, (o,), dev)
    aligned("std_conv3x3", x, w, b)
    plan = std_plan(n, h - 2, wd - 2, o, 1)  # one accumulator
    y = torch.empty((n, h - 2, wd - 2, o), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_std_conv3x3(
            _ptr(x), _ptr(w), _ptr(b), _ptr(y), n, h, wd, c, o, w.stride(1),
            w.stride(0), plan.th, plan.tw, _stream(x),
        )
    _build.check(err, "std_conv3x3")
    launches["std_conv3x3"] += 1
    return y


def std_conv3x3_dual(skip, up, wa, wb, b, *, offset: Tuple[int, int]):
    """H8 bf16 dual: skip [Ns,hs,ws,C], up [N,H,W,C] bf16 → relu(conv(crop(
    skip), wa) + conv(up, wb) + b) [N,H-2,W-2,O] bf16, the skip read at the
    crop origin ``offset`` (no copy; Ns divides N, up image i reading skip
    image i mod Ns); wa, wb [3,3,C,O] the skip's and up's halves of the
    concat weight (views, equal strides); b [O] f32."""
    if _on_cpu(up):
        return std_conv3x3_dual_plain(skip, up, wa, wb, b, offset=offset)
    n, h, wd, c = up.shape
    ns, hs, ws, _ = skip.shape
    _skip_batch("std_conv3x3_dual", skip, up)
    o = wa.shape[-1]
    oh, ow = (int(v) for v in offset)
    dev = up.device
    _std_shape_ok("std_conv3x3_dual", up, o)
    _std_crop_ok("std_conv3x3_dual", skip, up, (oh, ow))
    _require(up, "up", torch.bfloat16, up.shape, dev)
    _require(skip, "skip", torch.bfloat16, (ns, hs, ws, c), dev)
    _std_weight(wa, "wa", c, o, dev)
    _std_weight(wb, "wb", c, o, dev)
    if wa.stride() != wb.stride():
        raise ValueError(f"std_conv3x3_dual: wa strides {wa.stride()} != "
                         f"wb strides {wb.stride()}")
    _require(b, "b", torch.float32, (o,), dev)
    aligned("std_conv3x3_dual", skip, up, wa, wb, b)
    plan = std_plan(n, h - 2, wd - 2, o, 1)  # one accumulator
    y = torch.empty((n, h - 2, wd - 2, o), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_std_conv3x3_dual(
            _ptr(skip), _ptr(up), _ptr(wa), _ptr(wb), _ptr(b), _ptr(y), n,
            ns, hs, ws, h, wd, c, o, oh, ow, wa.stride(1), wa.stride(0),
            plan.th, plan.tw, _stream(up),
        )
    _build.check(err, "std_conv3x3_dual")
    launches["std_conv3x3_dual"] += 1
    return y


def mc_fanout(x, *, seed: int, samples: int, rate: float):
    """x [B, H, W, C] bf16 (C % 8 == 0) → [samples · B, H, W, C] bf16:
    image s·B + n is x[n] dropped by the bottleneck stream (seed, s, n),
    the mask drawn in the kernel (csrc/mc_dropout.cu)."""
    if _on_cpu(x):
        return mc_fanout_plain(x, seed=seed, samples=samples, rate=rate)
    b, h, w, c = x.shape
    dev = x.device
    if c % 8 or samples < 1:
        raise ValueError(f"mc_fanout: bad input shape {tuple(x.shape)} (C % "
                         f"8 == 0) or samples {samples}")
    _require(x, "x", torch.bfloat16, x.shape, dev)
    aligned("mc_fanout", x)
    lo, hi = mc_mask.split_seed(seed)
    thr = mc_mask.threshold(rate)
    y = torch.empty((samples * b, h, w, c), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_mc_fanout(
            _ptr(x), _ptr(y), b, h, w, c, samples, lo, hi, thr,
            mc_mask.keep_scale(rate), _stream(x))
    _build.check(err, "mc_fanout")
    launches["mc_fanout"] += 1
    return y


def packed_conv2x2_mc_head(x, w2, b4, wh, bh, *, seed: int, tiles: int,
                           rate: float):
    """H1's MC head: x [N,hp,wp,4C] bf16, w2 [2,2,4C,4O] bf16, b4 [4O] f32,
    the head wh [O, 2] bf16 and bh [2] f32 → the sigmoid probabilities
    [N,hp-1,wp-1,8] f32 (slot-major class pairs) of the conv's output
    dropped by the decoder-end stream (seed, i // tiles, i % tiles) of
    image i; 4O = 128 or 256 (``packed_conv2x2_mc_head_plain``'s
    function)."""
    if _on_cpu(x):
        return packed_conv2x2_mc_head_plain(x, w2, b4, wh, bh, seed=seed,
                                            tiles=tiles, rate=rate)
    n, hp, wp, c4 = x.shape
    o4 = w2.shape[-1]
    dev = x.device
    _o4_ok(o4, "packed_conv2x2_mc_head", (128, 256))
    if c4 % 8 or hp < 2 or wp < 2 or tiles < 1 or n % tiles:
        raise ValueError(f"packed_conv2x2_mc_head: bad input shape "
                         f"{tuple(x.shape)} for {tiles} tiles")
    _require(x, "x", torch.bfloat16, x.shape, dev)
    _require(w2, "w2", torch.bfloat16, (2, 2, c4, o4), dev)
    _require(b4, "b4", torch.float32, (o4,), dev)
    _require(wh, "wh", torch.bfloat16, (o4 // 4, 2), dev)
    _require(bh, "bh", torch.float32, (2,), dev)
    aligned("packed_conv2x2_mc_head", x, w2, b4, wh, bh)
    lo, hi = mc_mask.split_seed(seed)
    plan = _fwd_plan(n, hp - 1, wp - 1, o4)
    probs = torch.empty((n, hp - 1, wp - 1, 8), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_packed_conv2x2_mc_head(
            _ptr(x), _ptr(w2), _ptr(b4), _ptr(wh), _ptr(bh), _ptr(probs), n,
            hp, wp, c4, o4, plan.th, plan.tw, lo, hi, tiles,
            mc_mask.threshold(rate), mc_mask.keep_scale(rate), _stream(x))
    _build.check(err, "packed_conv2x2_mc_head")
    launches["packed_conv2x2_mc_head"] += 1
    return probs


def mc_moments(probs, *, tiles: int):
    """probs [S · B, hp, wp, 8] f32 → (mean, var [B, 2hp, 2wp, 2] f32,
    map [B, 2hp, 2wp] u8), unpacked in the same pass
    (``mc_moments_plain``'s function; csrc/mc_dropout.cu)."""
    if _on_cpu(probs):
        return mc_moments_plain(probs, tiles=tiles)
    n, hp, wp, k = probs.shape
    dev = probs.device
    if k != 8 or tiles < 1 or n % tiles:
        raise ValueError(f"mc_moments: bad input shape {tuple(probs.shape)} "
                         f"for {tiles} tiles")
    _require(probs, "probs", torch.float32, probs.shape, dev)
    shape = (tiles, 2 * hp, 2 * wp)
    mean = torch.empty(shape + (2,), dtype=torch.float32, device=dev)
    var = torch.empty(shape + (2,), dtype=torch.float32, device=dev)
    cmap = torch.empty(shape, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_mc_moments(
            _ptr(probs), _ptr(mean), _ptr(var), _ptr(cmap), tiles, hp, wp,
            n // tiles, _stream(probs))
    _build.check(err, "mc_moments")
    launches["mc_moments"] += 1
    return mean, var, cmap


class Ops(NamedTuple):
    """The ops a model runs through: the four packed-site forward ops, H8's
    bf16 std-level convs (serving's and training's), what training runs
    besides: the input and weight grads of the 2×2 sites (H6, H9,
    conv_bwd.py) and the glue of every site's backward (train_glue.py),
    and the MC-dropout forward's fan-out, head and moments."""

    packed_conv2x2: Callable
    packed_conv2x2_dual: Callable
    strided_conv4x4s2: Callable
    rows_matmul: Callable
    packed_conv2x2_dgrad: Callable
    packed_conv2x2_dgrad_dual: Callable
    relu_bias_grad: Callable
    std_conv3x3: Callable
    std_conv3x3_dual: Callable
    packed_conv2x2_wgrad: Callable
    packed_conv2x2_wgrad_dual: Callable
    mc_fanout: Callable
    packed_conv2x2_mc_head: Callable
    mc_moments: Callable


KERNEL_OPS = Ops(packed_conv2x2, packed_conv2x2_dual, strided_conv4x4s2,
                 rows_matmul, packed_conv2x2_dgrad, packed_conv2x2_dgrad_dual,
                 relu_bias_grad, std_conv3x3, std_conv3x3_dual,
                 packed_conv2x2_wgrad, packed_conv2x2_wgrad_dual, mc_fanout,
                 packed_conv2x2_mc_head, mc_moments)
PLAIN_OPS = Ops(packed_conv2x2_plain, packed_conv2x2_dual_plain,
                strided_conv4x4s2_plain, rows_matmul_plain,
                packed_conv2x2_dgrad_plain, packed_conv2x2_dgrad_dual_plain,
                relu_bias_grad_plain, std_conv3x3_plain,
                std_conv3x3_dual_plain, conv2x2_wgrad,
                conv2x2_wgrad_dual_plain, mc_fanout_plain,
                packed_conv2x2_mc_head_plain, mc_moments_plain)
