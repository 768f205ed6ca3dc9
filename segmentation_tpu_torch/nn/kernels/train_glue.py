"""The train step's glue kernels (``csrc/train_glue.cu``).

  relu_bias_grad        the ReLU mask and the bias gradient of a packed
                        train site in one pass: from the cotangent g and the
                        saved output y [N,h,w,4O] bf16, gm = g · (y > 0)
                        (bf16) and db = Σ gm over N, h, w (f32 [4O]); gm
                        written into a zero-margined buffer
  relu_bias_grad_pool   the same at the level sites (conv1_2, conv2_2),
                        whose output y is both the skip and the pool's
                        input: dy = g + the pool's gradient gp scattered to
                        the slot its index idx names (pool4_select's
                        backward), rounded to bf16, then masked
  crop_margin_zero      zeros of a dual site's skip gradient outside its
                        crop window (H6's dual mode writes the window)

Each wrapper launches its kernel for a CUDA tensor, or raises; for a tensor
on the CPU it runs the plain version. Each launch adds one to
``launches[<name>]``. db comes from per-block f32 partials summed in a
fixed order: two launches give the same bits, and it agrees with the plain
version's ``gm.sum`` within f32 reduction-order rounding.

The gm buffer (``pad``): [N, h+1, w+1, 4O], whose zero last row and column
let H9 (conv_bwd.packed_conv2x2_wgrad) read it in place as flattened pixel
rows, each tap a row shift, and H6 read its [N, h, w] window through a row
pitch. Without it, gm is [N, h, w,
4O].
"""

from __future__ import annotations

import torch

from segmentation_tpu_torch.nn.kernels import _build
from segmentation_tpu_torch.nn.kernels._build import (
    _on_cpu,
    _ptr,
    _require,
    _stream,
)
from segmentation_tpu_torch.nn.kernels.tiles import aligned

NAMES = ("relu_bias_grad", "relu_bias_grad_pool", "crop_margin_zero")
launches = dict.fromkeys(NAMES, 0)
THREADS = 256  # a block of relu_bias_grad (kGlueThreads)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def wrapper_of(mode: str) -> str:
    """The wrapper function that launches kernel mode ``mode``."""
    return mode.removesuffix("_pool")


# ------------------------------------------------------------ plain versions
def pool_scatter(gp, idx):
    """pool4_select's backward: gp [N,h,w,C] to the slot idx [N,h,w,C]
    names, zeros in the other three: [N,h,w,4C]."""
    n, h, w, c = gp.shape
    slots = torch.arange(4, dtype=torch.int8, device=gp.device)
    d5 = torch.where(idx[..., None, :] == slots[:, None], gp[..., None, :],
                     0.0)
    return d5.reshape(n, h, w, 4 * c)


def relu_bias_grad_plain(g, y, *, pool=None, pad=False):
    if pool is not None:
        d = pool_scatter(*pool)
        g = d if g is None else g + d
    gm = torch.where(y > 0, g, 0.0)
    db = gm.sum((0, 1, 2), dtype=torch.float32)
    if not pad:
        return gm.contiguous(), db
    n, h, w, c4 = gm.shape
    out = gm.new_zeros((n, h + 1, w + 1, c4))
    out[:, :h, :w] = gm
    return out, db


def window_mask(shape, hp, wp, offset, device):
    """[hpa, wpa, 4, 1] bool: the slots of a skip [N, hpa, wpa, 4C] inside
    the crop window of [hp, wp] packed pixels at the unpacked offset."""
    _, hpa, wpa, _ = shape
    oh, ow = offset
    rows = torch.arange(2 * hpa, device=device)
    cols = torch.arange(2 * wpa, device=device)
    rin = ((rows >= oh) & (rows < oh + 2 * hp)).reshape(hpa, 1, 2, 1)
    cin = ((cols >= ow) & (cols < ow + 2 * wp)).reshape(1, wpa, 1, 2)
    return (rin & cin).reshape(hpa, wpa, 4, 1)


def crop_margin_zero_plain(buf, hp, wp, offset):
    n, hpa, wpa, c4 = buf.shape
    keep = window_mask(buf.shape, hp, wp, offset, buf.device)
    buf.view(n, hpa, wpa, 4, c4 // 4).masked_fill_(~keep, 0)
    return buf


def db_error_bound(gm):
    """The bound on relu_bias_grad's f32 db against the exact sum of gm
    [N, R, W, 4O] (the kernel's gm, a zero margin included), per channel:
    d · 2^-24 · Σ|gm|, d the depth of the kernel's three sequential f32
    sums: the pixels one thread adds, the block's THREADS / (4O / 8) rows
    of them, and the per-block partials. Needs the built library (the
    block count)."""
    n, r, w, c4 = gm.shape
    blocks = _build.library().seg_relu_bias_grad_blocks()
    step = THREADS // (c4 // 8)
    per_thread = -(-n * r * w // (blocks * step))
    total = gm.double().abs().sum((0, 1, 2))
    return (per_thread + step + blocks) * 2.0**-24 * total


# ------------------------------------------------------------ kernel wrappers
def relu_bias_grad(g, y, *, pool=None, pad=False):
    """(gm, db): gm = g · (y > 0), after adding the pool's gradient where
    ``pool=(gp, idx)`` (g may then be None: y had no other consumer); db
    its f32 sum over N, h, w."""
    if _on_cpu(y):
        return relu_bias_grad_plain(g, y, pool=pool, pad=pad)
    n, h, w, c4 = y.shape
    dev = y.device
    name = "relu_bias_grad" if pool is None else "relu_bias_grad_pool"
    if c4 % 8 or c4 > 2048 or (pool is not None and c4 % 32):
        raise ValueError(f"{name}: 4O = {c4}; the kernel takes 4O % 8 == 0 "
                         f"up to 2048 (the pool mode 4O % 32 == 0)")
    _require(y, "y", torch.bfloat16, y.shape, dev)
    if g is not None:
        _require(g, "g", torch.bfloat16, y.shape, dev)
    elif pool is None:
        raise ValueError(f"{name}: no cotangent")
    gp = idx = None
    if pool is not None:
        gp, idx = pool
        _require(gp, "gp", torch.bfloat16, (n, h, w, c4 // 4), dev)
        _require(idx, "idx", torch.int8, (n, h, w, c4 // 4), dev)
    aligned(name, *(t for t in (g, y, gp) if t is not None))
    rows, cols = (h + 1, w + 1) if pad else (h, w)
    out = torch.empty((n, rows, cols, c4), dtype=torch.bfloat16, device=dev)
    lib = _build.library()
    partial = torch.empty((lib.seg_relu_bias_grad_blocks(), c4),
                          dtype=torch.float32, device=dev)
    db = torch.empty((c4,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.seg_relu_bias_grad(
            _ptr(g), _ptr(y), _ptr(gp), _ptr(idx), _ptr(out), rows, cols,
            _ptr(partial), _ptr(db), n, h, w, c4, _stream(y),
        )
    _build.check(err, name)
    launches[name] += 1
    return out, db


def crop_margin_zero(buf, hp, wp, offset):
    """Zeros of buf [N, hpa, wpa, 4C] outside the crop window of [hp, wp]
    packed pixels at the unpacked ``offset``, in place; returns buf."""
    if _on_cpu(buf):
        return crop_margin_zero_plain(buf, hp, wp, offset)
    n, hpa, wpa, c4 = buf.shape
    oh, ow = (int(v) for v in offset)
    _require(buf, "buf", torch.bfloat16, buf.shape, buf.device)
    aligned("crop_margin_zero", buf)
    with torch.cuda.device(buf.device):
        err = _build.library().seg_crop_margin_zero(
            _ptr(buf), n, hpa, wpa, c4, hp, wp, oh, ow, _stream(buf))
    _build.check(err, "crop_margin_zero")
    launches["crop_margin_zero"] += 1
    return buf
