"""The crop/flip/normalize kernel of the input pipeline's device tail
(segmentation_tpu.nn.pallas.augment).

  H7 crop_normalize   u8 staging [N,H,W,C] → [N,crop,crop,C]: sample i's
                      window at (ys[i], xs[i]), its columns reversed where
                      flips[i], each byte mapped to f32 or bf16 (or kept
                      as u8, the masks' byte copy); with the masks
                      [N,H,W,CM] u8, their byte copy at the same offsets
                      and flips in the same launch (crop_normalize_pair)

The wrapper launches ``csrc/crop_normalize.cu`` for a CUDA tensor, or
raises; for a tensor on the CPU it runs the plain version. Each launch adds
one to ``launches["crop_normalize"]`` (an image and its masks: one launch).
Offsets are clamped into the image, as a dynamic slice clamps them.

A byte v maps to v · f32(1/255), one IEEE f32 multiply: the Pallas
kernel's map (augment.py:58), and also what XLA compiles the JAX package's
``device_augment`` (x / 255, data/augment.py:99) to. A true division would
differ in the last bit for 126 of the 256 bytes. bf16 is that f32 value
rounded to nearest even, as ``astype`` rounds.

``pallas_crop_normalize`` and ``fused_augment`` are the JAX module's two
functions over the kernel: x offsets floored to a multiple of 8 (the
function the TPU kernel computes, augment.py:47), random x offsets in 8-px
steps, and the mask returned as u8. JAX sends the mask through the kernel
in f32 and back as round(m·255), which gives back every byte m exactly, so
here the mask is the kernel's byte copy.
"""

from __future__ import annotations

import numpy as np
import torch

from segmentation_tpu_torch.nn.kernels import _build
from segmentation_tpu_torch.nn.kernels._build import (
    _on_cpu,
    _ptr,
    _require,
    _stream,
)

NAMES = ("crop_normalize",)
launches = dict.fromkeys(NAMES, 0)

# out dtype → the kernel's out_kind
_KINDS = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def byte_table() -> np.ndarray:
    """The f32 value of each byte, v · f32(1/255)."""
    return np.arange(256, dtype=np.float32) * np.float32(1 / 255)


def _check(images_u8, crop, out_dtype):
    if images_u8.dtype != torch.uint8 or images_u8.ndim != 4:
        raise TypeError(f"images_u8 must be u8 [N,H,W,C], got "
                        f"{images_u8.dtype} {tuple(images_u8.shape)}")
    _, h, w, _ = images_u8.shape
    if not 1 <= crop <= min(h, w):
        raise ValueError(f"crop {crop} does not fit {h}x{w}")
    if out_dtype not in _KINDS:
        raise TypeError(f"out_dtype {out_dtype}: u8, f32 or bf16")


# ------------------------------------------------------------ plain version
def crop_normalize_plain(images_u8, ys, xs, flips, crop,
                         out_dtype=torch.float32):
    _check(images_u8, crop, out_dtype)
    n, h, w, _ = images_u8.shape
    dev = images_u8.device
    ys = torch.as_tensor(ys).to(dev, torch.long).clamp(0, h - crop)
    xs = torch.as_tensor(xs).to(dev, torch.long).clamp(0, w - crop)
    flips = torch.as_tensor(flips).to(dev) != 0
    r = torch.arange(crop, device=dev)
    rows = ys[:, None] + r
    cols = xs[:, None] + torch.where(flips[:, None], crop - 1 - r, r)
    win = images_u8[torch.arange(n, device=dev)[:, None, None],
                    rows[:, :, None], cols[:, None, :]]
    if out_dtype == torch.uint8:
        return win
    table = torch.from_numpy(byte_table()).to(dev)
    return table[win.long()].to(out_dtype)


# ------------------------------------------------------------ kernel wrapper
def _launch(images_u8, masks_u8, ys, xs, flips, crop, out_dtype):
    n, h, w, c = images_u8.shape
    dev = images_u8.device
    _require(images_u8, "images_u8", torch.uint8, images_u8.shape, dev)
    cm, mout = 0, None
    if masks_u8 is not None:
        cm = masks_u8.shape[-1]
        _require(masks_u8, "masks_u8", torch.uint8, (n, h, w, cm), dev)
        mout = torch.empty((n, crop, crop, cm), dtype=torch.uint8,
                           device=dev)
    ys, xs, flips = (torch.as_tensor(t).to(dev, torch.int32).contiguous()
                     for t in (ys, xs, flips))
    for t, name in ((ys, "ys"), (xs, "xs"), (flips, "flips")):
        _require(t, name, torch.int32, (n,), dev)
    out = torch.empty((n, crop, crop, c), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().seg_crop_normalize(
            _ptr(images_u8), _ptr(masks_u8), _ptr(ys), _ptr(xs),
            _ptr(flips), _ptr(out), _ptr(mout), n, h, w, c, cm, crop,
            _KINDS[out_dtype], _stream(images_u8),
        )
    _build.check(err, "crop_normalize")
    launches["crop_normalize"] += 1
    return out, mout


def crop_normalize(images_u8, ys, xs, flips, crop, out_dtype=torch.float32):
    """H7: u8 [N,H,W,C] and per-sample ys, xs, flips [N] → [N,crop,crop,C]
    in ``out_dtype`` (u8: the window's bytes)."""
    _check(images_u8, crop, out_dtype)
    if _on_cpu(images_u8):
        return crop_normalize_plain(images_u8, ys, xs, flips, crop,
                                    out_dtype)
    return _launch(images_u8, None, ys, xs, flips, crop, out_dtype)[0]


def crop_normalize_pair(images_u8, masks_u8, ys, xs, flips, crop,
                        out_dtype=torch.float32):
    """H7 on an image batch and its masks [N,H,W,CM] u8 in one launch, at
    the same offsets and flips: (crop_normalize of the images, the masks'
    crops as u8)."""
    _check(images_u8, crop, out_dtype)
    _check(masks_u8, crop, torch.uint8)
    if tuple(masks_u8.shape[:3]) != tuple(images_u8.shape[:3]):
        raise ValueError(f"masks {tuple(masks_u8.shape)} do not match "
                         f"images {tuple(images_u8.shape)}")
    if _on_cpu(images_u8):
        return (crop_normalize_plain(images_u8, ys, xs, flips, crop,
                                     out_dtype),
                crop_normalize_plain(masks_u8, ys, xs, flips, crop,
                                     torch.uint8))
    return _launch(images_u8, masks_u8, ys, xs, flips, crop, out_dtype)


# ------------------------------------------- the JAX module's functions
def _floor8(xs):
    return torch.div(torch.as_tensor(xs), 8, rounding_mode="floor") * 8


def pallas_crop_normalize(images_u8, ys, xs, flips, crop,
                          out_dtype=torch.float32):
    """augment.py:65: crop_normalize with x floored to a multiple of 8."""
    return crop_normalize(images_u8, ys, _floor8(xs), flips, crop, out_dtype)


def fused_augment_at(images_u8, masks_u8, ys, xs, flips, crop,
                     out_dtype=torch.float32):
    """fused_augment on given offsets: (image [N,crop,crop,C] in
    ``out_dtype``, mask u8 [N,crop,crop,1] or None)."""
    xs = _floor8(xs)
    if masks_u8 is None:
        return crop_normalize(images_u8, ys, xs, flips, crop, out_dtype), None
    return crop_normalize_pair(images_u8, masks_u8, ys, xs, flips, crop,
                               out_dtype)


def random_offsets(generator: torch.Generator, shape, crop, flip=True,
                   x_step=1):
    """Per-sample crop offsets and flips for a staging batch of ``shape``
    [N,H,W,C], drawn from ``generator`` on its device: ys, xs, flips
    int32 [N], y pixel-granular, x in steps of ``x_step``."""
    n, h, w, _ = shape
    dev = generator.device
    ys = torch.randint(0, h - crop + 1, (n,), generator=generator,
                       device=dev, dtype=torch.int32)
    xs = torch.randint(0, (w - crop) // x_step + 1, (n,),
                       generator=generator, device=dev,
                       dtype=torch.int32) * x_step
    if flip:
        flips = (torch.rand((n,), generator=generator, device=dev)
                 < 0.5).to(torch.int32)
    else:
        flips = torch.zeros((n,), dtype=torch.int32, device=dev)
    return ys, xs, flips


def fused_augment(generator: torch.Generator, images_u8, masks_u8, crop,
                  flip=True, out_dtype=torch.float32):
    """augment.py:102: a joint random crop (y pixel-granular, x in 8-px
    steps) and flip of image and mask, the offsets drawn from
    ``generator`` (on the images' device)."""
    return fused_augment_at(
        images_u8, masks_u8,
        *random_offsets(generator, images_u8.shape, crop, flip, x_step=8),
        crop, out_dtype)
