"""Static shape algebra of the VALID U-Net (segmentation_tpu.nn.shapes)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def conv_out(size: int, kernel: int, stride: int = 1) -> int:
    """Output size of a VALID convolution or pool (TF semantics)."""
    return -(-(size - kernel + 1) // stride)


def deconv_out(size: int, kernel: int, stride: int) -> int:
    """Output size of a VALID conv2d_transpose (TF semantics)."""
    return (size - 1) * stride + kernel


def unet_output_hw(in_hw: Tuple[int, int], levels: int = 4) -> Tuple[int, int]:
    """Output size of the VALID-padded U-Net for a given input size."""

    def down(s):
        for _ in range(levels):
            s = conv_out(conv_out(conv_out(s, 3), 3), 2, 2)
        return conv_out(conv_out(s, 3), 3)

    def up(s):
        for _ in range(levels):
            s = conv_out(conv_out(deconv_out(s, 2, 2), 3), 3)
        return s

    return tuple(up(down(s)) for s in in_hw)  # type: ignore[return-value]


def center_crop_or_pad(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """``tf.image.resize_image_with_crop_or_pad`` for NHWC batches: center-
    crop a dim that is too large (offset = excess // 2), zero-pad one that
    is too small (centered, the extra pixel at the bottom/right)."""
    h, w = x.shape[1], x.shape[2]
    if h > th:
        off = (h - th) // 2
        x = x[:, off : off + th]
    if w > tw:
        off = (w - tw) // 2
        x = x[:, :, off : off + tw]
    ph, pw = th - x.shape[1], tw - x.shape[2]
    if ph > 0 or pw > 0:
        ph, pw = max(ph, 0), max(pw, 0)
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return x
