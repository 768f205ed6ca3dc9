"""Static shape algebra of the VALID U-Net (segmentation_tpu.nn.shapes)."""

from __future__ import annotations

from typing import Tuple


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
