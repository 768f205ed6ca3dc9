"""Layers, initializers, shape algebra and the hand-written kernels."""

from segmentation_tpu_torch.nn.layers import (
    center_crop_like,
    conv2d,
    conv2d_transpose,
    max_pool,
)

__all__ = ["center_crop_like", "conv2d", "conv2d_transpose", "max_pool"]
