"""Functional layers with slim semantics and VALID padding
(segmentation_tpu.nn.layers).

Tensors are NHWC and weights HWIO at every public function, as in the JAX
package; the permutes to PyTorch's NCHW/OIHW are views taken inside. Each
layer computes in the input's dtype and returns it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def _finish(y, b, activation, dtype):
    if b is not None:
        y = y + b.to(y.dtype)
    if activation is not None:
        y = activation(y)
    return y.to(dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1,
           activation: Optional[Callable] = torch.relu) -> torch.Tensor:
    """slim.convolution2d, VALID: conv + bias + activation (ReLU default).
    x [N, H, W, C], w [kh, kw, C, O]."""
    if x.shape[1] < w.shape[0] or x.shape[2] < w.shape[1]:
        raise ValueError(
            f"conv2d: spatial input {x.shape[1]}x{x.shape[2]} too small "
            f"for a {w.shape[0]}x{w.shape[1]} VALID conv"
        )
    y = F.conv2d(_nchw(x), w.permute(3, 2, 0, 1).to(x.dtype), stride=stride)
    return _finish(_nhwc(y), b, activation, x.dtype)


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, stride: int = 2,
                     activation: Optional[Callable] = torch.relu
                     ) -> torch.Tensor:
    """slim.convolution2d_transpose, VALID, with tf.nn.conv2d_transpose
    sizing (n-1)·s + k. x [N, H, W, C], w [kh, kw, C, O]: output pixel
    (s·i + a, s·j + b) gets x[i, j] @ w[a, b]."""
    y = F.conv_transpose2d(_nchw(x), w.permute(2, 3, 0, 1).to(x.dtype),
                           stride=stride)
    return _finish(_nhwc(y), b, activation, x.dtype)


def max_pool(x: torch.Tensor, window: int = 2,
             stride: Optional[int] = None) -> torch.Tensor:
    """slim.max_pool2d, VALID (stride defaults to the window)."""
    stride = window if stride is None else stride
    return _nhwc(F.max_pool2d(_nchw(x), window, stride))


def center_crop_like(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Center-crop ``x`` spatially to ``target`` (the U-Net skip crop;
    offset = excess // 2, as tf.image.resize_image_with_crop_or_pad)."""
    th, tw = target.shape[1], target.shape[2]
    h, w = x.shape[1], x.shape[2]
    if h < th or w < tw:
        raise ValueError(f"cannot crop {h}x{w} to {th}x{tw}")
    oh, ow = (h - th) // 2, (w - tw) // 2
    return x[:, oh : oh + th, ow : ow + tw]
