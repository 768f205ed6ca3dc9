"""Augmentation, host (numpy) and device (segmentation_tpu.data.augment).

The host crop is the JAX package's numpy code, draw for draw. The device
variant is the pipeline's tail on the staging batch: a joint per-sample
random crop and horizontal flip of image and mask, /255 to f32, and an
optional one-hot mask; the crop, flip and normalize run in H7
(nn/kernels/augment.py), which maps bytes to f32 as XLA compiles the JAX
function's x / 255 (x · f32(1/255)). Offsets come from an explicit
``torch.Generator``; ``device_augment_at`` takes them given, so that tests
can hand it the JAX function's offsets.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from segmentation_tpu_torch.nn.kernels.augment import (
    crop_normalize,
    crop_normalize_pair,
    random_offsets,
)


# --------------------------------------------------------------------- host
def host_joint_random_crop(
    rng: np.random.Generator,
    image: np.ndarray,
    mask: Optional[np.ndarray],
    crop: int,
    flip: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Numpy joint crop used by the decode workers. image HWC uint8; a
    source smaller than the crop is reflect-padded first."""
    h, w = image.shape[:2]
    if h < crop or w < crop:
        ph, pw = max(0, crop - h), max(0, crop - w)
        image = np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        if mask is not None:
            mask = np.pad(mask, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        h, w = image.shape[:2]
    y = int(rng.integers(0, h - crop + 1))
    x = int(rng.integers(0, w - crop + 1))
    image = image[y : y + crop, x : x + crop]
    if mask is not None:
        mask = mask[y : y + crop, x : x + crop]
    if flip and rng.random() < 0.5:
        image = image[:, ::-1]
        if mask is not None:
            mask = mask[:, ::-1]
    return image, mask


# ------------------------------------------------------------------- device
def one_hot_mask(mask: torch.Tensor, n_classes: int) -> torch.Tensor:
    """f32 one-hot [..., n_classes] of a class-index mask ([N,H,W] or
    [N,H,W,1]); an index outside [0, n_classes) is all zeros, as in
    ``jax.nn.one_hot``."""
    if mask.ndim == 4:
        mask = mask[..., 0]
    classes = torch.arange(n_classes, device=mask.device)
    return (mask.long()[..., None] == classes).float()


def device_augment_at(images_u8, masks_u8, ys, xs, flips, crop: int,
                      n_classes: int = 0):
    """``device_augment`` on given offsets ys, xs and flips [N]."""
    if masks_u8 is None:
        return crop_normalize(images_u8, ys, xs, flips, crop,
                              torch.float32), None
    imgs, masks = crop_normalize_pair(images_u8, masks_u8, ys, xs, flips,
                                      crop, torch.float32)
    if n_classes > 0:
        masks = one_hot_mask(masks, n_classes)
    return imgs, masks


def device_augment(generator: torch.Generator, images_u8, masks_u8,
                   crop: int, flip: bool = True, n_classes: int = 0):
    """Joint random crop (pixel-granular offsets) and flip of the u8
    staging batch [N,H,W,C] (and mask [N,H,W,1]), /255 to f32.

    Returns (images f32 [N,crop,crop,C], masks u8 [N,crop,crop,1] or
    one-hot f32 [N,crop,crop,n_classes] or None)."""
    return device_augment_at(
        images_u8, masks_u8,
        *random_offsets(generator, images_u8.shape, crop, flip), crop,
        n_classes)
