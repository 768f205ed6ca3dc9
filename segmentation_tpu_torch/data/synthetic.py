"""Synthetic segmentation data (segmentation_tpu.data.synthetic).

The numpy generator is the JAX package's, draw for draw, so one seed gives
the same batches in both packages.
"""

from __future__ import annotations

import numpy as np


class SyntheticSegmentation:
    """Random blob images with exact masks: a disc of a random radius placed
    per example; class = inside/outside (n_classes=2) or ring index."""

    has_masks = True

    def __init__(
        self,
        batch_size: int = 4,
        hw=(64, 64),
        channels: int = 3,
        n_classes: int = 2,
        seed: int = 0,
    ):
        self.batch_size = batch_size
        self.hw = tuple(hw)
        self.channels = channels
        self.n_classes = n_classes
        self._rng = np.random.default_rng(seed)

    def get_batch(self):
        h, w = self.hw
        n = self.batch_size
        yy, xx = np.mgrid[0:h, 0:w]
        images = self._rng.normal(0.5, 0.1, (n, h, w, self.channels)).astype(
            np.float32
        )
        masks = np.zeros((n, h, w, 1), np.uint8)
        for i in range(n):
            cy, cx = self._rng.integers(h // 4, 3 * h // 4), self._rng.integers(
                w // 4, 3 * w // 4
            )
            r = self._rng.integers(min(h, w) // 8, min(h, w) // 3)
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            inside = d2 < r * r
            if self.n_classes > 2:
                cls = 1 + (d2[inside] * (self.n_classes - 1) // (r * r)).astype(
                    np.uint8
                )
                masks[i, inside, 0] = np.clip(cls, 1, self.n_classes - 1)
            else:
                masks[i, inside, 0] = 1
            # Signal: the disc brightens channel 0
            images[i, :, :, 0] += inside * 0.4
        return {"image": np.clip(images, 0, 1), "mask": masks}


class SyntheticImages:
    """Image-only variant (autoencoder / GAN smoke data): the images of
    ``SyntheticSegmentation`` from the same seed."""

    has_masks = False

    def __init__(self, batch_size=4, hw=(32, 32), channels=3, seed=0):
        self.batch_size = batch_size
        self.hw = tuple(hw)
        self.channels = channels
        self._seg = SyntheticSegmentation(batch_size, hw, channels, 2, seed)

    def get_batch(self):
        return {"image": self._seg.get_batch()["image"]}
