"""Model configuration (the fields of segmentation_tpu.core.config.ModelConfig
that the U-Net serving path reads, with the same names and defaults)."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


def _as_hw(dims) -> Tuple[int, int]:
    """An int or an [h, w] pair, as the JAX config accepts."""
    if isinstance(dims, int):
        return (dims, dims)
    h, w = dims
    return (int(h), int(w))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    n_classes: int = 2
    input_dims: Sequence[int] = (512, 512)
    input_channel: int = 3
    n_kernels: int = 32

    def __post_init__(self):
        object.__setattr__(self, "input_dims", _as_hw(self.input_dims))

    @property
    def hw(self) -> Tuple[int, int]:
        return _as_hw(self.input_dims)
