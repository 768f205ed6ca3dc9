"""Model and trainer configuration (the fields of
segmentation_tpu.core.config.ModelConfig and TrainConfig that the U-Net
serving and training paths read, with the same names and defaults)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


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
    # the Bayesian U-Net: MC-dropout at the bottleneck and before the head
    # (models/unet_fast.py apply_mc; serving.MCServer), at dropout_rate
    bayesian: bool = False
    dropout_rate: float = 0.5

    def __post_init__(self):
        object.__setattr__(self, "input_dims", _as_hw(self.input_dims))

    @property
    def hw(self) -> Tuple[int, int]:
        return _as_hw(self.input_dims)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    mode: str = "TRAINING"  # 'TRAINING' | 'INFERENCE'
    save_dir: str = "./snapshot"
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    load_snapshot: bool = False
    load_snapshot_from: Optional[str] = None
    max_to_keep: int = 1
    # the seed of the model's fresh params: UNetS2D(cfg, seed=train_cfg.seed)
    seed: int = 0
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # split each batch into k microbatches, average their grads, take one
    # optimizer step (the batch must divide by k)
    grad_accum: int = 1
