"""Configuration, precision policy and random generators."""

from segmentation_tpu_torch.core.config import ModelConfig, TrainConfig
from segmentation_tpu_torch.core.precision import DEFAULT, Policy
from segmentation_tpu_torch.core.rng import generator

__all__ = ["DEFAULT", "ModelConfig", "Policy", "TrainConfig", "generator"]
