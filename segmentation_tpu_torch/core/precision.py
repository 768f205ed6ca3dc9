"""Mixed-precision policy (segmentation_tpu.core.precision): float32
parameters, bfloat16 activations and conv inputs."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16


DEFAULT = Policy()
