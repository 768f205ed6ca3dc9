"""Weight initializers (segmentation_tpu.nn.initializers): slim defaults,
xavier/glorot uniform for conv weights and zeros for biases. Every
initializer takes an explicit ``torch.Generator``."""

from __future__ import annotations

import math

import torch


def zeros(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])  # conv kernels are HWIO
    return shape[-2] * receptive, shape[-1] * receptive


def xavier_uniform(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return u * (2 * limit) - limit


default_weight = xavier_uniform
