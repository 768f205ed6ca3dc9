"""The bf16 route: ``UNetS2DInference`` prepared in bf16 from the f32
params (H1–H4 on the packed levels, H8 bf16 on the std levels). No
calibration."""

from __future__ import annotations

import torch

from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
from segmentation_tpu_torch.serving import Server

import systems


def calibration(cfg: dict, seed: int, device) -> list:
    return []


def build(cfg: dict, params, calib, plain: bool = False) -> Server:
    model = UNetS2DInference(systems.model_config(cfg), cfg["levels"],
                             ops=systems.ops(plain))
    device = next(iter(params.values())).device
    prepared = model.prepare(params, dtype=torch.bfloat16, device=device)
    return Server(model, params, prepared)
