"""The Bayesian U-Net's MC route: ``UNetS2DInference`` of a
``ModelConfig(bayesian=True)`` prepared in bf16 from the f32 params,
served by ``serving.MCServer``: a call (mask seed, x [B, H, W, 3]) returns
the mean and the variance of the sigmoid probabilities over
``route["mc_samples"]`` MC-dropout forwards and the argmax of the mean
(``UNetS2DInference.apply_mc``: the encoder once, the decoder at S·B).
``route["fault"] == "head_mask_off"`` (a fault of modes/serve_mc.py) runs
the MC head at rate 0: the decoder-end mask left off. No calibration."""

from __future__ import annotations

import torch

from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
from segmentation_tpu_torch.serving import MCServer

import systems


def calibration(cfg: dict, seed: int, device) -> list:
    return []


def model_config(cfg: dict) -> ModelConfig:
    return ModelConfig(n_classes=cfg["n_classes"],
                       input_dims=tuple(cfg["input_dims"]),
                       input_channel=cfg["input_channel"],
                       n_kernels=cfg["n_kernels"], bayesian=True,
                       dropout_rate=cfg["route"]["dropout_rate"])


def _head_mask_off(head):
    def op(*args, rate, **kw):
        return head(*args, rate=0.0, **kw)
    return op


def build(cfg: dict, params, calib, plain: bool = False) -> MCServer:
    route, ops = cfg["route"], systems.ops(plain)
    if route.get("fault") == "head_mask_off":
        ops = ops._replace(packed_conv2x2_mc_head=_head_mask_off(
            ops.packed_conv2x2_mc_head))
    model = UNetS2DInference(model_config(cfg), cfg["levels"], ops=ops)
    device = next(iter(params.values())).device
    prepared = model.prepare(params, dtype=torch.bfloat16, device=device)
    return MCServer(model, params, prepared, route["mc_samples"])
