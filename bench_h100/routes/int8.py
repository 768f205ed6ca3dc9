"""The calibrated int8 route: ``UNetS2DInt8`` with the route's
``padflat`` and ``quant_deconvs``, its scales calibrated on
``calib_batches`` seeded batches of ``calib_batch`` uniform images (the
seed's stream ``CALIB_STREAM``, apart from the requests')."""

from __future__ import annotations

import torch

from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8
from segmentation_tpu_torch.nn.kernels import conv_int8
from segmentation_tpu_torch.serving import Server

import drive
import systems

CALIB_STREAM = 4


def calibration(cfg: dict, seed: int, device) -> list:
    route = cfg["route"]
    return drive.serve_inputs(cfg, route["calib_batch"],
                              route["calib_batches"], seed, device,
                              stream=CALIB_STREAM)


def build(cfg: dict, params, calib, plain: bool = False) -> Server:
    route = cfg["route"]
    model = UNetS2DInt8(
        systems.model_config(cfg), cfg["levels"], ops=systems.ops(plain),
        padflat=route["padflat"],
        ops8=conv_int8.PLAIN_OPS if plain else conv_int8.KERNEL_OPS,
        quant_deconvs=route["quant_deconvs"])
    device = next(iter(params.values())).device
    prepared = model.prepare(params, calib_batches=list(calib),
                             dtype=torch.bfloat16, device=device)
    return Server(model, params, prepared)
