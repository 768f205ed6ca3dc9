"""The U-Net 512² serving entry point (counterpart of __graft_entry__.entry).

    server, (x0,) = entry("cuda", batch=8)
    masks = server(x0)              # [8, 324, 324] u8 class map
    logits = server.logits(x0)      # [8, 324, 324, 2]

    server8, _ = entry("cuda", batch=8, int8=True, calib=[x_calib])
    server8_4d, _ = entry("cuda", batch=8, int8=True, calib=[x_calib],
                          padflat=False)   # or quant_deconvs=False

    server, (x0,) = entry("cuda", batch=2, mc_samples=8)   # 1024² tiles
    mean, var, cmap = server(seed, x0)  # MC-dropout: f32 [2, 836, 836, 2]
                                        # twice, u8 [2, 836, 836]

The flagship configuration (n_kernels = 32, n_classes = 2, 4 levels),
params from a seeded generator or a JAX ``.npz`` checkpoint, prepared once
for the packed forward: f32 params, bf16 activations; the packed sites run
the hand-written kernels. ``int8=True`` serves the calibrated int8 model
(models/unet_int8.py), the counterpart of the JAX CLI's ``infer --int8``:
the weights are quantized and the activation scales calibrated on
``calib`` (batches of images) once, at entry; ``padflat=False`` and
``quant_deconvs=False`` pick the JAX class's other int8 configurations
(models/unet_int8.py). ``mc_samples`` serves the Bayesian U-Net
(``ModelConfig(bayesian=True)``, the configuration of 1024² tiles): each
call takes a mask seed and returns the mean and the variance of the
sigmoid probabilities over ``mc_samples`` MC-dropout forwards and the
argmax of the mean (``UNetS2DInference.apply_mc``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.core.precision import DEFAULT
from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.interop import params_from_jax
from segmentation_tpu_torch.models.unet import init_params
from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8
from segmentation_tpu_torch.utils import trace
from segmentation_tpu_torch.utils.checkpoint import load_params


def flagship_config() -> ModelConfig:
    return ModelConfig(n_classes=2, input_dims=(512, 512), n_kernels=32)


@dataclasses.dataclass
class Server:
    """Serves requests, each in the span ``serve:request``
    (utils/trace.py)."""

    model: UNetS2DInference
    params: Dict[str, torch.Tensor]    # f32, standard U-Net layout
    prepared: Dict[str, torch.Tensor]  # packed, compute dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 3] → class map [N, h, w] u8."""
        with trace.span("serve:request"):
            return self.model.apply_argmax(self.prepared, x)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("serve:request"):
            return self.model.apply(self.prepared, x)


@dataclasses.dataclass
class MCServer:
    """Serves MC-dropout requests of the Bayesian U-Net, each in the span
    ``serve:request``: (mask seed, x [B, H, W, 3]) → (mean, var [B, h, w,
    2] f32, class map [B, h, w] u8) over ``samples`` forwards."""

    model: UNetS2DInference
    params: Dict[str, torch.Tensor]
    prepared: Dict[str, torch.Tensor]
    samples: int

    def __call__(self, seed: int, x: torch.Tensor):
        with trace.span("serve:request"):
            return self.model.apply_mc(self.prepared, x, seed, self.samples)


def mc_config(dropout_rate: float = 0.5) -> ModelConfig:
    """The Bayesian U-Net: the flagship widths on 1024² tiles."""
    return ModelConfig(n_classes=2, input_dims=(1024, 1024), n_kernels=32,
                       bayesian=True, dropout_rate=dropout_rate)


def entry(device="cuda", batch: int = 8, *, seed: int = 0,
          checkpoint: Optional[str] = None, int8: bool = False,
          calib: Optional[Sequence[torch.Tensor]] = None,
          padflat: bool = True, quant_deconvs: bool = True,
          mc_samples: int = 0, dropout_rate: float = 0.5):
    """(server, (x0,)): the prepared flagship server on ``device`` and a
    zero input batch of its shape in the compute dtype. With ``int8`` the
    server runs the calibrated int8 forward of UNetS2DInt8(cfg, padflat,
    quant_deconvs), calibrated on ``calib`` (default: one batch of
    ``batch`` uniform [0, 1) images drawn from ``seed``); the bf16
    forward is one function for either ``padflat``. With ``mc_samples``
    it is the MCServer of the Bayesian U-Net (``mc_config``) at
    ``dropout_rate``, bf16."""
    cfg = mc_config(dropout_rate) if mc_samples else flagship_config()
    if checkpoint is not None:
        params = params_from_jax(load_params(checkpoint))
    else:
        params = init_params(cfg, generator(seed))
    params = {k: v.to(device=device, dtype=DEFAULT.param_dtype)
              for k, v in params.items()}
    shape = (batch, *cfg.hw, cfg.input_channel)
    if mc_samples:
        if int8:
            raise ValueError("the MC server is bf16")
        model = UNetS2DInference(cfg)
        prepared = model.prepare(params, dtype=DEFAULT.compute_dtype,
                                 device=device)
        x0 = torch.zeros(shape, dtype=DEFAULT.compute_dtype, device=device)
        return MCServer(model, params, prepared, mc_samples), (x0,)
    if int8:
        if calib is None:
            calib = [torch.rand(shape, generator=generator(seed + 1, device),
                                device=device)]
        model = UNetS2DInt8(cfg, padflat=padflat,
                            quant_deconvs=quant_deconvs)
        prepared = model.prepare(params, calib_batches=calib,
                                 dtype=DEFAULT.compute_dtype, device=device)
    else:
        model = UNetS2DInference(cfg)
        prepared = model.prepare(params, dtype=DEFAULT.compute_dtype,
                                 device=device)
    x0 = torch.zeros(shape, dtype=DEFAULT.compute_dtype, device=device)
    return Server(model, params, prepared), (x0,)
