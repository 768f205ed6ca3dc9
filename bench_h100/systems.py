"""The system under test, built from a configuration file: the port's
server (``segmentation_tpu_torch.serving.Server`` over
``UNetS2DInference`` or ``UNetS2DInt8``) or its trainer
(``SegmentationTrainer(UNetS2D(cfg))``). This is the one module of the
benchmark that imports the program; it hands it weights and inputs the
benchmark made, and nothing the program makes flows back but its answers.

``plain=True`` runs the kernels' plain PyTorch versions (the CPU
rehearsal).
"""

from __future__ import annotations

import tempfile
from typing import Callable, Dict, Sequence

import torch

from segmentation_tpu_torch.core.config import ModelConfig, TrainConfig
from segmentation_tpu_torch.models.unet_fast import UNetS2D, UNetS2DInference
from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8
from segmentation_tpu_torch.nn.kernels import conv_flat, conv_int8
from segmentation_tpu_torch.serving import Server
from segmentation_tpu_torch.training.trainer import SegmentationTrainer


def model_config(cfg: dict) -> ModelConfig:
    return ModelConfig(n_classes=cfg["n_classes"],
                       input_dims=tuple(cfg["input_dims"]),
                       input_channel=cfg["input_channel"],
                       n_kernels=cfg["n_kernels"])


def _ops(plain: bool):
    return conv_flat.PLAIN_OPS if plain else conv_flat.KERNEL_OPS


def server(cfg: dict, params: Dict[str, torch.Tensor],
           calib: Sequence[torch.Tensor], plain: bool = False) -> Server:
    """The served route the configuration names (``cfg["route"]``)."""
    mcfg, route = model_config(cfg), cfg["route"]
    device = next(iter(params.values())).device
    if route["kind"] == "bf16":
        model = UNetS2DInference(mcfg, cfg["levels"], ops=_ops(plain))
        prepared = model.prepare(params, dtype=torch.bfloat16, device=device)
    elif route["kind"] == "int8":
        model = UNetS2DInt8(
            mcfg, cfg["levels"], ops=_ops(plain), padflat=route["padflat"],
            ops8=conv_int8.PLAIN_OPS if plain else conv_int8.KERNEL_OPS,
            quant_deconvs=route["quant_deconvs"])
        prepared = model.prepare(params, calib_batches=list(calib),
                                 dtype=torch.bfloat16, device=device)
    else:
        raise ValueError(f"unknown route {route['kind']!r}")
    return Server(model, params, prepared)


class Trainer:
    """The port's trainer on the benchmark's weights, with what ``correct``
    reads of it: its params (a leaf per name) and Adam's first moment."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 plain: bool = False):
        device = next(iter(params.values())).device
        self._tmp = tempfile.TemporaryDirectory()
        tcfg = TrainConfig(save_dir=self._tmp.name,
                           learning_rate=cfg["train"]["lr"],
                           adam_beta1=cfg["train"]["beta1"])
        model = UNetS2D(model_config(cfg), cfg["levels"], params=params,
                        ops=_ops(plain))
        self.trainer = SegmentationTrainer(model, device=device,
                                           train_cfg=tcfg)
        self.step: Callable[[dict], Dict[str, float]] = self.trainer.train_step

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.trainer.model.params.items()}

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Adam's first moment of each leaf (zeros before its first
        step)."""
        state = self.trainer.optimizer.state
        return {k: state[v]["exp_avg"] if v in state else torch.zeros_like(v)
                for k, v in self.trainer.model.params.items()}

    def close(self) -> None:
        self._tmp.cleanup()
