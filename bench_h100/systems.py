"""The system under test, built from a configuration file: the port's
server (``segmentation_tpu_torch.serving.Server``), which the route file
``routes/<kind>.py`` named by ``cfg["route"]["kind"]`` builds, or its
trainer (``SegmentationTrainer(UNetS2D(cfg))``). This module and
``routes/`` are the only files of the benchmark that import the program;
they hand it weights and inputs the benchmark made, and nothing the
program makes flows back but its answers.

``plain=True`` runs the kernels' plain PyTorch versions (the CPU
rehearsal).
"""

from __future__ import annotations

import tempfile
from typing import Callable, Dict, List, Sequence

import torch

import registry
from segmentation_tpu_torch.core.config import ModelConfig, TrainConfig
from segmentation_tpu_torch.models.unet_fast import UNetS2D
from segmentation_tpu_torch.nn.kernels import conv_flat
from segmentation_tpu_torch.training.trainer import SegmentationTrainer


def model_config(cfg: dict) -> ModelConfig:
    return ModelConfig(n_classes=cfg["n_classes"],
                       input_dims=tuple(cfg["input_dims"]),
                       input_channel=cfg["input_channel"],
                       n_kernels=cfg["n_kernels"])


def ops(plain: bool):
    return conv_flat.PLAIN_OPS if plain else conv_flat.KERNEL_OPS


def calibration(cfg: dict, seed: int, device) -> List[torch.Tensor]:
    """The calibration inputs of the configuration's route, drawn from the
    seed (``[]`` where the route has none)."""
    return registry.route(cfg["route"]["kind"]).calibration(cfg, seed,
                                                             device)


def server(cfg: dict, params: Dict[str, torch.Tensor],
           calib: Sequence[torch.Tensor], plain: bool = False):
    """The served route the configuration names (``cfg["route"]``)."""
    return registry.route(cfg["route"]["kind"]).build(cfg, params, calib,
                                                      plain)


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
                        ops=ops(plain))
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
