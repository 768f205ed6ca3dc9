"""U-Net (Ronneberger et al 2015), segmentation_tpu.models.unet in eager
PyTorch: the plain reference of the serving path.

A VALID-padded double-conv encoder of widths n_kernels × {1, 2, 4, 8, 16},
2×2/2 transposed-conv up stages with center-crop-and-concat skips, and a
1×1 class head. Like the JAX model (and unlike the TF reference's level-1
slip), every level pools the double-conv output. Parameters keep the JAX
names and HWIO layout (``conv1_1/w``, ``upconv1/b``, …), so one ``.npz``
checkpoint feeds both packages.

The Bayesian U-Net (Kendall & Gal, arXiv:1703.04977) is this network with
dropout after conv5_2's ReLU and after conv9_2's: ``forward`` takes the
two masks as explicit multipliers, and ``mc_moments`` reduces S sampled
forwards' sigmoid probabilities to the MC-dropout answer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.nn import initializers as init
from segmentation_tpu_torch.nn.layers import (
    center_crop_like,
    conv2d,
    conv2d_transpose,
    max_pool,
)
from segmentation_tpu_torch.nn.shapes import unet_output_hw


def unet_param_shapes(cfg: ModelConfig,
                      levels: int = 4) -> List[Tuple[str, tuple]]:
    """(name, HWIO shape) of every U-Net parameter, in declaration order."""
    k, out = cfg.n_kernels, []

    def conv(name, ci, co, ksz=3):
        out.extend([(f"{name}/w", (ksz, ksz, ci, co)), (f"{name}/b", (co,))])

    c = cfg.input_channel
    for lvl in range(levels):
        width = k * 2**lvl
        conv(f"conv{lvl + 1}_1", c, width)
        conv(f"conv{lvl + 1}_2", width, width)
        c = width
    conv(f"conv{levels + 1}_1", c, k * 2**levels)
    conv(f"conv{levels + 1}_2", k * 2**levels, k * 2**levels)
    c = k * 2**levels
    for i, lvl in enumerate(reversed(range(levels))):
        width = k * 2**lvl
        conv(f"upconv{i + 1}", c, width, ksz=2)
        conv(f"conv{levels + 2 + i}_1", 2 * width, width)
        conv(f"conv{levels + 2 + i}_2", width, width)
        c = width
    conv("output", c, cfg.n_classes, ksz=1)
    return out


def init_params(cfg: ModelConfig, gen: torch.Generator,
                levels: int = 4) -> Dict[str, torch.Tensor]:
    """Fresh params: xavier-uniform weights, zero biases."""
    return {
        name: (init.default_weight(gen, shape) if name.endswith("/w")
               else init.zeros(gen, shape))
        for name, shape in unet_param_shapes(cfg, levels)
    }


class UNet(nn.Module):
    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 levels: int = 4):
        super().__init__()
        self.cfg, self.levels = cfg, levels
        shapes = unet_param_shapes(cfg, levels)
        if set(params) != {n for n, _ in shapes}:
            raise ValueError("params do not match the U-Net's names")
        self.params = nn.ParameterDict(
            {n: nn.Parameter(torch.as_tensor(params[n]), requires_grad=False)
             for n, _ in shapes}
        )

    def output_hw(self, in_hw):
        return unet_output_hw(in_hw, self.levels)

    def param_dict(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.params.items()}

    def forward(self, x: torch.Tensor,
                masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """x [N, H, W, C] → logits [N, h, w, n_classes] (VALID-shrunk).
        ``masks`` = (bottleneck, decoder end): the MC-dropout multipliers
        (0 where dropped, else 1 / keep) of conv5_2's and conv9_2's ReLU
        outputs, each of that activation's shape."""
        oh, ow = self.output_hw(x.shape[1:3])
        if min(oh, ow) < 1:
            raise ValueError(
                f"input {x.shape[1]}x{x.shape[2]} collapses to {oh}x{ow} "
                f"through the {self.levels}-level VALID U-Net"
            )
        p = self.params

        def conv(h, name, activation=torch.relu):
            return conv2d(h, p[f"{name}/w"], p[f"{name}/b"], 1, activation)

        skips, h = [], x
        for lvl in range(self.levels):
            h = conv(conv(h, f"conv{lvl + 1}_1"), f"conv{lvl + 1}_2")
            skips.append(h)
            h = max_pool(h, 2)
        L = self.levels
        h = conv(conv(h, f"conv{L + 1}_1"), f"conv{L + 1}_2")
        if masks is not None:
            h = h * masks[0].to(h.dtype)
        for i, lvl in enumerate(reversed(range(L))):
            h = conv2d_transpose(h, p[f"upconv{i + 1}/w"],
                                 p[f"upconv{i + 1}/b"], 2)
            h = torch.cat([center_crop_like(skips[lvl], h), h], dim=-1)
            h = conv(conv(h, f"conv{L + 2 + i}_1"), f"conv{L + 2 + i}_2")
        if masks is not None:
            h = h * masks[1].to(h.dtype)
        return conv(h, "output", activation=None)


def mc_moments(probs: torch.Tensor):
    """probs [S, N, h, w, C], S sampled forwards' sigmoid probabilities →
    (the mean over the samples, their population variance (jnp.var's),
    the argmax of the mean as u8)."""
    mean = probs.mean(0)
    var = ((probs - mean) ** 2).mean(0)
    return mean, var, mean.argmax(-1).to(torch.uint8)
