"""Carry weights between the JAX package and the port.

Both packages name parameters alike (``conv1_1/w``) and keep weights HWIO,
so the exchange is a dtype and container change, as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from segmentation_tpu_torch.models.unet_fast import head_diff, tile_bias4

# packed float weights the port's kernels read, by key suffix
_PACKED = ("w4", "w2", "w2a", "w2b", "wm")
# the TPU-layout fused-entry taps (conv_flat.entry_weights_pf2); the port's
# entry reads w4
_TPU_ONLY = ("we", "wh", "wl")


def params_from_jax(params: Mapping[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """JAX params (numpy or jax arrays, by name) → float32 port params."""
    return {name: torch.tensor(np.asarray(v, np.float32))
            for name, v in params.items()}


def prepared_from_jax(prepared: Mapping[str, np.ndarray], model,
                      device=None) -> Dict[str, torch.Tensor]:
    """A JAX ``UNetS2DInt8.prepare`` dict → the port's prepared dict, so
    both packages run on the same quantized weights and scales: int8
    ``wq*`` and f32 ``wscale*`` as they are, ``ascale*`` as 0-d f32 host
    tensors, biases f32, the other params and the packed float weights
    (w4, w2, w2a/w2b, wm) in bf16, the compute dtype; adds the packed
    sites' tiled ``b4`` and, for two classes, the mask head. A calibrated
    dict is planned for ``model`` (a ``UNetS2DInt8`` of the JAX model's
    ``quant_deconvs``: a dict prepared without it holds no ``wqm``, and
    its scale graph has no deconv site): the kernels' epilogue vectors are
    added once, here."""
    has_wqm = any(k.endswith("/wqm") for k in prepared)
    if has_wqm != (model.quant_deconvs and bool(model.sites.ups)):
        raise ValueError(
            f"the JAX dict was prepared with quant_deconvs={has_wqm}, the "
            f"model has quant_deconvs={model.quant_deconvs}")
    out: Dict[str, torch.Tensor] = {}
    for name, v in prepared.items():
        leaf = name.rsplit("/", 1)[-1]
        if leaf in _TPU_ONLY:
            continue
        a = np.asarray(v)
        if a.dtype == np.int8:
            out[name] = torch.tensor(a, device=device)
        elif leaf.startswith("ascale"):
            out[name] = torch.tensor(np.float32(a))
        elif leaf.startswith("wscale") or leaf == "b":
            out[name] = torch.tensor(a, dtype=torch.float32, device=device)
        else:
            out[name] = torch.tensor(a, dtype=torch.float32,
                                     device=device).to(torch.bfloat16)
    for name in list(out):
        site, leaf = name.rsplit("/", 1)
        if leaf in _PACKED:
            out[f"{site}/b4"] = tile_bias4(out[f"{site}/b"])
    if out["output/b"].shape[0] == 2:
        wd, bd = head_diff(out["output/w"].float(), out["output/b"])
        out["head/wd"] = wd.to(torch.bfloat16)
        out["head/bd"] = bd
    if any(k.endswith("/ascale") for k in out):
        model.plan(out)
    return out
