"""Carry weights between the JAX package and the port.

Both packages name parameters alike (``conv1_1/w``) and keep weights HWIO,
so the exchange is a dtype and container change, as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(params: Mapping[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """JAX params (numpy or jax arrays, by name) → float32 port params."""
    return {name: torch.as_tensor(np.asarray(v, np.float32))
            for name, v in params.items()}

