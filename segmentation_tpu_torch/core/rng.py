"""Explicit random generators (segmentation_tpu.core.rng).

Everything random in the port draws from a ``torch.Generator`` built from a
seed, never from the global generator. Its numbers differ from
``jax.random``'s for the same seed: tests that compare the two packages make
their inputs with numpy and hand them to both.
"""

from __future__ import annotations

import torch


def generator(seed: int, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
