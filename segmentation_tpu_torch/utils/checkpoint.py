"""Read the JAX package's checkpoints (segmentation_tpu.utils.checkpoint).

A checkpoint is ``{save_dir}/{name}.ckpt-{step}.npz``: the flattened leaves
as ``leaf_0 … leaf_{n-1}`` plus ``__manifest__``, a JSON object with the
step and each leaf's key path (``jax.tree_util.keystr``), e.g.
``['conv1_1/w']`` for a bare params dict or ``.params['conv1_1/w']`` for a
trainer's TrainState. Weights stay HWIO, as both packages keep them.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Tuple

import numpy as np

_LAST_KEY = re.compile(r"^(?P<prefix>.*)\['(?P<name>[^']*)'\]$")


def read(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """All leaves keyed by their manifest key path, and the step."""
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        paths = manifest["paths"]
        leaves = {p: data[f"leaf_{i}"] for i, p in enumerate(paths)}
        if f"leaf_{len(paths)}" in data.files:
            raise ValueError(f"checkpoint {path} has more leaves than paths")
    return leaves, int(manifest["step"])


def load_params(path: str) -> Dict[str, np.ndarray]:
    """The named parameters of a checkpoint: a TrainState's ``.params``,
    else a bare params dict."""
    leaves, _ = read(path)
    by_prefix: Dict[str, Dict[str, np.ndarray]] = {}
    for p, arr in leaves.items():
        m = _LAST_KEY.match(p)
        if m:
            by_prefix.setdefault(m["prefix"], {})[m["name"]] = arr
    prefix = ".params" if ".params" in by_prefix else ""
    if prefix not in by_prefix:
        raise KeyError(f"checkpoint {path} holds no params dict "
                       f"(key prefixes: {sorted(by_prefix)})")
    return by_prefix[prefix]
