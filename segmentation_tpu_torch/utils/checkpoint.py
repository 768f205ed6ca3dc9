"""Read and write the JAX package's checkpoints
(segmentation_tpu.utils.checkpoint).

A checkpoint is ``{save_dir}/{name}.ckpt-{step}.npz``: the flattened leaves
as ``leaf_0 … leaf_{n-1}`` plus ``__manifest__``, a JSON object with the
step and each leaf's key path (``jax.tree_util.keystr``), e.g.
``['conv1_1/w']`` for a bare params dict or ``.params['conv1_1/w']`` for a
trainer's TrainState. Weights stay HWIO, as both packages keep them.
Writes are atomic (a temporary file, then a rename) and keep the
``max_to_keep`` newest checkpoints of a name.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

_CKPT_RE = re.compile(r"^(?P<name>.+)\.ckpt-(?P<step>\d+)\.npz$")
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


def save(save_dir: str, name: str, step: int,
         leaves: Mapping[str, np.ndarray], max_to_keep: int = 1) -> str:
    """Write ``{save_dir}/{name}.ckpt-{step}.npz`` from leaves keyed by
    their key paths, in the order given (the order of the JAX pytree's
    leaves, so that the JAX package can restore the file), then prune."""
    os.makedirs(save_dir, exist_ok=True)
    final = os.path.join(save_dir, f"{name}.ckpt-{int(step)}.npz")
    paths = list(leaves)
    flat = {f"leaf_{i}": np.asarray(leaves[p]) for i, p in enumerate(paths)}
    manifest = json.dumps({"step": int(step), "paths": paths})
    fd, tmp = tempfile.mkstemp(dir=save_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __manifest__=manifest, **flat)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _rotate(save_dir, name, max_to_keep, int(step))
    return final


def _rotate(save_dir: str, name: str, max_to_keep: int, step: int) -> None:
    """Keep the ``max_to_keep`` newest checkpoints at or below ``step``;
    those above it are leftovers of an earlier run and go too."""
    ckpts = list_checkpoints(save_dir, name)
    stale = [p for p, s in ckpts if s > step]
    kept = [p for p, s in ckpts if s <= step]
    drop = stale + (kept[:-max_to_keep] if max_to_keep > 0 else [])
    for path in drop:
        os.unlink(path)


def list_checkpoints(save_dir: str,
                     name: Optional[str] = None) -> List[Tuple[str, int]]:
    """(path, step) of every checkpoint in ``save_dir``, by step."""
    if not os.path.isdir(save_dir):
        return []
    out = []
    for fn in os.listdir(save_dir):
        m = _CKPT_RE.match(fn)
        if m and (name is None or m["name"] == name):
            out.append((os.path.join(save_dir, fn), int(m["step"])))
    return sorted(out, key=lambda t: t[1])


def latest_checkpoint(save_dir: str,
                      name: Optional[str] = None) -> Optional[str]:
    ckpts = list_checkpoints(save_dir, name)
    return ckpts[-1][0] if ckpts else None
