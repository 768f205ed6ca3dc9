"""The work a configuration asks of the chip, counted from its layer shapes:
operations and bytes, and the least time they allow on one NVIDIA H100
(SXM, 700 W; dense peaks of NVIDIA's data sheet).

Operations are those of the published layers: 2 · kh · kw · C · O per
output pixel of a conv, 2 · C · O per output pixel of the 2×2/2
transposed conv. Padding junk, recompute and the packed layouts' extra
columns are not counted, so no implementation of the same function can
reach more than 100 % of the bound. A train step is the forward, every
layer's weight gradient and every input gradient but conv1_1's (the image
needs none): three times the forward less conv1_1's once.

Bytes are the function's inputs, weights and outputs, each once: a
served request reads its bf16 image batch and the weights in their served
formats and writes the u8 class map; a train step reads the u8 image and
mask batch and reads and writes the f32 params and both Adam moments.
"""

from __future__ import annotations

from typing import Dict, List

PEAK_OPS = {"bf16": 989e12, "s8": 1979e12}   # dense tensor-core peaks, /s
PEAK_BYTES = 3.35e12                          # HBM3, bytes/s
WEIGHT_BYTES = {"bf16": 2, "s8": 1}


def layers(cfg: dict) -> List[dict]:
    """Every conv of the U-Net with its input and output shapes (a sample)
    and its precision: ``cfg["precision"]`` maps layer names to a format,
    ``"default"`` the rest."""
    L, k, c = cfg["levels"], cfg["n_kernels"], cfg["input_channel"]
    h, w = cfg["input_dims"]
    prec = cfg["precision"]
    out = []

    def add(name, kind, cin, cout, hi, wi, ho, wo):
        out.append({"name": name, "kind": kind, "cin": cin, "cout": cout,
                    "in": (hi, wi), "out": (ho, wo),
                    "precision": prec.get(name, prec["default"])})

    def conv3(name, cin, cout):
        nonlocal h, w
        add(name, "conv3", cin, cout, h, w, h - 2, w - 2)
        h, w = h - 2, w - 2

    skips = []
    for lvl in range(L):
        width = k * 2**lvl
        conv3(f"conv{lvl + 1}_1", c, width)
        conv3(f"conv{lvl + 1}_2", width, width)
        skips.append((h, w))
        h, w, c = h // 2, w // 2, width
    conv3(f"conv{L + 1}_1", c, k * 2**L)
    conv3(f"conv{L + 1}_2", k * 2**L, k * 2**L)
    c = k * 2**L
    for i, lvl in enumerate(reversed(range(L))):
        width = k * 2**lvl
        add(f"upconv{i + 1}", "deconv2", c, width, h, w, 2 * h, 2 * w)
        h, w = 2 * h, 2 * w
        conv3(f"conv{L + 2 + i}_1", 2 * width, width)
        conv3(f"conv{L + 2 + i}_2", width, width)
        c = width
    add("output", "conv1", c, cfg["n_classes"], h, w, h, w)
    return out


def layer_ops(layer: dict) -> float:
    """Forward operations of one layer, one sample."""
    ho, wo = layer["out"]
    taps = {"conv3": 9, "conv1": 1, "deconv2": 1}[layer["kind"]]
    return 2.0 * ho * wo * taps * layer["cin"] * layer["cout"]


def forward_ops(cfg: dict) -> Dict[str, float]:
    """{precision: forward operations of one sample}."""
    ops: Dict[str, float] = {}
    for layer in layers(cfg):
        ops[layer["precision"]] = (ops.get(layer["precision"], 0.0)
                                   + layer_ops(layer))
    return ops


def train_ops(cfg: dict) -> Dict[str, float]:
    """{precision: operations of one sample of a train step}: forward,
    weight gradients, input gradients but the first layer's."""
    ops: Dict[str, float] = {}
    for i, layer in enumerate(layers(cfg)):
        n = layer_ops(layer) * (3 if i else 2)
        ops[layer["precision"]] = ops.get(layer["precision"], 0.0) + n
    return ops


def weight_count(cfg: dict) -> Dict[str, int]:
    """{precision: weights}, and ``"bias"``: the biases."""
    out: Dict[str, int] = {"bias": 0}
    for layer in layers(cfg):
        taps = {"conv3": 9, "conv1": 1, "deconv2": 4}[layer["kind"]]
        n = taps * layer["cin"] * layer["cout"]
        out[layer["precision"]] = out.get(layer["precision"], 0) + n
        out["bias"] += layer["cout"]
    return out


def serve_bytes(cfg: dict, batch: int) -> float:
    h, w = cfg["input_dims"]
    ho, wo = layers(cfg)[-1]["out"]
    weights = sum(n * (4 if p == "bias" else WEIGHT_BYTES[p])
                  for p, n in weight_count(cfg).items())
    return batch * (h * w * cfg["input_channel"] * 2 + ho * wo) + weights


def train_bytes(cfg: dict, batch: int) -> float:
    h, w = cfg["input_dims"]
    params = sum(weight_count(cfg).values())
    return batch * h * w * (cfg["input_channel"] + 1) + params * 4 * 3 * 2


def compute_seconds(ops: Dict[str, float]) -> float:
    """The least time of ``ops`` at each precision's peak."""
    return sum(n / PEAK_OPS[p] for p, n in ops.items())


def least_seconds(cfg: dict, mode: str, batch: int) -> float:
    """The least time of one request (``serve``) or one step (``train``)
    of ``batch`` samples: the larger of the compute and the byte bound."""
    if mode == "train":
        ops = {p: n * batch for p, n in train_ops(cfg).items()}
        nbytes = train_bytes(cfg, batch)
    else:
        ops = {p: n * batch for p, n in forward_ops(cfg).items()}
        nbytes = serve_bytes(cfg, batch)
    return max(compute_seconds(ops), nbytes / PEAK_BYTES)


def unit_compute_seconds(cfg: dict, mode: str, batch: int) -> float:
    """The compute bound alone of one request or step (what ``mfu`` is
    measured against)."""
    per = train_ops(cfg) if mode == "train" else forward_ops(cfg)
    return compute_seconds({p: n * batch for p, n in per.items()})
