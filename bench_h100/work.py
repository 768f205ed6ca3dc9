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

A site (one ``seg:fwd:<site>`` or ``seg:bwd:<site>/<part>`` span of the
program) computes the layers ``site_layers`` names; its least time
(``site_least_s``) is that of its published function at one precision
per layer: a fused chain reads its first layer's input and writes its last
layer's output, and an intermediate never counts. A ``dgrad`` part has the
forward's operations, reads the output gradient and the weight and writes
the input gradient (the image's first layer has none); a ``wgrad`` part has
the forward's operations, reads the input and the output gradient and
writes the weight gradient.
"""

from __future__ import annotations

from typing import Dict, List

PEAK_OPS = {"bf16": 989e12, "s8": 1979e12}   # dense tensor-core peaks, /s
PEAK_BYTES = 3.35e12                          # HBM3, bytes/s
WEIGHT_BYTES = {"bf16": 2, "s8": 1}
PARTS = ("fwd", "dgrad", "wgrad")
TAPS = {"conv3": 9, "conv1": 1, "deconv2": 4}   # weights a (cin, cout) pair


def layers(cfg: dict) -> List[dict]:
    """Every conv of the U-Net with its input and output shapes (a sample)
    and its precision: ``cfg["precision"]`` maps layer names to a format,
    ``"default"`` the rest."""
    L, k, c = cfg["levels"], cfg["n_kernels"], cfg["input_channel"]
    h, w = cfg["input_dims"]
    prec = cfg["precision"]
    out = []

    def add(name, kind, cin, cout, hi, wi, ho, wo):
        out.append({"name": name, "index": len(out), "kind": kind,
                    "cin": cin, "cout": cout,
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
        n = TAPS[layer["kind"]] * layer["cin"] * layer["cout"]
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


def _mode(name: str):
    import registry  # the harness's directory is on the path (run.py)

    return registry.mode(name)


def least_seconds(cfg: dict, mode: str, batch: int) -> float:
    """The least time of one unit of ``mode``'s work (a request, a step) of
    ``batch`` samples, as ``modes/<mode>.py`` counts it from the functions
    here."""
    return _mode(mode).least_seconds(cfg, batch)


def unit_compute_seconds(cfg: dict, mode: str, batch: int) -> float:
    """The compute bound alone of one unit of ``mode``'s work (what ``mfu``
    is measured against)."""
    return _mode(mode).unit_compute_seconds(cfg, batch)


def site_layers(cfg: dict, site: str) -> List[dict]:
    """The layers that a span's site computes: ``conv1_1+conv1_2`` both
    convs, ``head`` the 1×1 ``output``; a site that computes no published
    layer (``std_pool``, ``unpack``, ``input``, ``loss``, ``pack_weights``,
    ``(no site)``) none."""
    by_name = {l["name"]: l for l in layers(cfg)}
    names = ["output" if n == "head" else n for n in site.split("+")]
    return [by_name[n] for n in names if n in by_name]


def part_ops(layer: dict, part: str) -> float:
    """Operations of one sample of a layer's ``part``: each part has the
    forward's, but the image's layer has no input gradient."""
    if part not in PARTS:
        raise ValueError(f"unknown part {part!r}")
    return 0.0 if part == "dgrad" and layer["index"] == 0 else layer_ops(
        layer)


def _tensor_bytes(layer: dict, side: str, batch: int) -> float:
    """A layer's input (``in``) or output (``out``) batch in its precision;
    the head's output as the u8 class map that serving writes, the least
    any implementation must."""
    (h, w), e = layer[side], WEIGHT_BYTES[layer["precision"]]
    if side == "out" and layer["name"] == "output":
        return batch * h * w
    return batch * h * w * layer["cin" if side == "in" else "cout"] * e


def _weight_bytes(layer: dict) -> float:
    e = WEIGHT_BYTES[layer["precision"]]
    return TAPS[layer["kind"]] * layer["cin"] * layer["cout"] * e


def layer_bytes(layer: dict, part: str, batch: int) -> float:
    """Bytes a layer's ``part`` must move for ``batch`` samples: the
    forward reads x, the weight and the f32 bias and writes y; the dgrad
    reads dy and the weight and writes dx; the wgrad reads x and dy and
    writes dw."""
    x, y = _tensor_bytes(layer, "in", batch), _tensor_bytes(layer, "out",
                                                            batch)
    w = _weight_bytes(layer)
    if part == "fwd":
        return x + w + 4 * layer["cout"] + y
    if part == "dgrad":
        return 0.0 if layer["index"] == 0 else y + w + x
    if part == "wgrad":
        return x + y + w
    raise ValueError(f"unknown part {part!r}")


def layer_least_s(layer: dict, part: str, batch: int) -> float:
    """max(operations ÷ the precision's peak, bytes ÷ HBM's) of a layer's
    ``part`` for ``batch`` samples."""
    ops = part_ops(layer, part) * batch / PEAK_OPS[layer["precision"]]
    return max(ops, layer_bytes(layer, part, batch) / PEAK_BYTES)


def site_least_s(cfg: dict, site: str, part: str, batch: int) -> float:
    """The least time of a site's ``part`` for ``batch`` samples. A fused
    forward chain is one function: its operations at each layer's peak,
    and its first input, every weight and bias and its last output once."""
    chain = site_layers(cfg, site)
    if part != "fwd" or len(chain) < 2:
        return sum(layer_least_s(l, part, batch) for l in chain)
    ops = sum(layer_ops(l) * batch / PEAK_OPS[l["precision"]] for l in chain)
    nbytes = (_tensor_bytes(chain[0], "in", batch)
              + _tensor_bytes(chain[-1], "out", batch)
              + sum(_weight_bytes(l) + 4 * l["cout"] for l in chain))
    return max(ops, nbytes / PEAK_BYTES)
