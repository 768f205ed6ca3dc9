"""The work of the Bayesian U-Net's MC-dropout request, counted from its
layer shapes (work.py's layers and peaks): the least any implementation
of the function must do.

A tile's least work is its encoder once and its decoder S times: the
encoder (conv1_1 … conv5_2) computes the same for every sample, and the
masks enter only at the bottleneck and after conv9_2. At 1024², n_kernels
32: 125.4 + 8 × 172.9 = 1,508.5 GFLOP a tile; S whole forwards would
count 2,386.6 and read 1.58 times the share. The bytes of a request: the
bf16 image batch in, the weights once, and out the mean and the variance
of the class probabilities (f32) and the u8 class map.

The least times of the MC path's own kernels (the rooflines of
``metrics/mc_*_roofline.mc.py``):

- the fan-out reads the bottleneck's B activations once and writes S·B
  dropped copies, bf16 (bytes);
- the MC head (``conv9_2+mc_head``) is conv9_2 and the 1×1 head at S·B:
  their operations, and it reads conv9_2's input and the weights and
  writes the f32 probabilities of each class (the larger bound);
- the moments read the S·B probabilities and write the mean, the
  variance and the map of the B tiles (bytes).
"""

from __future__ import annotations

from typing import Dict, List

import work

F32 = 4


def split(cfg: dict):
    """(encoder layers through the bottleneck, decoder layers with the
    head)."""
    layers = work.layers(cfg)
    last = [l["name"] for l in layers].index(f"conv{cfg['levels'] + 1}_2")
    return layers[:last + 1], layers[last + 1:]


def samples(cfg: dict) -> int:
    return int(cfg["route"]["mc_samples"])


def tile_ops(cfg: dict) -> Dict[str, float]:
    """{precision: operations of one tile}: the encoder once, the decoder
    S times."""
    enc, dec = split(cfg)
    out: Dict[str, float] = {}
    for layers, times in ((enc, 1), (dec, samples(cfg))):
        for l in layers:
            out[l["precision"]] = (out.get(l["precision"], 0.0)
                                   + times * work.layer_ops(l))
    return out


def request_bytes(cfg: dict, batch: int) -> float:
    h, w = cfg["input_dims"]
    ho, wo = work.layers(cfg)[-1]["out"]
    nc = cfg["n_classes"]
    weights = sum(n * (F32 if p == "bias" else work.WEIGHT_BYTES[p])
                  for p, n in work.weight_count(cfg).items())
    return (batch * (h * w * cfg["input_channel"] * 2
                     + ho * wo * (2 * nc * F32 + 1)) + weights)


def compute_seconds(cfg: dict, batch: int) -> float:
    return work.compute_seconds({p: n * batch for p, n in
                                 tile_ops(cfg).items()})


def least_seconds(cfg: dict, batch: int) -> float:
    return max(compute_seconds(cfg, batch),
               request_bytes(cfg, batch) / work.PEAK_BYTES)


def fanout_least_s(cfg: dict, batch: int) -> float:
    """The bottleneck's B activations read, S·B written, bf16."""
    enc, _ = split(cfg)
    (h, w), c = enc[-1]["out"], enc[-1]["cout"]
    return (1 + samples(cfg)) * batch * h * w * c * 2 / work.PEAK_BYTES


def head_least_s(cfg: dict, images: int) -> float:
    """conv9_2 and the head for ``images`` decoder images: their
    operations, or their input, weights and f32 probabilities."""
    conv, head = work.layers(cfg)[-2:]
    ops = sum(work.layer_ops(l) * images / work.PEAK_OPS[l["precision"]]
              for l in (conv, head))
    (hi, wi), (ho, wo) = conv["in"], head["out"]
    nbytes = (images * (hi * wi * conv["cin"] * 2
                        + ho * wo * head["cout"] * F32)
              + sum(work.TAPS[l["kind"]] * l["cin"] * l["cout"] * 2
                    + F32 * l["cout"] for l in (conv, head)))
    return max(ops, nbytes / work.PEAK_BYTES)


def moments_least_s(cfg: dict, batch: int) -> float:
    """S·B probabilities read; B means, variances and maps written."""
    (ho, wo), nc = work.layers(cfg)[-1]["out"], cfg["n_classes"]
    nbytes = batch * ho * wo * (samples(cfg) * nc * F32 + 2 * nc * F32 + 1)
    return nbytes / work.PEAK_BYTES


def decoder_sites(cfg: dict) -> List[str]:
    """The decoder's site spans in order, the last conv fused with the MC
    head."""
    _, dec = split(cfg)
    names = [l["name"] for l in dec if l["name"] != "output"]
    return names[:-1] + [names[-1] + "+mc_head"]


def decoder_least_s(cfg: dict, batch: int) -> float:
    """The decoder's least time at S·B: each site's published function
    (work.site_least_s), the MC head's ``head_least_s``."""
    images = samples(cfg) * batch
    *sites, _ = decoder_sites(cfg)
    return (sum(work.site_least_s(cfg, s, "fwd", images) for s in sites)
            + head_least_s(cfg, images))
