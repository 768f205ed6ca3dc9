"""The MC-dropout mask stream of the Bayesian U-Net, in plain PyTorch.

A counter-based integer hash: each mask bit is a pure function of (seed,
site, sample s, tile n, y, x, c) in the standard, unpacked coordinates of
the site's activation [H, W, C], so a plain reference draws the bits that
the kernels draw, in any order and any layout. The device version is
``csrc/mc_mask.cuh`` (the fan-out and the MC head include it; no mask
tensor is written on their path); this module is the plain version, and
imports nothing of the kernels. The stream (all arithmetic mod 2^32):

    mix(v)  = v ^= v >> 16; v *= 0x21f0aaad; v ^= v >> 15;
              v *= 0x735a2d97; v ^= v >> 15
    key     = mix(mix(mix(mix(mix(seed_lo ^ 0x9e3779b9) ^ seed_hi)
                  ^ site) ^ s) ^ n)
    g       = ((y W + x) C + c) >> 2
    byte(c) = (mix(mix(g) ^ key) >> 8 (c & 3)) & 0xff
    kept    = byte >= thr, thr = 256 · rate; a kept value × 256 / (256 − thr)

The rate is a multiple of 1/256 (0.5 is 128/256). Both multipliers of
mix are below 2^31, so int64 products of 32-bit values never overflow.
Sample s of tile n is image s·B + n of the decoder's batch (sample-major,
as the JAX package tiles MC samples on the batch axis).

JAX's MC-dropout draws Threefry bits, which no torch generator
reproduces; this stream replaces them (the same estimator: iid
Bernoulli(1 − rate) masks per activation element and sample).
"""

from __future__ import annotations

from typing import Tuple

import torch

SITES = {"bottleneck": 1, "head": 2}
_M32 = 0xFFFFFFFF


def mix(v):
    """The stream's 32-bit mixer on an int (mod 2^32) or an int64 tensor
    of values in [0, 2^32)."""
    v = v ^ (v >> 16)
    v = (v * 0x21F0AAAD) & _M32
    v = v ^ (v >> 15)
    v = (v * 0x735A2D97) & _M32
    return v ^ (v >> 15)


def split_seed(seed: int) -> Tuple[int, int]:
    """(seed_lo, seed_hi): a seed in [0, 2^64) as two 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"mask seed {seed} is outside [0, 2^64)")
    return seed & _M32, seed >> 32


def stream_key(seed: int, site: int, s: int, n: int) -> int:
    """The key of one (seed, site, sample, tile) stream."""
    lo, hi = split_seed(seed)
    k = mix(lo ^ 0x9E3779B9)
    for v in (hi, site, s, n):
        k = mix(k ^ v)
    return k


def threshold(rate: float) -> int:
    """thr = 256 · rate, the bytes below which an element is dropped."""
    thr = float(rate) * 256
    if not 0 <= thr < 256 or thr != int(thr):
        raise ValueError(f"dropout rate {rate} is not k/256, 0 <= k < 256")
    return int(thr)


def keep_scale(rate: float) -> float:
    """The multiplier of a kept value, 1 / (1 − rate)."""
    return 256.0 / (256 - threshold(rate))


def multiplier(seed: int, site: int, s: int, n: int, shape, rate: float,
               device=None) -> torch.Tensor:
    """The mask of one stream as f32 multipliers over an activation
    ``shape`` = (H, W, C): 0 where dropped, else ``keep_scale``."""
    big_h, big_w, c = shape
    thr, scale = threshold(rate), keep_scale(rate)
    key = stream_key(seed, site, s, n)
    yy = torch.arange(big_h, device=device, dtype=torch.int64)
    xx = torch.arange(big_w, device=device, dtype=torch.int64)
    cc = torch.arange(c, device=device, dtype=torch.int64)
    lin = ((yy.view(-1, 1, 1) * big_w + xx.view(1, -1, 1)) * c
           + cc.view(1, 1, -1))
    h = mix(mix((lin >> 2) & _M32) ^ key)
    byte = (h >> (8 * (cc & 3)).view(1, 1, -1)) & 0xFF
    return torch.where(byte >= thr, scale, 0.0).to(torch.float32)


def batch_multiplier(seed: int, site: int, samples: int, tiles: int, shape,
                     rate: float, device=None) -> torch.Tensor:
    """The masks of every (sample, tile) stream of a site, [samples ·
    tiles, H, W, C] f32, image s · tiles + n."""
    return torch.stack([multiplier(seed, site, s, n, shape, rate, device)
                        for s in range(samples) for n in range(tiles)])
