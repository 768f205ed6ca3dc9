"""The plain reference of the Bayesian U-Net's MC-dropout answer: the f32
U-Net of ``reference.py`` with dropout after conv5_2's ReLU and after
conv9_2's (Kendall & Gal, arXiv:1703.04977; nathanin/segmentation
examples/inference.py:30-61), S stochastic forwards of each tile reduced
to the mean and the population variance of the sigmoid class
probabilities. Plain PyTorch only: it imports nothing of the program
under test.

The masks are redrawn here from the request's mask seed by the program's
stream, re-implemented in torch integer ops (all arithmetic mod 2^32):

    mix(v)  = v ^= v >> 16; v *= 0x21f0aaad; v ^= v >> 15;
              v *= 0x735a2d97; v ^= v >> 15
    key     = mix(mix(mix(mix(mix(seed_lo ^ 0x9e3779b9) ^ seed_hi)
                  ^ site) ^ s) ^ n)                 site 1: conv5_2, 2: conv9_2
    byte(c) = (mix(mix(((y W + x) C + c) >> 2) ^ key) >> 8 (c & 3)) & 0xff
    kept    = byte >= 256 · rate, scaled by 1 / (1 − rate)

in the standard coordinates (y, x, c) of the site's activation [H, W, C],
for sample s of tile n. One sample's forward of one tile runs at a time,
so that the f32 activations of a 1024² tile fit beside the program's
freed memory. ``formats`` rounds each conv's input and weight as
``reference.UNetRef`` does (the stated precision, the controls).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

import reference

_M32 = 0xFFFFFFFF
BOTTLENECK, HEAD = 1, 2


def mix(v):
    """The 32-bit mixer on an int or an int64 tensor in [0, 2^32)."""
    v = v ^ (v >> 16)
    v = (v * 0x21F0AAAD) & _M32
    v = v ^ (v >> 15)
    v = (v * 0x735A2D97) & _M32
    return v ^ (v >> 15)


def stream_key(seed: int, site: int, s: int, n: int) -> int:
    k = mix((int(seed) & _M32) ^ 0x9E3779B9)
    for v in (int(seed) >> 32, site, s, n):
        k = mix(k ^ v)
    return k


def multiplier(seed: int, site: int, s: int, n: int, shape, rate: float,
               device) -> torch.Tensor:
    """The mask of stream (seed, site, s, n) over an activation ``shape``
    = (H, W, C): f32, 0 where dropped, else 1 / (1 − rate)."""
    thr = int(round(rate * 256))
    big_h, big_w, c = shape
    yy = torch.arange(big_h, device=device, dtype=torch.int64)
    xx = torch.arange(big_w, device=device, dtype=torch.int64)
    cc = torch.arange(c, device=device, dtype=torch.int64)
    lin = ((yy.view(-1, 1, 1) * big_w + xx.view(1, -1, 1)) * c
           + cc.view(1, 1, -1))
    h = mix(mix((lin >> 2) & _M32) ^ stream_key(seed, site, s, n))
    byte = (h >> (8 * (cc & 3)).view(1, 1, -1)) & 0xFF
    return torch.where(byte >= thr, 256.0 / (256 - thr), 0.0).to(
        torch.float32)


class MCRef(reference.UNetRef):
    """The U-Net with the two dropout sites, on one tile at a time."""

    def forward_masked(self, x: torch.Tensor, seed: int, s: int, n: int,
                       rates: Tuple[float, float]) -> torch.Tensor:
        """x [1, H, W, C], tile n of the request, sample s → f32 logits
        [1, h, w, C']."""
        L = self.cfg["levels"]
        h = x.float().permute(0, 3, 1, 2)
        conv = lambda name, t: torch.relu(self._layer(name, t, F.conv2d))

        def drop(t, site, rate):
            shape = (t.shape[2], t.shape[3], t.shape[1])
            m = multiplier(seed, site, s, n, shape, rate, t.device)
            return t * m.permute(2, 0, 1).unsqueeze(0)

        skips = []
        for lvl in range(L):
            h = conv(f"conv{lvl + 1}_2", conv(f"conv{lvl + 1}_1", h))
            skips.append(h)
            h = F.max_pool2d(h, 2)
        h = conv(f"conv{L + 1}_2", conv(f"conv{L + 1}_1", h))
        h = drop(h, BOTTLENECK, rates[0])
        for i, lvl in enumerate(reversed(range(L))):
            h = torch.relu(self._layer(f"upconv{i + 1}", h,
                                       F.conv_transpose2d, stride=2))
            sk = skips[lvl]
            hh, ww = h.shape[2], h.shape[3]
            oy, ox = (sk.shape[2] - hh) // 2, (sk.shape[3] - ww) // 2
            h = torch.cat([sk[:, :, oy:oy + hh, ox:ox + ww], h], dim=1)
            h = conv(f"conv{L + 2 + i}_2", conv(f"conv{L + 2 + i}_1", h))
        h = drop(h, HEAD, rates[1])
        return self._layer("output", h, F.conv2d).permute(0, 2, 3, 1)


def sampled_probs(cfg: dict, params: Dict[str, torch.Tensor],
                  x: torch.Tensor, seed: int, samples: int, rate: float,
                  formats: Optional[Dict[str, str]] = None,
                  rates: Optional[Tuple[float, float]] = None
                  ) -> torch.Tensor:
    """[samples, B, h, w, C'] f32 sigmoid probabilities of the request
    (x [B, H, W, C], its mask seed), one tile and one sample at a time."""
    net = MCRef(cfg, params, formats)
    rates = rates or (rate, rate)
    with torch.no_grad(), reference.exact_f32():
        return torch.stack([
            torch.cat([torch.sigmoid(net.forward_masked(
                x[n:n + 1], seed, s, n, rates)) for n in range(x.shape[0])])
            for s in range(samples)])


def moments(probs: torch.Tensor):
    """(mean, population variance) over the samples, f32."""
    mean = probs.mean(0)
    return mean, ((probs - mean) ** 2).mean(0)
