"""The traffic: inputs drawn from the seed on the device, and the windows
that drive the system with them. A mix file (``mixes/<name>.json``) sets
every parameter; this module is the one generator that reads them.

A serving window offers requests at the times its arrivals give and keeps
at most ``in_flight`` of them on the device: a request is submitted when
it is due and a slot is free, its class map is copied to pinned host
memory behind it, and it completes when that copy has landed. Arrivals:

- ``uniform``: one request every 1 / ``rate`` seconds (an open loop);
- ``backlog``: every request due at the start (load above capacity).

A request's latency runs from when it was due to when its masks are on
the host, so a stall counts against the requests queued behind it.
A training window calls the step on the pool's batches in turn.
"""

from __future__ import annotations

import collections
import math
import random
import time
from typing import Callable, Dict, List

import torch

from reference import sub_seed

DATA_STREAM, SAMPLE_STREAM = 1, 2


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    """The device's peak of allocated bytes (0 on the CPU)."""
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    """Return the allocator's cached blocks to the device."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def serve_inputs(cfg: dict, batch: int, count: int, seed: int, device,
                 stream: int = DATA_STREAM) -> List[torch.Tensor]:
    """``count`` bf16 image batches, uniform in [0, 1), drawn on the device
    in one call from the seed's ``stream``."""
    h, w = cfg["input_dims"]
    shape = (count, batch, h, w, cfg["input_channel"])
    x = torch.rand(shape, generator=_gen(seed, stream, device),
                   device=device)
    return list(x.to(torch.bfloat16).unbind(0))


def train_inputs(cfg: dict, batch: int, count: int, seed: int,
                 device) -> List[Dict[str, torch.Tensor]]:
    """``count`` batches of u8 images and masks, drawn on the device: a
    disc per image brightens channel 0 over uniform noise; the mask marks
    the disc as class 1 in three quarters of each batch's images and the
    rest of the image in the other quarter (which ones, the seed draws), so
    that the foreground's share runs from 5 % to 95 % and no two images
    pull the weights alike, while every batch's class-1 share is about a
    third: with half of the masks flipped, the batch's pull on the weights
    cancelled to near nothing on some seeds, and there bf16's rounding
    moved the first gradient's norms by a tenth."""
    h, w = cfg["input_dims"]
    c, n = cfg["input_channel"], count * batch
    g = _gen(seed, DATA_STREAM, device)
    noise = torch.rand((n, h, w, c), generator=g, device=device)
    geo = torch.rand((n, 4), generator=g, device=device)
    cy = (0.25 + 0.5 * geo[:, 0]) * h
    cx = (0.25 + 0.5 * geo[:, 1]) * w
    r = (0.125 + 0.2 * geo[:, 2]) * min(h, w)
    yy = torch.arange(h, device=device).view(1, h, 1)
    xx = torch.arange(w, device=device).view(1, 1, w)
    inside = ((yy - cy.view(n, 1, 1)) ** 2 + (xx - cx.view(n, 1, 1)) ** 2
              < r.view(n, 1, 1) ** 2)
    noise[..., 0] = noise[..., 0] * 0.6 + inside * 0.4
    images = torch.round(noise * 255).to(torch.uint8)
    rank = geo[:, 3].view(count, batch).argsort(dim=1).argsort(dim=1)
    flip = (rank < batch // 4).view(n, 1, 1)
    masks = (inside ^ flip).to(torch.uint8)[..., None]
    return [{"image": i, "mask": m} for i, m in
            zip(images.split(batch), masks.split(batch))]


def due_offsets(mix: dict, seconds: float) -> List[float]:
    """The seconds after the start at which each request of the window is
    due (``backlog``: an empty list, every request due at once)."""
    kind = mix["arrivals"]
    if kind == "backlog":
        return []
    rate = float(mix["rate"])
    n = int(math.ceil(seconds * rate))
    if kind == "uniform":
        return [i / rate for i in range(n)]
    raise ValueError(f"unknown arrivals {kind!r}")


class Reservoir:
    """A uniform sample of ``k`` completed requests, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen = k, 0
        self._rng = random.Random(sub_seed(seed, SAMPLE_STREAM))

    def offer(self) -> int:
        """The slot the next completed request takes in the sample, or
        -1."""
        self.seen += 1
        if self.seen <= self.k:
            return self.seen - 1
        j = self._rng.randrange(self.seen)
        return j if j < self.k else -1


def serve_window(call: Callable, pool: List[torch.Tensor], mix: dict,
                 seconds: float, seed: int, sample: int = 0) -> dict:
    """Drive ``call`` (one request → a device class map) for ``seconds``;
    the window's record: per request the latency from its due time and the
    time the call took to return (its dispatch), and a sample of answers
    with the pool index of each. While it waits for a request to fall due
    it completes those whose masks have landed."""
    in_flight = int(mix["in_flight"])
    offsets = due_offsets(mix, seconds)
    out0 = call(pool[0])
    cuda = out0.is_cuda
    bufs = [torch.empty(out0.shape, dtype=out0.dtype, pin_memory=cuda)
            for _ in range(in_flight + 1)]
    keep = Reservoir(sample, seed)
    kept: Dict[int, tuple] = {}
    lat, disp = [], []
    pending = collections.deque()
    sync(out0.device)

    def complete():
        i, due, tc, tr, buf, ev = pending.popleft()
        if ev is not None:
            ev.synchronize()
        lat.append(time.perf_counter() - due)
        disp.append(tr - tc)
        slot = keep.offer()
        if slot >= 0:
            kept[slot] = (i % len(pool), buf)
            bufs[i % len(bufs)] = torch.empty_like(buf, pin_memory=cuda)

    t0 = time.perf_counter()
    end, i = t0 + seconds, 0
    while True:
        if offsets:
            if i >= len(offsets):
                break
            due = t0 + offsets[i]
        elif time.perf_counter() >= end:
            break
        else:
            due = t0
        while len(pending) >= in_flight:
            complete()
        while time.perf_counter() < due:
            if pending and (pending[0][-1] is None
                            or pending[0][-1].query()):
                complete()
        tc = time.perf_counter()
        out = call(pool[i % len(pool)])
        tr = time.perf_counter()
        buf = bufs[i % len(bufs)]
        buf.copy_(out, non_blocking=True)
        ev = torch.cuda.Event() if cuda else None
        if ev is not None:
            ev.record()
        pending.append((i, due, tc, tr, buf, ev))
        i += 1
    while pending:
        complete()
    t_end = time.perf_counter()
    return {"requests": i, "images": i * out0.shape[0],
            "window_s": t_end - t0, "latency_s": lat, "dispatch_s": disp,
            "sample": [kept[s] for s in sorted(kept)]}


def train_window(step: Callable, pool: List[dict], seconds: float,
                 first: int = 0) -> dict:
    """Call ``step`` on the pool's batches in turn, from batch ``first``,
    until ``seconds`` have passed; the window ends in a synchronize."""
    losses = []
    device = pool[0]["image"].device
    sync(device)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() < t0 + seconds:
        losses.append(step(pool[(first + n) % len(pool)])["seg_loss"])
        n += 1
    sync(device)
    return {"steps": n, "window_s": time.perf_counter() - t0,
            "losses": losses}
