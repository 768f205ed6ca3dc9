"""A served cell of the Bayesian U-Net: requests of the mix's B tiles, each
with a fresh mask seed, against the configuration's MC route
(``routes/bf16_mc.py``): the answer is the mean and the variance over S
MC-dropout forwards of each class's sigmoid probability, and the argmax
of the mean, in pinned host memory. Its work is the encoder once and the
decoder S times a tile (work_mc.py); S whole forwards would count 1.58
times too much.

The window (``window``) is drive.serve_window's with the MC call: due
times from ``drive.due_offsets``, at most ``in_flight`` requests on the
device, a uniform sample (``drive.Reservoir``) kept with its pool index
and mask seed. The three answers (23.8 MB a request at 1024², B = 2) are
copied to pinned host memory on a copy stream that waits for the
request, as a pipeline that serves tiles overlaps them: the copy of one
request runs beside the next one's kernels, and a request completes when
its copy has landed.

``correct`` holds the sampled requests' own answers against the plain
f32 reference (reference_mc.py), redrawn from each request's mask seed,
over every pixel: ``mc_gap`` is the mean |Δ| of the mean and the variance
(all their elements together) against the reference's, ``mc_gap_ratio``
that over the same gap of the plain computation at the stated precision
(each conv's input and weight in bf16, the same masks), as ``gap_ratio``
is for the class maps of the other serving cells; ``mask_gap`` is
check.request_stats' widest gap of the served map under the reference's
mean probabilities, over the RMS of their margin. The control is the
reference with fp8 e4m3 convs (``cfg["control"]["serve"]``); the faults
are the program with the decoder-end mask left off, and with sample 0's
masks used for all S samples (one sample: the mean is that sample's and
the variance 0)."""

from __future__ import annotations

import collections
import math
import random
import time
from typing import Callable, Dict, List

import torch

import check
import devtrace
import drive
import reference
import reference_mc
import systems
import work_mc

MASK_STREAM, TRACE_MASK_STREAM = 3, 4


def _seeds(seed: int, stream: int) -> Callable[[], int]:
    """The request's mask seeds: 64-bit draws from the run's seed."""
    rng = random.Random(reference.sub_seed(seed, stream))
    return lambda: rng.getrandbits(64)


def window(server, pool: List[torch.Tensor], mix: dict, seconds: float,
           seed: int, sample: int = 0, stream: int = MASK_STREAM) -> dict:
    """Drive ``server`` (mask seed, x → mean, var, map on the device) for
    ``seconds``: drive.serve_window's record, each kept answer as (pool
    index, mask seed, (mean, var, map) on the host)."""
    in_flight = int(mix["in_flight"])
    offsets = drive.due_offsets(mix, seconds)
    draw = _seeds(seed, stream)
    out0 = server(draw(), pool[0])
    cuda = out0[0].is_cuda

    def host():
        return tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
                     for t in out0)

    bufs = [host() for _ in range(in_flight + 1)]
    copy_stream = torch.cuda.Stream(out0[0].device) if cuda else None
    keep = drive.Reservoir(sample, seed)
    kept: Dict[int, tuple] = {}
    lat, disp = [], []
    pending = collections.deque()
    drive.sync(out0[0].device)

    def complete():
        i, mseed, due, tc, tr, buf, ev = pending.popleft()
        if ev is not None:
            ev.synchronize()
        lat.append(time.perf_counter() - due)
        disp.append(tr - tc)
        slot = keep.offer()
        if slot >= 0:
            kept[slot] = (i % len(pool), mseed, buf)
            bufs[i % len(bufs)] = host()

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
        mseed = draw()
        tc = time.perf_counter()
        out = server(mseed, pool[i % len(pool)])
        tr = time.perf_counter()
        buf = bufs[i % len(bufs)]
        ev = None
        if cuda:
            copy_stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(copy_stream):
                for b, o in zip(buf, out):
                    o.record_stream(copy_stream)
                    b.copy_(o, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
        else:
            for b, o in zip(buf, out):
                b.copy_(o)
        pending.append((i, mseed, due, tc, tr, buf, ev))
        i += 1
    while pending:
        complete()
    t_end = time.perf_counter()
    return {"requests": i, "images": i * out0[0].shape[0],
            "window_s": t_end - t0, "latency_s": lat, "dispatch_s": disp,
            "sample": [kept[s] for s in sorted(kept)]}


def _gap(got, want) -> float:
    """The mean |Δ| over every element of the mean and the variance."""
    n = sum(w.numel() for w in want)
    return float(sum((g.to(w.device) - w).abs().sum()
                     for g, w in zip(got, want))) / n


def request_stats(cfg, params, x, mseed, served) -> dict:
    """The compared numbers of one request: ``served`` = (mean, var, map)
    of the program (or a control) for images x and mask seed ``mseed``."""
    s, rate = work_mc.samples(cfg), cfg["route"]["dropout_rate"]
    ref = reference_mc.moments(reference_mc.sampled_probs(
        cfg, params, x, mseed, s, rate))
    plain = reference_mc.moments(reference_mc.sampled_probs(
        cfg, params, x, mseed, s, rate, check.stated_formats(cfg)))
    mean, var, cmap = served
    gap, base = _gap((mean, var), ref), _gap(plain, ref)
    st = check.request_stats(ref[0], cmap.to(ref[0].device))
    st["mc_gap"] = gap
    st["mc_gap_ratio"] = (gap / base if base > 0
                          else (math.inf if gap > 0 else 0.0))
    return st


def sample_stats(cfg, params, pool, sample) -> List[dict]:
    return [request_stats(cfg, params, pool[j], mseed, served)
            for j, mseed, served in sample]


def run(cell, seed, seconds, trace, device, plain):
    cfg, mix = cell.cfg, cell.mix
    params = reference.make_params(cfg, seed, device)
    server = systems.server(cfg, params, [], plain)
    pool = drive.serve_inputs(cfg, mix["batch"], mix["pool"], seed, device)
    warm = _seeds(seed, TRACE_MASK_STREAM)
    for x in pool:
        for t in server(warm(), x):
            t.cpu()
    rec = {"set_up_at": time.perf_counter()}
    rec["window"] = window(server, pool, mix, seconds, seed, mix["sample"])
    rec["attempted"] = rec["window"]["requests"]
    if trace:
        win, red = devtrace.traced(lambda: window(
            server, pool, mix, mix["trace_seconds"], seed,
            stream=TRACE_MASK_STREAM), device.type == "cuda")
        rec["trace"] = {**red, "units": win["requests"],
                        "window_s": win["window_s"]}
    rec["memory_peak_bytes"] = drive.memory_peak(device)
    del server
    drive.free(device)
    rec["stats"] = sample_stats(cfg, params, pool, rec["window"]["sample"])
    rec["failed"] = check.failed_requests(rec["stats"], cell.limits)
    if trace:
        rec["trace"]["setup_s_by_span"] = devtrace.setup_spans(
            lambda: systems.server(cfg, params, [], plain))
    return rec, check.worst(rec["stats"])


def least_seconds(cfg: dict, batch: int) -> float:
    """One request of ``batch`` tiles: the larger of the compute and the
    byte bound (work_mc.py)."""
    return work_mc.least_seconds(cfg, batch)


def unit_compute_seconds(cfg: dict, batch: int) -> float:
    """The compute bound alone of one request: the encoder once and the
    decoder S times a tile (what ``mfu.mc`` is measured against)."""
    return work_mc.compute_seconds(cfg, batch)


FAULTS = {"fault_head_mask_off": lambda r: {**r, "fault": "head_mask_off"},
          "fault_one_sample": lambda r: {**r, "mc_samples": 1}}


def fault_stats(cell, seed, sample, device, plain=False) -> dict:
    """Each fault's worst numbers on the run's own sample: the program
    built with the fault, served the sampled requests' images and mask
    seeds, held against the sound reference."""
    cfg = cell.cfg
    params = reference.make_params(cfg, seed, device)
    pool = drive.serve_inputs(cfg, cell.mix["batch"], cell.mix["pool"], seed,
                              device)
    out = {}
    for name, fault in FAULTS.items():
        srv = systems.server({**cfg, "route": fault(cfg["route"])}, params,
                             [], plain)
        served = [(j, mseed, [t.cpu() for t in srv(mseed, pool[j])])
                  for j, mseed, _ in sample]
        del srv
        drive.free(device)
        out[name] = check.worst(sample_stats(cfg, params, pool, served))
    return out


def control_stats(cell, seed, sample, device) -> dict:
    """The fp8 control's worst numbers on the run's own sample: the
    reference with the control's formats as the served answer."""
    cfg, ctl = cell.cfg, cell.cfg["control"]["serve"]
    params = reference.make_params(cfg, seed, device)
    pool = drive.serve_inputs(cfg, cell.mix["batch"], cell.mix["pool"], seed,
                              device)
    s, rate = work_mc.samples(cfg), cfg["route"]["dropout_rate"]
    served = []
    for j, mseed, _ in sample:
        mean, var = reference_mc.moments(reference_mc.sampled_probs(
            cfg, params, pool[j], mseed, s, rate, ctl["formats"]))
        served.append((j, mseed, (mean, var, mean.argmax(-1))))
    return check.worst(sample_stats(cfg, params, pool, served))


def control_row(cell, seed, rec, n, control_seeds, device) -> dict:
    """The control's and both faults' readings on the run's own sample, on
    the first ``control_seeds`` seeds."""
    if n >= control_seeds:
        return {}
    sample = rec["window"]["sample"]
    return {"control": control_stats(cell, seed, sample, device),
            **fault_stats(cell, seed, sample, device)}
