"""Where a served request's device time goes (torch.profiler, one GPU).

    python -m segmentation_tpu_torch.profile_serving [--requests 3] \
        [--out FILE]

Serves the flagship (512², B = 8) bf16 model and the three calibrated int8
configurations (the flagship padded-flat route, ``padflat=False`` and
``quant_deconvs=False``, each calibrated on one seeded batch) as
chip_smoke.py does. For each it times
``--requests`` requests by CUDA events, then traces the same requests and
reads the trace's device activities (kernels, copies, sets) only:

- device ms per request: the union of the activities' intervals, so
  overlapping streams count once;
- busy share: that union over the CUDA-event time of the untraced
  requests (the device's idle share is one minus it);
- by the host clock, each request ending in a sync: the latency a client
  of one request at a time sees, and the host's time to return from the
  call (its dispatch of the request's launches), medians over
  ``--requests`` x 3 requests;
- the summed activity time per group: the hand kernels (H1–H8, by kernel
  name), library GEMMs, library convs, copies and the other (elementwise)
  kernels;
- from the program's spans (utils/trace.py; ``span_readings``), in a
  traced pass of one request at a time: the calls that enqueue work a
  request, the device's idle time inside a request's span (its dispatch's
  share of the latency), the device time launched under the standard
  levels' sites, and the longest idle gaps by span and op; and the set-up
  spans' own seconds (``prepare``, ``calibrate``, ``plan``, ``kernels``;
  ``setup_seconds``), from a CPU profile of building the server and its
  first request.

``--out`` writes every activity (ms per request, launches per request)
and the device ms of each ``fwd:<site>`` beside the summary lines.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import math
from typing import Dict, Iterable, List, Tuple

# hand kernels by the name of their __global__ function (csrc/*.cu; the
# train step's glue of train_glue.cu as its own groups; H8's bf16 and s8
# modes apart); the dual's and the dgrad's names hold the plain conv's, so
# they are matched first
HAND = (("entry_chain", "H5 entry_chain"),
        ("packed_conv2x2_dgrad", "H6 packed_conv2x2_dgrad"),
        ("packed_conv2x2_dual", "H2 packed_conv2x2_dual"),
        ("packed_conv2x2", "H1 packed_conv2x2"),
        ("strided_conv4x4s2", "H3 strided_conv4x4s2"),
        ("rows_matmul", "H4 rows_matmul"),
        ("crop_normalize", "H7 crop_normalize"),
        ("std_conv3x3_bf16", "H8 std_conv3x3 bf16"),
        ("std_conv3x3_dual_bf16", "H8 std_conv3x3 bf16"),
        ("std_conv3x3", "H8 std_conv3x3_s8"),
        ("relu_bias_grad", "glue relu_bias_grad"),
        ("bias_reduce", "glue relu_bias_grad"),
        ("crop_margin_zero", "glue crop_margin_zero"))


def group_of(name: str) -> str:
    """The group a device activity's name falls in."""
    low = name.lower()
    for key, label in HAND:
        if key in name:
            return label
    if "memcpy" in low or "memset" in low or "copy" in low:
        return "copies"
    # cuDNN's convs run as implicit GEMMs: test their names first
    if any(k in low for k in ("cudnn", "conv", "fprop", "dgrad", "wgrad")):
        return "library conv"
    if "gemm" in low or "nvjet" in low:  # nvjet: cuBLAS's Hopper GEMMs
        return "library GEMM"
    return "other (elementwise, pools, reductions)"


def merge(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint pieces, in order."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def union_us(spans: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    return sum(e - s for s, e in merge(spans))


def device_activities(events):
    """The trace's device activities: kernels, copies and sets, not the
    device-side copies of the program's ranges (``seg:``)."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("seg:")]


def breakdown(events, n: int) -> Tuple[float, Dict[str, float], List]:
    """(device ms per request, {group: ms per request}, [(ms, launches,
    name) per request, slowest first]) from a trace's FunctionEvents."""
    dev = device_activities(events)
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    groups: Dict[str, float] = collections.defaultdict(float)
    per_name: Dict[str, List[float]] = collections.defaultdict(list)
    for e in dev:
        us = e.time_range.elapsed_us()
        groups[group_of(e.name)] += us / n / 1e3
        per_name[e.name].append(us)
    rows = sorted(((sum(v) / n / 1e3, len(v) / n, k)
                   for k, v in per_name.items()), reverse=True)
    return union_us(spans) / n / 1e3, dict(groups), rows


# the CUDA runtime and driver calls that put work on the device's queue
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                "cudaGraphLaunch")


def idle_us(a: float, b: float, pieces) -> float:
    """The time in [a, b] that no piece of ``merge``'s covers."""
    i = max(bisect.bisect_right(pieces, (a, math.inf)) - 1, 0)
    busy = 0.0
    while i < len(pieces) and pieces[i][0] < b:
        s, e = pieces[i]
        busy += max(0.0, min(e, b) - max(s, a))
        i += 1
    return (b - a) - busy


def seg_of(event, prefix: str = "seg:") -> str:
    """The innermost program span (``seg:`` range) whose name starts with
    ``prefix`` at or above ``event``, without its ``seg:``; else None."""
    p = event
    while p is not None:
        if p.name.startswith(prefix):
            return p.name[4:]
        p = p.cpu_parent
    return None


def span_readings(events) -> dict:
    """What the program's spans (utils/trace.py) say of a trace:

    - ``requests``: per ``serve:request`` span, [the work-enqueuing calls
      (``LAUNCH_CALLS``) that start inside it, the device's idle µs
      inside it] (one thread dispatches a request);
    - ``sync_idle_us``: per ``train:sync`` span that a step's
      ``fwd:loss`` follows, the device's idle µs from the sync's end to
      the end of that ``fwd:loss``: the refill of an empty queue;
    - ``site_us``: {site: device µs} of the activities launched under
      the innermost ``fwd:<site>`` span; ``(no fwd site)`` for the rest.
    """
    from torch.autograd import DeviceType

    dev = merge((e.time_range.start, e.time_range.end)
                for e in device_activities(events))
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    starts = sorted(e.time_range.start for e in cpu
                    if e.name.startswith(LAUNCH_CALLS))
    requests = []
    for r in (e for e in cpu if e.name == "seg:serve:request"):
        a, b = r.time_range.start, r.time_range.end
        n = bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
        requests.append([n, idle_us(a, b, dev)])
    losses = sorted(e.time_range.end for e in cpu
                    if e.name == "seg:fwd:loss")
    sync_idle = []
    for t in sorted(e.time_range.end for e in cpu
                    if e.name == "seg:train:sync"):
        i = bisect.bisect_right(losses, t)
        if i < len(losses):
            sync_idle.append(idle_us(t, losses[i], dev))
    site: Dict[str, float] = collections.defaultdict(float)
    for e in cpu:
        name = seg_of(e, "seg:fwd:")
        for k in e.kernels:
            if not k.name.startswith("seg:"):
                site[name[4:] if name else "(no fwd site)"] += k.duration
    return {"requests": requests, "sync_idle_us": sync_idle,
            "site_us": dict(site)}


def gap_names(events, top: int = 10) -> List[List]:
    """The ``top`` longest device idle gaps, longest first: [``<innermost
    program span> | <innermost op>`` on the host at the gap's middle (``(no
    span)`` outside the program's spans), seconds]."""
    from torch.autograd import DeviceType

    dev = merge((e.time_range.start, e.time_range.end)
                for e in device_activities(events))
    gaps = sorted(((a[1], b[0]) for a, b in zip(dev, dev[1:])),
                  key=lambda g: g[0] - g[1])[:top]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    out = []
    for a, b in gaps:
        t, best, depth = (a + b) / 2, None, -1
        for e in cpu:
            if e.time_range.start <= t < e.time_range.end:
                d, p = 0, e.cpu_parent
                while p is not None:
                    d, p = d + 1, p.cpu_parent
                if d > depth:
                    best, depth = e, d
        span = seg_of(best) if best is not None else None
        op = ("python between ops" if best is None
              or best.name.startswith("seg:") else best.name)
        out.append([f"{span or '(no span)'} | {op}", (b - a) / 1e6])
    return out


def setup_seconds(events) -> Dict[str, float]:
    """{span: seconds} of the trace's ``seg:setup:`` spans, each less the
    ``setup:`` spans directly inside it (``setup:kernels``, the nvcc build
    or load, never counts in the span that first needs the kernels)."""
    setup = [e for e in events if e.name.startswith("seg:setup:")]
    own = {id(e): e.time_range.elapsed_us() for e in setup}
    for e in setup:
        p = e.cpu_parent
        while p is not None and not p.name.startswith("seg:setup:"):
            p = p.cpu_parent
        if p is not None:
            own[id(p)] -= e.time_range.elapsed_us()
    out: Dict[str, float] = collections.defaultdict(float)
    for e in setup:
        out[e.name[4:]] += own[id(e)] / 1e6
    return dict(out)


def profile(server, reqs):
    """(CUDA-event ms per request untraced, device ms per request, groups,
    rows) over ``reqs``, after two warm-up requests. ``server`` is any
    callable of one request (chip_smoke.py passes a trainer's step)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    for _ in range(2):
        server(reqs[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for x in reqs:
        server(x)
    stop.record()
    stop.synchronize()
    wall = start.elapsed_time(stop) / len(reqs)
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        for x in reqs:
            server(x)
        torch.cuda.synchronize()
    return (wall, *breakdown(prof.events(), len(reqs)))


def host_clock(server, reqs, rounds: int = 3):
    """(median ms from the call to the end of a sync after it, median ms
    until the call returns) over ``rounds`` passes over ``reqs``."""
    import statistics
    import time

    import torch

    torch.cuda.synchronize()
    lat, dispatch = [], []
    for _ in range(rounds):
        for x in reqs:
            t0 = time.perf_counter()
            server(x)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            dispatch.append((t1 - t0) * 1e3)
    return statistics.median(lat), statistics.median(dispatch)


def main(argv=None) -> None:
    import subprocess

    import torch

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace_profile

    from segmentation_tpu_torch.core.rng import generator
    from segmentation_tpu_torch.serving import entry

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    gen = generator(1234, "cuda")
    shape = (args.batch, 512, 512, 3)
    reqs = [torch.rand(shape, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(args.requests)]
    calib = torch.rand(shape, generator=generator(4321, "cuda"),
                       device="cuda")
    lines, table = [smi], []
    int8 = {"int8": True, "calib": [calib]}
    for tag, kw in (("bf16", {}), ("int8", int8),
                    ("int8_4d", {**int8, "padflat": False}),
                    ("int8_fdeconv", {**int8, "quant_deconvs": False})):
        with trace_profile(activities=[ProfilerActivity.CPU]) as prof:
            server, _ = entry("cuda", batch=args.batch, seed=0, **kw)
            server(reqs[0])
            torch.cuda.synchronize()
        setup = setup_seconds(prof.events())
        wall, dev_ms, groups, rows = profile(server, reqs)
        lat, dispatch = host_clock(server, reqs)
        with trace_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            host_clock(server, reqs, rounds=1)
        spans = span_readings(prof.events())
        calls = [c for c, _ in spans["requests"]]
        idle_ms = sum(i for _, i in spans["requests"]) / len(calls) / 1e3
        fast = set(server.model.sites.packed_sites) | {"head", "unpack",
                                                       "(no fwd site)"}
        std_ms = sum(us for site, us in spans["site_us"].items()
                     if site.split("+")[0] not in fast) / len(calls) / 1e3
        lines.append(f"[profile] {tag} B={args.batch}: CUDA-event ms per "
                     f"request {wall:.3f}; device ms per request "
                     f"{dev_ms:.3f}; busy share {dev_ms / wall:.3f}; one "
                     f"request at a time by the host clock {lat:.3f} ms "
                     f"(the call returns after {dispatch:.3f} ms)")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            lines.append(f"[profile] {tag}   {g}: {ms:.3f} ms "
                         f"({ms / dev_ms:.3f} of device time)")
        lines.append(
            f"[profile] {tag}   spans, one request at a time: "
            f"{min(calls)}-{max(calls)} work-enqueuing calls a request; the "
            f"device idles {idle_ms:.3f} ms inside a request's span; the "
            f"standard levels' sites launch {std_ms:.3f} device ms")
        lines.append(f"[profile] {tag}   longest idle gaps: " + "; ".join(
            f"{name} {sec * 1e3:.3f} ms"
            for name, sec in gap_names(prof.events(), 3)))
        lines.append(f"[profile] {tag}   set-up spans' own s: " + ", ".join(
            f"{name} {sec:.3f}" for name, sec in sorted(setup.items())))
        table += [f"==== {tag}: ms per request, launches per request, "
                  "activity"]
        table += [f"{ms:9.4f} {k:6.2f}  {name[:160]}" for ms, k, name in rows]
        table += [f"==== {tag}: device ms per request by fwd site"]
        table += [f"{us / len(calls) / 1e3:9.4f}  {site}" for site, us in
                  sorted(spans["site_us"].items(), key=lambda kv: -kv[1])]
        del server
        torch.cuda.empty_cache()
    print("\n".join(lines))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines + table) + "\n")


if __name__ == "__main__":
    main()
