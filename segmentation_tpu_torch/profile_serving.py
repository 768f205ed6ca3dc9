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
  kernels.

``--out`` writes every activity (ms per request, launches per request)
beside the summary lines.
"""

from __future__ import annotations

import argparse
import collections
from typing import Dict, Iterable, List, Tuple

# hand kernels by the name of their __global__ function (csrc/*.cu; the
# train step's glue of train_glue.cu as its own groups); the dual's and the
# dgrad's names hold the plain conv's, so they are matched first
HAND = (("entry_chain", "H5 entry_chain"),
        ("packed_conv2x2_dgrad", "H6 packed_conv2x2_dgrad"),
        ("packed_conv2x2_dual", "H2 packed_conv2x2_dual"),
        ("packed_conv2x2", "H1 packed_conv2x2"),
        ("strided_conv4x4s2", "H3 strided_conv4x4s2"),
        ("rows_matmul", "H4 rows_matmul"),
        ("crop_normalize", "H7 crop_normalize"),
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


def union_us(spans: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s >= end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_activities(events):
    """The trace's device activities: kernels, copies and sets, not the
    device-side copies of profiler ranges (``record_function``)."""
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
        server, _ = entry("cuda", batch=args.batch, seed=0, **kw)
        wall, dev_ms, groups, rows = profile(server, reqs)
        lat, dispatch = host_clock(server, reqs)
        lines.append(f"[profile] {tag} B={args.batch}: CUDA-event ms per "
                     f"request {wall:.3f}; device ms per request "
                     f"{dev_ms:.3f}; busy share {dev_ms / wall:.3f}; one "
                     f"request at a time by the host clock {lat:.3f} ms "
                     f"(the call returns after {dispatch:.3f} ms)")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            lines.append(f"[profile] {tag}   {g}: {ms:.3f} ms "
                         f"({ms / dev_ms:.3f} of device time)")
        table += [f"==== {tag}: ms per request, launches per request, "
                  "activity"]
        table += [f"{ms:9.4f} {k:6.2f}  {name[:160]}" for ms, k, name in rows]
        del server
        torch.cuda.empty_cache()
    print("\n".join(lines))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines + table) + "\n")


if __name__ == "__main__":
    main()
