"""The traced window, reduced: the device's busy time, each kernel's time
by group, the device time of the forward and the backward of a train
step, and the longest idle gaps named by what the host was doing.

``torch.profiler`` records the window with CPU and CUDA activities. The
device activities are the trace's kernels, copies and sets (not the
device-side copies of profiler ranges); the busy time is the union of
their intervals, so overlapping streams count once. A kernel's phase is
read from the CPU op that launched it: under an autograd node or a
``seg:bwd:`` range of the program, the backward; under a ``seg:fwd:``
range, the forward; else the rest (optimizer, input, host copies).

``group_of``, ``union_us`` and ``device_activities`` are copies of
segmentation_tpu_torch/profile_serving.py's.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Tuple

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
_NODE = "autograd::engine::evaluate_function: "


def group_of(name: str) -> str:
    """The group a device activity's name falls in."""
    low = name.lower()
    for key, label in HAND:
        if key in name:
            return label
    if "memcpy" in low or "memset" in low or "copy" in low:
        return "copies"
    if any(k in low for k in ("cudnn", "conv", "fprop", "dgrad", "wgrad")):
        return "library conv"
    if "gemm" in low or "nvjet" in low:
        return "library GEMM"
    return "other"


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
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("seg:")]


def phase_of(event) -> str:
    """``fwd``, ``bwd`` or ``other``: the innermost marker above the op."""
    p = event
    while p is not None:
        if p.name.startswith(("seg:bwd:", _NODE)):
            return "bwd"
        if p.name.startswith("seg:fwd:"):
            return "fwd"
        p = p.cpu_parent
    return "other"


def _gaps(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle intervals between the union's pieces, longest first."""
    out, end = [], None
    for s, e in sorted(spans):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return sorted(out, key=lambda g: g[0] - g[1])


def _host_at(cpu, t: float) -> str:
    """The innermost CPU op running at ``t``."""
    best, depth = None, -1
    for e in cpu:
        r = e.time_range
        if r.start <= t < r.end:
            d, p = 0, e.cpu_parent
            while p is not None:
                d, p = d + 1, p.cpu_parent
            if d > depth:
                best, depth = e.name, d
    return best or "python between ops"


def reduce(events, top: int = 10) -> dict:
    """The trace's readings: ``busy_s``; ``phase_s`` {fwd, bwd, other};
    ``device_ops`` and ``idle_gaps``, [name, seconds] of the ``top``
    longest."""
    from torch.autograd import DeviceType

    dev = device_activities(events)
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    by_kernel: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        by_kernel[f"{group_of(e.name)}: {e.name[:90]}"] += (
            e.time_range.elapsed_us() / 1e6)
    phase: Dict[str, float] = collections.defaultdict(float)
    for e in events:
        if e.device_type == DeviceType.CPU and e.kernels:
            ph = phase_of(e)
            for k in e.kernels:
                if not k.name.startswith("seg:"):
                    phase[ph] += k.duration / 1e6
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    gaps = [[_host_at(cpu, (a + b) / 2), (b - a) / 1e6]
            for a, b in _gaps(spans)[:top]]
    ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": union_us(spans) / 1e6, "phase_s": dict(phase),
            "device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}


def traced(fn, cuda: bool = True):
    """Run ``fn`` under the profiler; (its result, the trace's readings).
    ``cuda=False`` (the CPU rehearsal) traces the host alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        result = fn()
        if cuda:
            torch.cuda.synchronize()
    return result, reduce(prof.events())
