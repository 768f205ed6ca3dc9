"""The traced window, reduced: the device's busy time, each kernel's time
by group, the device time of the forward and the backward of a train
step, and the longest idle gaps named by what the host was doing; and
what the program's spans (``seg:`` ranges) say of the same trace: the
device time launched under each site, by group, each request's
work-enqueuing calls and device idle time, the idle time after each step's
loss sync, and the set-up spans' own seconds.

``torch.profiler`` records the window with CPU and CUDA activities. The
device activities are the trace's kernels, copies and sets (not the
device-side copies of profiler ranges); the busy time is the union of
their intervals, so overlapping streams count once. A kernel's phase is
read from the CPU op that launched it: under an autograd node or a
``seg:bwd:`` range of the program, the backward; under a ``seg:fwd:``
range, the forward; else the rest (optimizer, input, host copies).

The span names are the program's contract (PERF.md §3's span table); the
arithmetic over them is the benchmark's own, so that no change to the
program changes what the benchmark reads. ``group_of``, ``union_us`` and
``device_activities`` are copies of
segmentation_tpu_torch/profile_serving.py's, and ``setup_seconds`` of its
``setup_seconds``; ``span_readings`` reads what its ``span_readings``
reads (the requests' calls and idle time, the sync's idle time, the
sites' device time), the idle times on the device's clock alone. Where the
program opens no span, each of these reads empty.
"""

from __future__ import annotations

import bisect
import collections
import math
from typing import Dict, Iterable, List, Tuple

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
_NODE = "autograd::engine::evaluate_function: "
# the CUDA runtime and driver calls that put work on the device's queue
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                "cudaGraphLaunch")
NO_SITE = "(no site)"


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


def site_of(event) -> str:
    """The innermost ``seg:fwd:<site>`` or ``seg:bwd:<site>/<part>`` range
    at or above the op, without its ``seg:``; else ``NO_SITE``."""
    p = event
    while p is not None:
        if p.name.startswith(("seg:fwd:", "seg:bwd:")):
            return p.name[4:]
        p = p.cpu_parent
    return NO_SITE


def idle_us(a: float, b: float, pieces) -> float:
    """The time in [a, b] that no piece of ``merge``'s covers."""
    i = max(bisect.bisect_right(pieces, (a, math.inf)) - 1, 0)
    busy = 0.0
    while i < len(pieces) and pieces[i][0] < b:
        s, e = pieces[i]
        busy += max(0.0, min(e, b) - max(s, a))
        i += 1
    return (b - a) - busy


def span_readings(events) -> dict:
    """What the program's spans say of a trace, in seconds:

    - ``site_s``: {site span: device seconds of the activities launched
      under it} (``site_of``; ``NO_SITE`` for the rest);
    - ``site_group_s``: {site span: {``group_of`` the kernel: seconds}};
    - ``requests``: per ``seg:serve:request`` span, [the work-enqueuing
      calls (``LAUNCH_CALLS``) that start inside it, the device's idle
      seconds between the first and the last activity those calls
      launched, the length of that envelope];
    - ``sync_idle_s``: per ``seg:train:sync`` span that a ``seg:fwd:loss``
      follows, the device's idle seconds from the end of the last activity
      launched before the sync's end to the end of the last one launched
      inside that ``fwd:loss``: the refill of the queue the sync emptied.

    Host spans pick the activities by their launches (a launch call and
    its activity share a correlation id), and the idle time is read on the
    device's clock alone: the profiler's host and device clocks drift
    apart by up to ~0.7 ms within a traced window on an H100's host, so an
    interval of the host's read against the device's would read that
    drift.
    """
    from torch.autograd import DeviceType

    acts = device_activities(events)
    dev = merge((e.time_range.start, e.time_range.end) for e in acts)
    by_id = {e.id: e for e in acts}
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    site: Dict[str, float] = collections.defaultdict(float)
    site_group: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: collections.defaultdict(float))
    for e in cpu:
        if not e.kernels:
            continue
        name = site_of(e)
        for k in e.kernels:
            if not k.name.startswith("seg:"):
                site[name] += k.duration / 1e6
                site_group[name][group_of(k.name)] += k.duration / 1e6
    calls = sorted((e for e in cpu if e.name.startswith(LAUNCH_CALLS)),
                   key=lambda e: e.time_range.start)
    starts = [c.time_range.start for c in calls]
    launched = [by_id.get(c.id) for c in calls]

    def span_of(a: float, b: float) -> Tuple[int, int]:
        return bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)

    def envelope(i: int, j: int):
        """(first start, last end) of the activities calls[i:j] launched."""
        mine = [d.time_range for d in launched[i:j] if d is not None]
        if not mine:
            return None
        return min(r.start for r in mine), max(r.end for r in mine)

    requests = []
    for r in sorted((e for e in cpu if e.name == "seg:serve:request"),
                    key=lambda e: e.time_range.start):
        i, j = span_of(r.time_range.start, r.time_range.end)
        env = envelope(i, j)
        a, b = env or (0.0, 0.0)
        requests.append([j - i, idle_us(a, b, dev) / 1e6, (b - a) / 1e6])
    losses = sorted((e for e in cpu if e.name == "seg:fwd:loss"),
                    key=lambda e: e.time_range.end)
    loss_ends = [e.time_range.end for e in losses]
    sync_idle = []
    for t in sorted(e.time_range.end for e in cpu
                    if e.name == "seg:train:sync"):
        k = bisect.bisect_right(loss_ends, t)
        if k == len(losses):
            continue
        before = envelope(0, span_of(t, t)[0])
        loss = envelope(*span_of(losses[k].time_range.start, loss_ends[k]))
        if before and loss:
            sync_idle.append(idle_us(before[1], loss[1], dev) / 1e6)
    return {"site_s": dict(site),
            "site_group_s": {k: dict(v) for k, v in site_group.items()},
            "requests": requests, "sync_idle_s": sync_idle}


def setup_seconds(events) -> Dict[str, float]:
    """{``setup:<name>``: own seconds} of the trace's ``seg:setup:`` spans:
    each span's length less the ``seg:setup:`` spans directly inside it.
    ``setup:kernels`` (the nvcc build, or the load of a built library) is
    subtracted from the span that first needs the kernels and not
    reported."""
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
        if e.name != "seg:setup:kernels":
            out[e.name[4:]] += own[id(e)] / 1e6
    return dict(out)


def _gaps(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle intervals between the union's pieces, longest first."""
    pieces = merge(spans)
    return sorted(((a[1], b[0]) for a, b in zip(pieces, pieces[1:])),
                  key=lambda g: g[0] - g[1])


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
    longest; and ``span_readings``' keys."""
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
            "device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps,
            **span_readings(events)}


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


def setup_spans(fn) -> Dict[str, float]:
    """``setup_seconds`` of the spans that ``fn`` opens, run under a
    profiler of the host alone."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return setup_seconds(prof.events())
