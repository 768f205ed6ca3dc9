"""devtrace's span readings and readings' span metrics on a synthetic
trace: profiler events built by hand, with known device time under each
site, known idle time inside each request and after each sync, and nested
set-up spans."""

import json
from pathlib import Path

import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent

import devtrace
import readings
import registry
import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
H8 = "void segk::std_conv3x3_bf16_kernel<256, false>"
H6 = "void segk::packed_conv2x2_dgrad_kernel<128>"
ADD = "void at::native::vectorized_elementwise_kernel<4, AddFunctor>"
COPY = "void at::native::elementwise_kernel<128, 4, direct_copy_kernel>"
MEMSET = "Memset (Device)"


class Trace:
    """Host ops and ranges (``cpu``), launches from an op (``launch``:
    the runtime call on the host, the activity on the device, linked to
    the op and to each other as the profiler links them)."""

    def __init__(self):
        self.events = []

    def _add(self, name, start, end, device_type=DeviceType.CPU, id=None):
        e = FunctionEvent(id or 1000 + len(self.events), name, 0, start, end,
                          device_type=device_type)
        self.events.append(e)
        return e

    def cpu(self, name, start, end, parent=None, id=None):
        e = self._add(name, start, end, id=id)
        if parent is not None:
            e.set_cpu_parent(parent)
            parent.append_cpu_child(e)
        return e

    def launch(self, op, kernel, at, start, end, call="cudaLaunchKernel"):
        """The call and its activity share a correlation id."""
        corr = len(self.events) + 1
        self.cpu(call, at, at + 1, op, id=corr)
        self._add(kernel, start, end, DeviceType.CUDA, id=corr)
        op.append_kernel(kernel, 0, end - start)


def serve_trace():
    """Two requests (µs): the first [0, 100] launches H8 under
    ``fwd:conv3_1`` (20-50) and ATen's add under the range itself (a
    function-scope launch; 52-56), H6 under ``bwd:conv8_1/dgrad`` nested in
    ``fwd:conv8_1`` (70-80) and a memset outside any site (62-64); the
    second [200, 300] one copy under ``fwd:conv3_2`` (210-260)."""
    t = Trace()
    r1 = t.cpu("seg:serve:request", 0, 100)
    site = t.cpu("seg:fwd:conv3_1", 5, 58, r1)
    op = t.cpu("aten::empty", 6, 30, site)
    t.launch(op, H8, 10, 20, 50)
    t.launch(site, ADD, 40, 52, 56)
    t.launch(t.cpu("aten::zero_", 58, 63, r1), MEMSET, 60, 62, 64,
             call="cudaMemsetAsync")
    outer = t.cpu("seg:fwd:conv8_1", 64, 90, r1)
    inner = t.cpu("seg:bwd:conv8_1/dgrad", 65, 89, outer)
    t.launch(t.cpu("aten::mm", 66, 69, inner), H6, 67, 70, 80)
    r2 = t.cpu("seg:serve:request", 200, 300)
    site2 = t.cpu("seg:fwd:conv3_2", 201, 209, r2)
    t.launch(t.cpu("aten::copy_", 202, 208, site2), COPY, 205, 210, 260,
             call="cudaLaunchKernelExC")
    return t.events


def train_trace():
    """Two steps' syncs: the first [400, 410] after the optimizer's last
    launch (its work at 395-405 on the device), followed by ``fwd:loss``
    [415, 450] with device work at 430-440 (idle 405-430); the second
    [460, 470] followed by none."""
    t = Trace()
    t.launch(t.cpu("seg:optimizer", 380, 399), ADD, 390, 395, 405)
    t.cpu("seg:train:sync", 400, 410)
    loss = t.cpu("seg:fwd:loss", 415, 450)
    t.launch(t.cpu("aten::log_softmax", 420, 425, loss), ADD, 421, 430, 440)
    t.cpu("seg:train:sync", 460, 470)
    return t.events


def setup_trace():
    """``setup:prepare`` 400 µs; ``setup:calibrate`` 1000 µs holding
    ``setup:plan`` 300 µs (under an ATen op), which holds
    ``setup:kernels`` 100 µs; a second ``setup:kernels`` at the top."""
    t = Trace()
    t.cpu("seg:setup:prepare", 500, 900)
    cal = t.cpu("seg:setup:calibrate", 1000, 2000)
    plan = t.cpu("seg:setup:plan", 1200, 1500, t.cpu("aten::to", 1100, 1600,
                                                     cal))
    t.cpu("seg:setup:kernels", 1300, 1400, plan)
    t.cpu("seg:setup:kernels", 3000, 9000)
    return t.events


def test_sites_take_the_innermost_fwd_or_bwd_range():
    red = devtrace.reduce(serve_trace())
    us = {k: round(v * 1e6, 6) for k, v in red["site_s"].items()}
    assert us == {"fwd:conv3_1": 34.0, "bwd:conv8_1/dgrad": 10.0,
                  devtrace.NO_SITE: 2.0, "fwd:conv3_2": 50.0}
    groups = {s: {g: round(v * 1e6, 6) for g, v in gs.items()}
              for s, gs in red["site_group_s"].items()}
    assert groups["fwd:conv3_1"] == {"H8 std_conv3x3 bf16": 30.0,
                                     "other": 4.0}
    assert groups["bwd:conv8_1/dgrad"] == {"H6 packed_conv2x2_dgrad": 10.0}
    assert groups[devtrace.NO_SITE] == {"copies": 2.0}
    assert sum(red["site_s"].values()) == pytest.approx(
        sum(red["phase_s"].values()))


def test_requests_read_the_device_clock_alone():
    """Shift every device activity by a clock offset: the request and sync
    readings stay, though the host spans no longer hold their work."""
    for trace, key in ((serve_trace, "requests"), (train_trace,
                                                   "sync_idle_s")):
        events = trace()
        for e in events:
            if e.device_type == DeviceType.CUDA:
                e.time_range.start += 700
                e.time_range.end += 700
        assert devtrace.reduce(events)[key] == devtrace.reduce(trace())[key]


def test_requests_count_launch_calls_and_idle_time():
    red = devtrace.reduce(serve_trace())
    got = [[n, round(i * 1e6, 6), round(s * 1e6, 6)]
           for n, i, s in red["requests"]]
    # request 1 launches 20-50 (H8), 52-56 (the add), 62-64, 70-80: idle
    # 14 of its envelope's 60; request 2 one activity, idle 0 of 50
    assert got == [[4, 14.0, 60.0], [1, 0.0, 50.0]]
    assert red["sync_idle_s"] == []


def test_sync_idle_runs_to_the_next_loss_end():
    red = devtrace.reduce(train_trace())
    assert [round(v * 1e6, 6) for v in red["sync_idle_s"]] == [25.0]
    assert red["requests"] == []


def test_setup_spans_own_seconds_without_the_kernels():
    got = {k: round(v * 1e6, 6)
           for k, v in devtrace.setup_seconds(setup_trace()).items()}
    assert got == {"setup:prepare": 400.0, "setup:calibrate": 700.0,
                   "setup:plan": 200.0}


def test_reduce_keeps_the_ledgers_keys():
    red = devtrace.reduce(serve_trace())
    assert red["busy_s"] * 1e6 == pytest.approx(96.0)
    assert set(red["phase_s"]) == {"fwd", "bwd", "other"}
    for key in ("device_ops", "idle_gaps"):
        assert red[key] and all(
            isinstance(n, str) and isinstance(s, float) for n, s in red[key])
    assert red["device_ops"][0][0] == "copies: " + COPY


def _rec(trace, units, batch=64):
    with open(CONFIGS / "unet512_bf16.json") as f:
        cfg = json.load(f)
    return {"cfg": cfg, "batch": batch,
            "trace": {**trace, "units": units, "window_s": 1.0}}


def test_span_metrics_read_the_record():
    red = devtrace.reduce(serve_trace())
    rec = _rec({**red, "setup_s_by_span": {"setup:prepare": 0.25,
                                           "setup:plan": 0.5}}, units=1)
    assert readings.launch_calls(rec) == 2.5
    assert readings.dispatch_idle_share(rec) == pytest.approx(14 / 110 * 100)
    # the two request spans are the units, not the window's count of 1
    assert readings.site_ms(rec, ["fwd:conv3_1", "fwd:conv3_2"]) == \
        pytest.approx(0.042)
    assert readings.prepare_s(rec) == 0.75
    rec = _rec(devtrace.reduce(train_trace()), units=1)
    assert readings.sync_idle_ms(rec) == pytest.approx(0.025)


SPLIT_SITES = {"fwd:conv3_1": {"H8 std_conv3x3_s8": 0.004},
               "fwd:conv3_2": {"H8 std_conv3x3_s8": 0.006, "copies": 0.001},
               "fwd:conv4_1": {"H8 std_conv3x3_s8": 0.002, "other": 0.001},
               "fwd:upconv1": {"library conv": 0.003}}


def test_kernel_roofline_counts_whole_sites_only():
    """H8 alone at conv3_1 and H8 with a copy at conv3_2 count; conv4_1,
    whose bias runs in ATen, is a split site that the caller leaves out by
    not listing it."""
    rec = _rec({"site_group_s": SPLIT_SITES,
                "requests": [[30, 0.0, 0.01]] * 3}, units=2)
    cfg = rec["cfg"]
    least = sum(work.site_least_s(cfg, s, "fwd", 64)
                for s in ("conv3_1", "conv3_2"))
    got = readings.kernel_roofline(rec, ["H8"],
                                   ["fwd:conv3_1", "fwd:conv3_2"])
    assert got == pytest.approx(least * 3 / 0.010 * 100)


@pytest.mark.parametrize("listed", [
    "fwd:conv4_1",   # split: an ATen pass beside H8
    "fwd:upconv1",   # none of the groups' launches
    "fwd:conv5_1"])  # no such span in the trace
def test_a_listed_site_that_no_longer_holds_reads_none(listed):
    """The set of sites is the metric file's: a listed site that is split,
    off the groups or gone silences the metric instead of shrinking the
    set it averages over."""
    rec = _rec({"site_group_s": SPLIT_SITES,
                "requests": [[30, 0.0, 0.01]] * 3}, units=2)
    assert readings.kernel_roofline(
        rec, ["H8"], ["fwd:conv3_1", "fwd:conv3_2", listed]) is None


@pytest.mark.parametrize("config,level1", [
    ("unet512_bf16", {"fwd:conv1_1": {"H3 strided_conv4x4s2": 0.002},
                      "fwd:conv1_2": {"H1 packed_conv2x2": 0.003}}),
    ("unet512_int8", {"fwd:conv1_1+conv1_2": {"H5 entry_chain": 0.004}})])
def test_packed_roofline_batch_takes_its_routes_level_one(config, level1):
    """``packed_roofline.batch`` lists level 1 by the route: two spans in
    bf16, H5's fused one in int8; every listed site reads."""
    with open(CONFIGS / f"{config}.json") as f:
        cfg = json.load(f)
    rest = {f"fwd:{s}": {"H1 packed_conv2x2": 0.001} for s in (
        "conv2_1", "conv2_2", "upconv3", "conv8_1", "conv8_2", "upconv4",
        "conv9_1", "conv9_2+head")}
    rec = {"cfg": cfg, "batch": 64, "trace": {
        "site_group_s": {**level1, **rest}, "units": 1, "window_s": 1.0}}
    read = registry.reader("packed_roofline.batch")
    got = read(rec)
    assert got is not None and 0 < got
    del rec["trace"]["site_group_s"][next(iter(level1))]
    assert read(rec) is None


def test_kernel_roofline_reads_the_part_of_a_backward_span():
    sg = {"bwd:conv8_2/dgrad": {"H6 packed_conv2x2_dgrad": 0.002,
                                "glue crop_margin_zero": 0.0001},
          "fwd:conv8_2": {"H1 packed_conv2x2": 0.001}}
    rec = _rec({"site_group_s": sg}, units=4, batch=128)
    cfg = rec["cfg"]
    want = (work.site_least_s(cfg, "conv8_2", "dgrad", 128)
            + work.site_least_s(cfg, "conv8_2", "fwd", 128)) * 4 / 0.003
    got = readings.kernel_roofline(rec, ["H1", "H6"],
                                   ["fwd:conv8_2", "bwd:conv8_2/dgrad"])
    assert got == pytest.approx(want * 100)


@pytest.mark.parametrize("trace", [None, {}, {"site_s": {}, "requests": [],
                                              "sync_idle_s": [],
                                              "site_group_s": {},
                                              "setup_s_by_span": None}])
def test_without_the_spans_every_reading_is_none(trace):
    """A trace with no span reading (a program that opens no span, or no
    trace at all) reads None in each span metric."""
    rec = {"cfg": {}, "batch": 8,
           "trace": None if trace is None else {**trace, "units": 5}}
    assert readings.launch_calls(rec) is None
    assert readings.dispatch_idle_share(rec) is None
    assert readings.sync_idle_ms(rec) is None
    assert readings.site_ms(rec, ["fwd:conv3_1"]) is None
    assert readings.prepare_s(rec) is None
    assert readings.kernel_roofline(rec, ["H8"], ["fwd:conv3_1"]) is None


def test_a_trace_without_spans_reads_empty():
    """The parent's trace before the program had spans: device work under
    ATen ops alone."""
    t = Trace()
    t.launch(t.cpu("aten::conv2d", 0, 10), H8, 1, 5, 50)
    red = devtrace.reduce(t.events)
    assert red["requests"] == [] and red["sync_idle_s"] == []
    assert list(red["site_s"]) == [devtrace.NO_SITE]
    rec = _rec(red, units=1)
    assert readings.site_ms(rec, ["fwd:conv3_1"]) is None
    assert readings.kernel_roofline(rec, ["H8"], ["fwd:conv3_1"]) is None
