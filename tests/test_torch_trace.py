"""The port's spans (segmentation_tpu_torch/utils/trace.py), on CPU: the
off path, the ranges under a profiler, the spans of the served bf16 and
int8 routes, of set-up and of a train step (plain versions, tiny sizes),
the span reductions of profile_serving.py over stand-in trace events, and
that no range of the package bypasses the module."""

import collections
import pathlib
import tempfile
import tracemalloc

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from segmentation_tpu_torch import profile_serving as ps
from segmentation_tpu_torch.core.config import ModelConfig, TrainConfig
from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.models.unet import init_params
from segmentation_tpu_torch.models.unet_fast import UNetS2D, UNetS2DInference
from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8
from segmentation_tpu_torch.nn.kernels import conv_flat, conv_int8
from segmentation_tpu_torch.serving import Server
from segmentation_tpu_torch.training.trainer import SegmentationTrainer
from segmentation_tpu_torch.utils import trace

PACKAGE = (pathlib.Path(__file__).resolve().parents[1]
           / "segmentation_tpu_torch")

# the train route's ranges of a step of a 4-level U-Net, besides
# train:step and train:sync: the names profile_train.py and the benchmark's
# fwd_ms.train / bwd_ms.train read, kept letter for letter
PARENT_TRAIN_RANGES = {
    *(f"seg:bwd:{site}/{part}" for site in (
        "conv1_2", "conv2_1", "conv2_2", "conv8_1", "conv8_2", "conv9_1",
        "conv9_2", "upconv3", "upconv4") for part in (
        "dgrad", "mask_bias", "wgrad")),
    "seg:bwd:conv1_1/mask_bias", "seg:bwd:conv1_1/wgrad",
    *(f"seg:fwd:conv{i}_{j}" for i in range(1, 10) for j in (1, 2)),
    *(f"seg:fwd:upconv{i}" for i in range(1, 5)),
    "seg:fwd:head", "seg:fwd:input", "seg:fwd:loss", "seg:fwd:pack_weights",
    "seg:fwd:std_pool", "seg:optimizer",
}
# the backward parts of the std levels' 3×3 convs, whose Functions the
# benchmark's std_bwd_ms.train reads
STD_BWD_RANGES = {f"seg:bwd:conv{i}_{j}/{part}" for i in range(3, 8)
                  for j in (1, 2) for part in ("mask_bias", "dgrad", "wgrad")}
# the sites of a served 4-level request, in order (two std pools)
SERVED = ["conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
          "std_pool", "conv4_1", "conv4_2", "std_pool", "conv5_1", "conv5_2",
          "upconv1", "conv6_1", "conv6_2", "upconv2", "conv7_1", "conv7_2",
          "upconv3", "conv8_1", "conv8_2", "upconv4", "conv9_1",
          "conv9_2+head", "unpack"]


@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=8)
    return cfg, init_params(cfg, generator(0))


def _bf16_server(cfg, params):
    m = UNetS2DInference(cfg, ops=conv_flat.PLAIN_OPS)
    return Server(m, params, m.prepare(params, dtype=torch.bfloat16))


def _int8_model(cfg):
    return UNetS2DInt8(cfg, ops=conv_flat.PLAIN_OPS, ops8=conv_int8.PLAIN_OPS)


def _trainer(cfg, params, tmp):
    return SegmentationTrainer(UNetS2D(cfg, params=dict(params),
                                       ops=conv_flat.PLAIN_OPS),
                               device="cpu",
                               train_cfg=TrainConfig(save_dir=tmp))


def _batch(hw):
    g = torch.Generator().manual_seed(0)
    return {"image": (torch.rand(2, *hw, 3, generator=g) * 255)
            .to(torch.uint8),
            "mask": (torch.rand(2, *hw, 1, generator=g) > 0.5)
            .to(torch.uint8)}


def _ranges(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("seg:")]


def _parents(event):
    p = event.cpu_parent
    while p is not None:
        yield p.name
        p = p.cpu_parent


# ---- the module ---------------------------------------------------------
def test_off_span_is_one_shared_object_and_allocates_nothing():
    assert not torch._C._autograd._profiler_enabled()
    assert trace.span("serve:request") is trace.span(
        "bwd", "conv1_2", "/dgrad")
    site = "conv3_1"

    def spans(n):
        for _ in range(n):
            with trace.span("fwd", site):
                pass

    spans(100)
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        spans(10_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # no span object, no name: what is left is nothing, and the most held
    # at once is the with statement's bound methods
    assert after == before and peak - before < 1024


@pytest.mark.parametrize("route", ["bf16", "int8", "train"])
def test_off_a_request_and_a_step_open_no_range(route, tiny, monkeypatch):
    """Unprofiled, neither a served request (nor its set-up) nor a train
    step builds a range."""
    cfg, params = tiny
    opened = []
    monkeypatch.setattr(trace, "_range", opened.append)
    x = torch.rand(1, 188, 188, 3)
    if route == "train":
        with tempfile.TemporaryDirectory() as tmp:
            _trainer(cfg, params, tmp).train_step(_batch((188, 188)))
    elif route == "int8":
        q = _int8_model(cfg)
        srv = Server(q, params, q.prepare(params, calib_batches=[x],
                                          dtype=torch.bfloat16))
        srv(x.to(torch.bfloat16))
    else:
        _bf16_server(cfg, params)(x.to(torch.bfloat16))
    assert opened == []


def test_a_profiler_turns_the_ranges_on_and_they_nest():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("serve:request"):
            with trace.span("fwd", "conv1_1"):
                torch.ones(4).add_(1)
            with trace.span("fwd", "conv9_2", "+head"):
                pass
    seg = [e for e in prof.events() if e.name.startswith("seg:")]
    assert [e.name for e in seg] == ["seg:serve:request", "seg:fwd:conv1_1",
                                     "seg:fwd:conv9_2+head"]
    assert list(_parents(seg[1])) == ["seg:serve:request"]
    add = next(e for e in prof.events() if e.name == "aten::add_")
    assert list(_parents(add)) == ["seg:fwd:conv1_1", "seg:serve:request"]
    assert trace.span("fwd", "conv1_1") is trace.span("fwd", "conv1_2")


def test_a_span_closes_on_an_exception():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with trace.span("fwd", "conv3_1"):
                raise ValueError("in the site")
        with trace.span("fwd", "conv3_2"):
            pass
    seg = {e.name: e for e in prof.events() if e.name.startswith("seg:")}
    assert set(seg) == {"seg:fwd:conv3_1", "seg:fwd:conv3_2"}
    assert seg["seg:fwd:conv3_2"].cpu_parent is None


# ---- the routes ----------------------------------------------------------
@pytest.mark.parametrize("route", ["bf16", "int8", "int8_fused"])
def test_a_served_request_opens_one_span_per_site(route, tiny):
    cfg, params = tiny
    hw = (256, 256) if route == "int8_fused" else (188, 188)
    x = torch.rand(1, *hw, 3)
    if route == "bf16":
        srv = _bf16_server(cfg, params)
    else:
        q = UNetS2DInt8(cfg, ops=conv_flat.PLAIN_OPS,
                        ops8=conv_int8.PLAIN_OPS)
        srv = Server(q, params, q.prepare(params, calib_batches=[x],
                                          dtype=torch.bfloat16))
    names = _ranges(lambda: srv(x.to(torch.bfloat16)))
    sites = (["conv1_1+conv1_2"] if route == "int8_fused"
             else SERVED[:2]) + SERVED[2:]
    assert names == ["seg:serve:request"] + [f"seg:fwd:{s}" for s in sites]


def test_the_train_step_keeps_the_parents_ranges(tiny):
    cfg, params = tiny
    with tempfile.TemporaryDirectory() as tmp:
        trainer = _trainer(cfg, params, tmp)
        names = _ranges(lambda: trainer.train_step(_batch((188, 188))))
    count = collections.Counter(names)
    assert set(count) == PARENT_TRAIN_RANGES | STD_BWD_RANGES | {
        "seg:train:step", "seg:train:sync"}
    assert count["seg:train:step"] == count["seg:train:sync"] == 1
    assert count["seg:fwd:loss"] == 1


def test_set_up_spans_nest_and_own_their_time(tiny):
    """The int8 route's set-up: the bf16 and the int8 weights, packed once,
    in one ``setup:prepare``; the calibration holds the plan."""
    cfg, params = tiny
    x = torch.rand(1, 188, 188, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _int8_model(cfg).prepare(params, calib_batches=[x],
                                 dtype=torch.bfloat16)
    setup = [e for e in prof.events() if e.name.startswith("seg:setup:")]
    assert collections.Counter(e.name for e in setup) == {
        "seg:setup:prepare": 1, "seg:setup:calibrate": 1,
        "seg:setup:plan": 1}
    plan = next(e for e in setup if e.name == "seg:setup:plan")
    assert "seg:setup:calibrate" in _parents(plan)
    own = ps.setup_seconds(prof.events())
    assert set(own) == {"setup:prepare", "setup:calibrate", "setup:plan"}
    assert all(v >= 0 for v in own.values())


def test_no_range_bypasses_the_trace_module():
    """Every profiler range of the port is opened by utils/trace.py."""
    found = [str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")
             if "record_function" in p.read_text()
             or "RecordFunction" in p.read_text()]
    assert found == ["utils/trace.py"]


# ---- profile_serving's span reductions -------------------------------------
class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    """A FunctionEvent's fields that the reductions read."""

    def __init__(self, name, span, parent=None, kernels=(), device=False):
        self.name, self.cpu_parent = name, parent
        self.time_range = _Range(*span)
        self.kernels = list(kernels)
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.is_user_annotation = False


Kernel = collections.namedtuple("Kernel", "name device duration")


def _request_trace():
    """Two requests, [0, 100) and [200, 260): the device runs [10, 40),
    [30, 90) and [215, 255); the first request enqueues four calls (one
    a memcpy, one from another thread), one more lies between them."""
    r1 = _Event("seg:serve:request", (0, 100))
    conv = _Event("seg:fwd:conv3_1", (5, 50), r1)
    op = _Event("aten::cudnn_convolution", (6, 45), conv,
                [Kernel("sm90_xmma_fprop", 0, 30.0)])
    head = _Event("seg:fwd:conv9_2+head", (50, 98), r1,
                  [Kernel("packed_conv2x2_fwd_kernel", 0, 60.0)])
    r2 = _Event("seg:serve:request", (200, 260))
    pool = _Event("seg:fwd:std_pool", (205, 250), r2)
    pool_op = _Event("aten::max_pool2d", (206, 240), pool,
                     [Kernel("max_pool_forward_nhwc", 0, 40.0)])
    return [r1, conv, op, head, r2, pool, pool_op,
            _Event("cudaLaunchKernel", (8, 9), op),
            _Event("cudaLaunchKernelExC", (52, 53), head),
            _Event("cudaMemcpyAsync", (96, 97), r1),
            _Event("cudaLaunchKernel", (20, 21)),
            _Event("cudaLaunchKernel", (150, 151)),
            _Event("cudaStreamSynchronize", (97, 99), r1),
            _Event("cudaLaunchKernel", (210, 211), pool_op),
            _Event("sm90_xmma_fprop", (10, 40), device=True),
            _Event("packed_conv2x2_fwd_kernel", (30, 90), device=True),
            _Event("max_pool_forward_nhwc", (215, 255), device=True),
            _Event("seg:fwd:conv3_1", (5, 50), device=True)]


def test_span_readings_count_calls_and_idle_inside_requests():
    r = ps.span_readings(_request_trace())
    # request 1: calls at 8, 20, 52, 96; busy [10, 90): idle 20
    # request 2: one call; busy [215, 255): idle 20
    assert r["requests"] == [[4, pytest.approx(20.0)],
                             [1, pytest.approx(20.0)]]
    assert r["site_us"] == {"conv3_1": 30.0, "conv9_2+head": 60.0,
                            "std_pool": 40.0}
    assert r["sync_idle_us"] == []


def test_span_readings_time_the_sync_to_the_next_loss():
    """Step k's sync ends at 100; step k+1's fwd:loss ends at 180; the
    device runs [120, 150) in between: 50 µs idle. The last sync has no
    next loss and is not read."""
    events = [_Event("seg:train:sync", (90, 100)),
              _Event("seg:fwd:loss", (170, 180)),
              _Event("seg:fwd:loss", (20, 30)),
              _Event("seg:train:sync", (250, 260)),
              _Event("elementwise_kernel", (120, 150), device=True),
              _Event("elementwise_kernel", (185, 300), device=True)]
    r = ps.span_readings(events)
    assert r["sync_idle_us"] == [pytest.approx(50.0)]
    assert r["requests"] == []


def test_gap_names_give_the_span_and_the_op():
    """The device runs [10, 90) and [215, 255): one gap, 125 µs, named at
    its middle (152.5) by the innermost span and op on the host."""
    unpack = _Event("seg:fwd:unpack", (130, 175))
    clone = _Event("aten::clone", (140, 170), unpack)
    events = _request_trace()
    assert ps.gap_names(events + [unpack, clone]) == [
        ["fwd:unpack | aten::clone", pytest.approx(125e-6)]]
    assert ps.gap_names(events + [unpack]) == [
        ["fwd:unpack | python between ops", pytest.approx(125e-6)]]
    assert ps.gap_names(events) == [
        ["(no span) | python between ops", pytest.approx(125e-6)]]


@pytest.mark.parametrize("a,b,idle", [
    (0, 10, 10.0), (0, 100, 75.0), (15, 25, 0.0), (25, 35, 5.0),
    (45, 200, 155.0)])
def test_idle_us_clips_the_merged_pieces(a, b, idle):
    pieces = ps.merge([(10, 20), (15, 30), (40, 45)])
    assert pieces == [(10, 30), (40, 45)]
    assert ps.idle_us(a, b, pieces) == pytest.approx(idle)


@pytest.mark.parametrize("inner,own", [
    # setup:kernels inside the plan: no span counts it twice
    ("setup:kernels", {"setup:calibrate": 70e-6, "setup:plan": 20e-6,
                       "setup:kernels": 10e-6, "setup:prepare": 60e-6}),
    # an op inside the plan is the plan's own time
    ("aten::copy_", {"setup:calibrate": 70e-6, "setup:plan": 30e-6,
                     "setup:prepare": 60e-6}),
])
def test_setup_seconds_subtract_the_setup_spans_inside(inner, own):
    """calibrate [0, 100) ⊃ plan [20, 50) ⊃ ``inner`` [30, 40); prepare
    [200, 260) holds an op [210, 250), not a span."""
    cal = _Event("seg:setup:calibrate", (0, 100))
    plan = _Event("seg:setup:plan", (20, 50), cal)
    prep = _Event("seg:setup:prepare", (200, 260))
    events = [cal, plan, _Event(f"seg:{inner}" if inner.startswith("setup")
                                else inner, (30, 40), plan),
              prep, _Event("aten::to", (210, 250), prep),
              _Event("seg:fwd:conv1_1", (5, 15), cal)]
    assert ps.setup_seconds(events) == pytest.approx(own)
