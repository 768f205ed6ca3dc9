"""The train profiler's bookkeeping (segmentation_tpu_torch/
profile_train.py), on CPU: the call site of a launching op (its innermost
``seg:`` range behind its autograd node), the call-site categories, the
attribution of device activities to sites over stand-in trace events, and
the bytes the flagship's Functions must move."""

import collections

import pytest
from torch.autograd import DeviceType

from segmentation_tpu_torch import profile_train as pt

Kernel = collections.namedtuple("Kernel", "name device duration")


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    """A FunctionEvent's fields that the profiler reads."""

    def __init__(self, name, parent=None, kernels=(), device=False,
                 span=(0.0, 0.0), annotation=False):
        self.name, self.cpu_parent = name, parent
        self.kernels = list(kernels)
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.time_range = _Range(*span)
        self.is_user_annotation = annotation


def _chain(*names):
    e = None
    for n in names:
        e = _Event(n, e)
    return e


@pytest.mark.parametrize("names,site", [
    (("seg:fwd:conv1_2", "aten::empty"), "fwd:conv1_2"),
    (("autograd::engine::evaluate_function: _Conv2x2DualBackward",
      "seg:bwd:conv9_1/wgrad", "aten::bmm"),
     "_Conv2x2DualBackward bwd:conv9_1/wgrad"),
    (("autograd::engine::evaluate_function: ReluBackward0",
      "aten::threshold_backward"), "ReluBackward0"),
    (("Optimizer.step#Adam.step", "seg:optimizer", "aten::_foreach_add"),
     "optimizer"),
    (("autograd::engine::evaluate_function: _StdConv3x3DualBackward",
      "seg:bwd:conv6_1/dgrad", "aten::convolution_backward"),
     "_StdConv3x3DualBackward bwd:conv6_1/dgrad"),
    (("aten::item", "aten::_local_scalar_dense"), "aten::item"),
])
def test_site_of(names, site):
    assert pt.site_of(_chain(*names)) == site


@pytest.mark.parametrize("site,group,cat", [
    ("fwd:pool1", "other", "pool4_select forward"),
    ("fwd:conv1_1", "H3 strided_conv4x4s2", "conv1_1 entry (forward)"),
    ("fwd:conv9_1", "copies", "packed forwards: crop copies"),
    ("fwd:conv9_1", "H2 packed_conv2x2_dual", "packed forwards: H1-H4"),
    ("fwd:conv4_2", "H8 std_conv3x3 bf16",
     "std levels forward: 3x3 convs (H8)"),
    ("fwd:upconv1", "library conv",
     "std levels forward: upconv1-2, pools (cuDNN, ATen)"),
    ("fwd:std_pool", "other",
     "std levels forward: upconv1-2, pools (cuDNN, ATen)"),
    ("fwd:loss", "other", "head, loss, input, weight packing"),
    ("_Conv2x2PoolBackward", "glue relu_bias_grad",
     "packed backward: mask + bias grad (+ pool, un-crop)"),
    ("_Conv2x2Backward bwd:conv1_2/mask", "other",
     "packed backward: mask + bias grad (+ pool, un-crop)"),
    ("_Conv2x2Backward bwd:conv1_2/wgrad", "copies",
     "packed backward: wgrad copies / pads"),
    ("_Conv2x2DualBackward bwd:conv8_1/wgrad", "library GEMM",
     "packed backward: wgrads"),
    ("_Conv2x2DualBackward", "H6 packed_conv2x2_dgrad",
     "packed backward: dgrads"),
    ("_Pool4SelectBackward", "other", "pool4_select backward"),
    ("SliceBackward0", "copies",
     "crop backward (SliceBackward0: packed and std crops)"),
    ("ConvolutionBackward0", "library conv",
     "std levels backward: upconv1-2, pools (cuDNN, ATen)"),
    ("MaxPool2DWithIndicesBackward0", "other",
     "std levels backward: upconv1-2, pools (cuDNN, ATen)"),
    ("_StdConv3x3Backward bwd:conv3_1/mask_bias", "glue relu_bias_grad",
     "std levels backward: mask + bias grad"),
    ("_StdConv3x3Backward", "glue relu_bias_grad",
     "std levels backward: mask + bias grad"),
    ("_StdConv3x3Backward bwd:conv5_2/dgrad", "library conv",
     "std levels backward: dgrads (+ the dual's un-crop)"),
    ("_StdConv3x3DualBackward bwd:conv6_1/dgrad", "copies",
     "std levels backward: dgrads (+ the dual's un-crop)"),
    ("_StdConv3x3Backward bwd:conv3_2/wgrad", "library conv",
     "std levels backward: wgrads (+ the dual's crop copy)"),
    ("_StdConv3x3DualBackward bwd:conv7_1/wgrad", "copies",
     "std levels backward: wgrads (+ the dual's crop copy)"),
    ("optimizer", "other", "optimizer"),
    ("MmBackward0", "library GEMM", "head, loss, input, weight packing"),
])
def test_category(site, group, cat):
    assert pt.category(site, group) == cat


def test_attribute_sums_each_site_and_leaves_annotations_out():
    fwd = _Event("seg:fwd:conv1_2")
    op = _Event("aten::mm", fwd, [Kernel("nvjet_tst_x", 0, 30.0)])
    node = _Event("autograd::engine::evaluate_function: _Conv2x2Backward")
    glue = _Event("seg:bwd:conv1_2/mask_bias", node)
    launch = _Event("cudaLaunchKernel", glue,
                    [Kernel("relu_bias_grad_kernel<true, true>", 0, 50.0)])
    events = [fwd, op, node, glue, launch,
              _Event("nvjet_tst_x", device=True, span=(0.0, 30.0)),
              _Event("relu_bias_grad_kernel<true, true>", device=True,
                     span=(40.0, 90.0)),
              _Event("memset", device=True, span=(95.0, 100.0)),
              _Event("seg:fwd:conv1_2", device=True, span=(0.0, 100.0),
                     annotation=True)]
    dev_ms, sites, by_group, share, rest = pt.attribute(events, 2)
    assert dev_ms == pytest.approx(85.0 / 2 / 1e3)
    assert sites == {"fwd:conv1_2": (pytest.approx(0.015), 0.5),
                     "_Conv2x2Backward bwd:conv1_2/mask_bias":
                         (pytest.approx(0.025), 0.5)}
    assert by_group[("_Conv2x2Backward bwd:conv1_2/mask_bias",
                     "glue relu_bias_grad")] == pytest.approx(0.025)
    assert share == pytest.approx(80.0 / 85.0)
    assert rest == {"memset": pytest.approx(5.0 / 2 / 1e3)}


def test_function_bytes():
    """One sample's bytes, counted by hand at two sites and summed: the
    entry reads the image and writes y forward, reads g, y and the image
    back (no dx); a level site adds its pool and index both ways."""
    x1, y1 = 512 * 512 * 3 * 2, 255 * 255 * 128 * 2
    entry = (x1 + y1) + (y1 + y1 + x1)
    x2, y2 = y1, 254 * 254 * 128 * 2
    extra = 254 * 254 * 32 * 3
    level = (x2 + y2 + extra) + (2 * y2 + extra + 2 * x2)
    assert len(pt.FLAGSHIP_SITES) == 10
    assert pt.function_bytes(1) > entry + level
    assert pt.function_bytes(3) == 3 * pt.function_bytes(1)
    sites = pt.FLAGSHIP_SITES
    try:
        pt.FLAGSHIP_SITES = sites[:2]
        assert pt.function_bytes(1) == entry + level
    finally:
        pt.FLAGSHIP_SITES = sites
