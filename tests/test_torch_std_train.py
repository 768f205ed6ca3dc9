"""The train route's standard-level 3×3 convs (nn/kernels/train.py
std_conv3x3_t, std_conv3x3_dual_t): H8's bf16 mode forward, bias and ReLU
fused; backward the glue's mask and bias grad in one pass, then cuDNN's
dgrad and wgrad of the masked cotangent.

On the CPU: each Function on the plain versions against autograd through
nn/layers.conv2d in f32 (the dual against the crop-and-concat conv, as
models/unet.py computes it): y and every gradient alike within f32
rounding (the two sum in other orders), the dual's skip gradient zero
outside its crop window; the backward's parts run in their spans; a
4-level UNetS2D step's std sites are these Functions, no autograd conv or
ReLU node of its own.

On the card (marked ``cuda``; they skip elsewhere):

    python -m pytest tests/test_torch_std_train.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py imports jax, which this file does
not need.) The Functions on the kernels against the same Functions on the
plain versions at every std site's shape of the 512² U-Net at n_kernels
32 and 64 (B = 2), and one B = 16 train step a width counting its H8 and
glue launches.

Card tolerance: y within one bf16 unit in the last place (2^-7), plus
1e-3 of the largest output where ReLU cuts a sum within f32 rounding of
zero (tests/test_torch_std_bf16.py); the gradients, which both sides take
from cuDNN on the masked cotangent, within 2^-7 of their norm (a mask
flipped by such a cut, bf16 rounding of the sums).
"""

import pytest
import torch

from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.nn import layers
from segmentation_tpu_torch.nn.kernels import conv_flat as cf
from segmentation_tpu_torch.nn.kernels import train as kt
from segmentation_tpu_torch.nn.kernels import train_glue as tg

F32 = dict(rtol=1e-5, atol=1e-5)
ULP, NEAR_ZERO = 2.0**-7, 1e-3


def _operands(gen, kind, n, up_hw, c, o, skip_hw=None, device="cpu",
              dtype=torch.float32):
    """The inputs (leaves that need grad), the f32 weight and bias, and a
    cotangent of the output's shape."""
    def act(*shape):
        t = torch.rand(shape, generator=gen, device=device).to(dtype)
        return t.requires_grad_(True)

    ci = 2 * c if kind == "dual" else c
    w = torch.randn((3, 3, ci, o), generator=gen, device=device)
    w = (w / (9 * ci) ** 0.5).requires_grad_(True)
    b = (torch.randn((o,), generator=gen, device=device) * 0.3) \
        .requires_grad_(True)
    xs = [act(n, *skip_hw, c)] if kind == "dual" else []
    xs.append(act(n, *up_hw, c))
    g = torch.randn((n, up_hw[0] - 2, up_hw[1] - 2, o), generator=gen,
                    device=device).to(dtype)
    return xs, w, b, g


def _offset(skip, up):
    return ((skip.shape[1] - up.shape[1]) // 2,
            (skip.shape[2] - up.shape[2]) // 2)


def _function(kind, xs, w, b, ops):
    if kind == "dual":
        return kt.std_conv3x3_dual_t(xs[0], xs[1], w, b,
                                     offset=_offset(*xs), ops=ops,
                                     site="conv6_1")
    return kt.std_conv3x3_t(xs[0], w, b, ops=ops, site="conv3_1")


def _reference(kind, xs, w, b):
    """autograd through nn/layers.conv2d: the single conv, or the conv of
    the concat of the skip's center crop and up."""
    if kind == "dual":
        crop = layers.center_crop_like(xs[0], xs[1])
        return layers.conv2d(torch.cat([crop, xs[1]], -1), w, b)
    return layers.conv2d(xs[0], w, b)


def _value_and_grads(fn, xs, w, b, g):
    y = fn()
    return (y.detach(), *torch.autograd.grad(y, [*xs, w, b], g))


# ------------------------------------------------------------------- CPU
CASES = {"single 9x13 C=64": ("single", (9, 13), 64, None),
         "single 7x8 C=128": ("single", (7, 8), 128, None),
         "dual 8x11 C=64 crop (4, 4)": ("dual", (8, 11), 64, (16, 19)),
         "dual 6x9 C=128 crop (3, 2)": ("dual", (6, 9), 128, (13, 14))}


@pytest.mark.parametrize("case", list(CASES))
def test_function_matches_layers_autograd_in_f32(case):
    kind, up_hw, c, skip_hw = CASES[case]
    xs, w, b, g = _operands(generator(7), kind, 2, up_hw, c, 128,
                            skip_hw=skip_hw)
    got = _value_and_grads(
        lambda: _function(kind, xs, w, b, cf.PLAIN_OPS), xs, w, b, g)
    want = _value_and_grads(lambda: _reference(kind, xs, w, b), xs, w, b, g)
    assert (got[0] > 0).any() and (got[0] == 0).any()  # ReLU cuts some
    for i, (a, e) in enumerate(zip(got, want)):
        assert a.dtype == e.dtype and a.shape == e.shape, i
        torch.testing.assert_close(a, e, **F32, msg=f"output {i}")
    if kind == "dual":
        (oh, ow), (_, h, wd, _) = _offset(*xs), xs[1].shape
        outside = got[1].clone()
        outside[:, oh : oh + h, ow : ow + wd] = 0
        assert not outside.any() and got[1].any()


def test_dual_refuses_a_crop_that_does_not_cover_up():
    xs, w, b, _ = _operands(generator(8), "dual", 1, (6, 9), 64, 128,
                            skip_hw=(13, 14))
    with pytest.raises(ValueError, match="does not cover"):
        kt.std_conv3x3_dual_t(xs[0], xs[1], w, b, offset=(8, 0))
    with pytest.raises(ValueError, match="does not cover"):
        kt.std_conv3x3_dual_t(xs[0], xs[1], w, b, offset=(3, 6))


@pytest.mark.parametrize("kind", ["single", "dual"])
def test_backward_runs_its_parts_in_their_spans(kind):
    from torch.profiler import ProfilerActivity, profile

    xs, w, b, g = _operands(generator(9), kind, 1, (6, 9), 64, 128,
                            skip_hw=(13, 14))
    y = _function(kind, xs, w, b, cf.PLAIN_OPS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y.backward(g)
    site = "conv6_1" if kind == "dual" else "conv3_1"
    spans = [e.name for e in prof.events() if e.name.startswith("seg:")]
    assert spans == [f"seg:bwd:{site}/{p}"
                     for p in ("mask_bias", "dgrad", "wgrad")]


def _node_counts(t):
    """The autograd graph of ``t``, each node type's count."""
    seen, stack, count = set(), [t.grad_fn], {}
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        name = type(node).__name__
        count[name] = count.get(name, 0) + 1
        stack.extend(f for f, _ in node.next_functions)
    return count


def _unet_step(cfg, x, ops=cf.KERNEL_OPS):
    """(the logits' node counts, H8's and the glue's launches) of one
    forward and backward of a 4-level UNetS2D."""
    from segmentation_tpu_torch.models.unet_fast import UNetS2D

    model = UNetS2D(cfg, seed=1, ops=ops).to(x.device)
    cf.reset_launches()
    tg.reset_launches()
    logits = model(x)
    nodes = _node_counts(logits)
    logits.float().square().mean().backward()
    return nodes, dict(cf.launches), dict(tg.launches)


def _std_nodes_only(nodes):
    """The ten std convs are the two Functions' nodes; the only autograd
    convolution and ReLU nodes left are upconv1–2's."""
    assert nodes.get("_StdConv3x3Backward") == 8, nodes
    assert nodes.get("_StdConv3x3DualBackward") == 2, nodes
    assert nodes.get("ConvolutionBackward0") == 2, nodes
    assert nodes.get("ReluBackward0") == 2, nodes


def test_unet_std_sites_are_the_functions():
    cfg = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=4)
    x = torch.rand((1, 188, 188, 3), generator=generator(2))
    nodes, _, _ = _unet_step(cfg, x.to(torch.bfloat16))
    _std_nodes_only(nodes)


# ------------------------------------------------------------------ card
@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return generator(0, "cuda")


# the ten std sites of the 512² U-Net at n_kernels 32: (up [H, W, C], O,
# the dual's skip [H, W]); at n_kernels 64, C and O twice these
SITES = {"conv3_1": ((125, 125, 64), 128, None),
         "conv3_2": ((123, 123, 128), 128, None),
         "conv4_1": ((60, 60, 128), 256, None),
         "conv4_2": ((58, 58, 256), 256, None),
         "conv5_1": ((28, 28, 256), 512, None),
         "conv5_2": ((26, 26, 512), 512, None),
         "conv6_1": ((48, 48, 256), 256, (56, 56)),
         "conv6_2": ((46, 46, 256), 256, None),
         "conv7_1": ((88, 88, 128), 128, (121, 121)),
         "conv7_2": ((86, 86, 128), 128, None)}


def _close(got, want, i):
    assert got.shape == want.shape and got.dtype == want.dtype, i
    a, e = got.double(), want.double()
    if i == 0:  # y: one bf16 rounding
        tol = ULP * e.abs() + NEAR_ZERO * e.abs().max()
        assert ((a - e).abs() <= tol).all(), ((a - e).abs() - tol).max()
    else:
        assert (a - e).norm() <= ULP * e.norm(), (i, (a - e).norm() /
                                                  e.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("site", list(SITES))
def test_function_kernels_vs_plain(gen, site, width):
    (h, w_, c), o, skip_hw = SITES[site]
    kind = "single" if skip_hw is None else "dual"
    xs, w, b, g = _operands(gen, kind, 2, (h, w_), c * width, o * width,
                            skip_hw=skip_hw, device="cuda",
                            dtype=torch.bfloat16)
    cf.reset_launches()
    tg.reset_launches()
    got = _value_and_grads(
        lambda: _function(kind, xs, w, b, cf.KERNEL_OPS), xs, w, b, g)
    torch.cuda.synchronize()
    assert cf.launches["std_conv3x3_dual" if kind == "dual"
                       else "std_conv3x3"] == 1
    assert tg.launches["relu_bias_grad"] == 1
    want = _value_and_grads(
        lambda: _function(kind, xs, w, b, cf.PLAIN_OPS), xs, w, b, g)
    for i, (a, e) in enumerate(zip(got, want)):
        _close(a, e, i)
    if kind == "dual":
        (oh, ow), dskip = _offset(*xs), got[1].clone()
        dskip[:, oh : oh + h, ow : ow + w_] = 0
        assert not dskip.any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_kernels", [32, 64])
def test_unet_step_launches_h8_and_the_glue(gen, n_kernels):
    """One B = 16 step at 512²: the eight single and two dual H8 launches
    forward, ten relu_bias_grad launches for them backward (beside the
    packed sites' eight and the two of the pool mode), and no autograd
    convolution or ReLU node at a std site."""
    cfg = ModelConfig(n_classes=2, input_dims=(512, 512),
                      n_kernels=n_kernels)
    x = torch.rand((16, 512, 512, 3), generator=gen, device="cuda")
    nodes, launches, glue = _unet_step(cfg, x.to(torch.bfloat16))
    assert launches["std_conv3x3"] == 8, launches
    assert launches["std_conv3x3_dual"] == 2, launches
    assert glue["relu_bias_grad"] == 8 + 10, glue
    assert glue["relu_bias_grad_pool"] == 2, glue
    _std_nodes_only(nodes)
