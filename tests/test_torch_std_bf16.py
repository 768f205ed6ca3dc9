"""H8's bf16 mode: the standard levels' 3×3 VALID convs of the bf16
serving forward, single and dual, bias and ReLU fused
(csrc/std_conv3x3_bf16.cu; conv_flat.std_conv3x3, std_conv3x3_dual).

On the CPU: the plain versions compute the function the kernel does (the
f32 sum of the bf16 products, the f32 bias, ReLU, one rounding), which in
f32 is nn/layers.conv2d and the concat-free dual exactly, and in bf16 the
unfused path within its roundings; the serving and train routes reach the
two ops at the ten std sites, a calibrated int8 request never.

On the card (marked ``cuda``; they skip elsewhere):

    python -m pytest tests/test_torch_std_bf16.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py imports jax, which this file does
not need.)

the kernel against its plain version at the ten site shapes of the 512²
U-Net (n_kernels 32) at B = 2 and one site at B = 64, the dual at both
crop offsets and an odd one, ragged tiles, an odd W, C = 64; the launch
counts of a request, a train step and a calibrated int8 request.

Card tolerance, one bf16 rounding: the kernel and the plain version sum
the same exact bf16 products in f32 in other orders (the plain one through
cuDNN, TF32 off), a difference far below bf16's resolution, then each
rounds once to bf16; so an output differs at most by one bf16 unit in the
last place (2^-7 of its magnitude), plus, where ReLU cuts a sum that lies
within f32 rounding of zero, 1e-3 of the largest output.
"""

import pytest
import torch

from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.models.unet import init_params
from segmentation_tpu_torch.models.unet_fast import (
    UNetS2DInference,
    UNetS2DTrain,
)
from segmentation_tpu_torch.nn import layers
from segmentation_tpu_torch.nn.kernels import conv_flat as cf

ULP, NEAR_ZERO = 2.0**-7, 1e-3

# the ten std sites of one 512² request: x [N, H, W, C] (the dual: skip,
# up) and O; the duals' crop origins (4, 4) and (16, 16)
SINGLE = {"conv3_1": ((125, 125, 64), 128),
          "conv3_2": ((123, 123, 128), 128),
          "conv4_1": ((60, 60, 128), 256),
          "conv4_2": ((58, 58, 256), 256),
          "conv5_1": ((28, 28, 256), 512),
          "conv5_2": ((26, 26, 512), 512),
          "conv6_2": ((46, 46, 256), 256),
          "conv7_2": ((86, 86, 128), 128)}
DUAL = {"conv6_1": ((56, 56, 256), (48, 48, 256), 256),
        "conv7_1": ((121, 121, 128), (88, 88, 128), 128)}


def _act(gen, *shape, device="cpu"):
    return torch.rand(shape, generator=gen, device=device).to(torch.bfloat16)


def _wgt(gen, *shape, device="cpu"):
    w = torch.randn(shape, generator=gen, device=device)
    return (w / (shape[0] * shape[1] * shape[2]) ** 0.5).to(torch.bfloat16)


def _bias(gen, o, device="cpu"):
    """f32 biases of the activations' size, so that ReLU cuts about half."""
    return torch.randn((o,), generator=gen, device=device) * 0.3


def _offset(skip, up):
    return ((skip.shape[1] - up.shape[1]) // 2,
            (skip.shape[2] - up.shape[2]) // 2)


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("shape,o", [((2, 13, 21, 64), 128),
                                     ((1, 9, 11, 128), 256),
                                     ((1, 7, 8, 256), 512)])
def test_plain_is_layers_conv2d_in_f32(shape, o):
    """In f32 the op's function is nn/layers.conv2d's, bit for bit: the
    same conv call, the bias and ReLU in f32."""
    gen = generator(3)
    x = torch.rand(shape, generator=gen)
    w = _wgt(gen, 3, 3, shape[-1], o).float()
    b = _bias(gen, o)
    assert torch.equal(cf.std_conv3x3_plain(x, w, b),
                       layers.conv2d(x, w, b))
    assert torch.equal(cf.std_conv3x3(x, w, b), layers.conv2d(x, w, b))


@pytest.mark.parametrize("c,o", [(64, 128), (128, 256)])
def test_plain_dual_is_the_concat_free_dual_in_f32(c, o):
    """In f32 the dual's function is the concat-free dual (crop, two convs,
    their sum, the bias, ReLU) bit for bit, as both routes' hooks compute
    it, and the crop-and-concat conv within f32 rounding."""
    gen = generator(4)
    cfg = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=4)
    skip = torch.rand((2, 19, 23, c), generator=gen)
    up = torch.rand((2, 12, 15, c), generator=gen)
    w = _wgt(gen, 3, 3, 2 * c, o).float()
    b = _bias(gen, o)
    p = {"s/w": w, "s/b": b}
    sk = layers.center_crop_like(skip, up)
    want = torch.relu(layers.conv2d(sk, w[:, :, :c], activation=None)
                      + layers.conv2d(up, w[:, :, c:], activation=None) + b)
    off = _offset(skip, up)
    got = cf.std_conv3x3_dual_plain(skip, up, w[:, :, :c], w[:, :, c:], b,
                                    offset=off)
    assert torch.equal(got, want)
    for route in (UNetS2DInference, UNetS2DTrain):
        assert torch.equal(route(cfg)._std_dual_conv(p, "s", skip, up), want)
    crop = layers.center_crop_like(skip, up)
    cat = layers.conv2d(torch.cat([crop, up], -1), w, b)
    torch.testing.assert_close(got, cat, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,o", [((2, 13, 21, 64), 128),
                                     ((1, 9, 11, 128), 256)])
def test_plain_bf16_is_the_unfused_path_within_its_roundings(shape, o):
    """In bf16 the op rounds once, the unfused path (conv2d, then _finish's
    bias add) twice: each rounding is within half a bf16 unit, 2^-8 of
    the value it rounds, so the two differ by at most 2^-8 (|conv| +
    2 |conv + b|) <= 2^-8 (3 |conv| + 2 |b|) elementwise (ReLU moves no
    difference up)."""
    gen = generator(5)
    x = _act(gen, *shape)
    w, b = _wgt(gen, 3, 3, shape[-1], o), _bias(gen, o)
    b16 = b.to(torch.bfloat16)  # the unfused path's bias, bf16
    got = cf.std_conv3x3_plain(x, w, b16.float())
    assert got.dtype == torch.bfloat16
    want = layers.conv2d(x, w, b16)
    conv = layers.conv2d(x.float(), w.float(), activation=None)
    tol = 2.0**-8 * (3 * conv.abs() + 2 * b16.float().abs())
    assert ((got.float() - want.float()).abs() <= tol).all()
    assert not torch.equal(got, want)  # the roundings do differ somewhere


def test_plain_dual_bf16_reads_the_skip_at_the_crop_origin():
    """The dual reads the skip in place at the crop origin (here odd) and
    rounds once: equal to the plain single on the concatenated crop."""
    gen = generator(6)
    skip, up = _act(gen, 1, 17, 20, 64), _act(gen, 1, 10, 13, 64)
    w, b = _wgt(gen, 3, 3, 128, 128), _bias(gen, 128)
    off = _offset(skip, up)
    assert off == (3, 3)
    got = cf.std_conv3x3_dual_plain(skip, up, w[:, :, :64], w[:, :, 64:], b,
                                    offset=off)
    crop = skip[:, 3:13, 3:16]
    want = cf.std_conv3x3_plain(torch.cat([crop, up], -1), w, b)
    torch.testing.assert_close(got.float(), want.float(), rtol=ULP, atol=1e-6)


def _recording_ops(calls):
    def single(x, w, b):
        calls.append(("std_conv3x3", tuple(x.shape), None))
        return cf.std_conv3x3(x, w, b)

    def dual(skip, up, wa, wb, b, *, offset):
        calls.append(("std_conv3x3_dual", tuple(up.shape), tuple(offset)))
        assert not wa.is_contiguous()  # views of the concat weight
        return cf.std_conv3x3_dual(skip, up, wa, wb, b, offset=offset)

    return cf.KERNEL_OPS._replace(std_conv3x3=single, std_conv3x3_dual=dual)


def test_serving_route_runs_the_ten_std_sites():
    """The bf16 serving forward (4 levels; CPU, the plain versions) takes
    the eight single std convs and the two duals through the ops, each
    dual at its crop origin, with the prepared f32 biases."""
    cfg = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=4)
    calls = []
    model = UNetS2DInference(cfg, ops=_recording_ops(calls))
    p = model.prepare(init_params(cfg, generator(0)), dtype=torch.bfloat16)
    assert all(p[f"{s}/b"].dtype == torch.float32
               for s in model.sites.std)
    model.apply_argmax(p, _act(generator(1), 1, 188, 188, 3))
    assert [c[0] for c in calls] == ["std_conv3x3"] * 6 + [
        "std_conv3x3_dual", "std_conv3x3", "std_conv3x3_dual", "std_conv3x3"]
    assert [c[2] for c in calls if c[2]] == [(4, 4), (16, 16)]


def test_train_forward_calls_the_ops_and_int8_requests_never():
    """The train route's forward takes the ten std sites through the ops
    as serving does (its std_conv3x3_t / std_conv3x3_dual_t Functions),
    and its backward calls them no more; the int8 route reaches the bf16
    mode only while it calibrates, never in a request."""
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8
    from segmentation_tpu_torch.nn.kernels import conv_int8 as ci

    cfg = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=4)
    calls = []
    model = UNetS2D(cfg, ops=_recording_ops(calls))
    x = _act(generator(2), 1, 188, 188, 3)
    logits = model(x)
    assert [c[0] for c in calls] == ["std_conv3x3"] * 6 + [
        "std_conv3x3_dual", "std_conv3x3", "std_conv3x3_dual", "std_conv3x3"]
    assert [c[2] for c in calls if c[2]] == [(4, 4), (16, 16)]
    calls.clear()
    logits.float().sum().backward()
    assert calls == []
    q = UNetS2DInt8(cfg, ops=_recording_ops(calls), ops8=ci.PLAIN_OPS)
    p = q.prepare(init_params(cfg, generator(0)), calib_batches=[x])
    assert len(calls) == 10  # the calibration's bf16 forward
    calls.clear()
    q.apply_argmax(p, x)
    assert calls == []


# ------------------------------------------------------------------ card
@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return generator(0, "cuda")


def _check(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == \
        torch.bfloat16
    err = (got.float() - want.float()).abs()
    tol = ULP * want.float().abs() + NEAR_ZERO * want.float().abs().max()
    assert (err <= tol).all(), (err - tol).max().item()


def _single(gen, n, shape, o):
    x = _act(gen, n, *shape, device="cuda")
    w = _wgt(gen, 3, 3, shape[-1], o, device="cuda")
    return x, w, _bias(gen, o, device="cuda")


def _dual(gen, n, sshape, ushape, o):
    c = ushape[-1]
    skip = _act(gen, n, *sshape, device="cuda")
    up = _act(gen, n, *ushape, device="cuda")
    w = _wgt(gen, 3, 3, 2 * c, o, device="cuda")
    return skip, up, w[:, :, :c], w[:, :, c:], _bias(gen, o, device="cuda")


SINGLE_CASES = {**{k: (2, *v) for k, v in SINGLE.items()},
                "conv4_2 B=64": (64, *SINGLE["conv4_2"]),
                "odd W": (2, (13, 21, 128), 128),
                "ragged O=256": (2, (13, 21, 128), 256),
                "one pixel": (2, (3, 3, 128), 512),
                "N=3": (3, (20, 45, 256), 128),
                "C=8": (1, (9, 13, 8), 128),
                "C=96": (1, (12, 17, 96), 256),
                "wide": (1, (8, 300, 128), 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SINGLE_CASES))
def test_std_conv3x3_kernel(gen, case):
    n, shape, o = SINGLE_CASES[case]
    args = _single(gen, n, shape, o)
    cf.reset_launches()
    _check(cf.std_conv3x3(*args), cf.std_conv3x3_plain(*args))
    assert cf.launches["std_conv3x3"] == 1


DUAL_CASES = {**{k: (2, *v) for k, v in DUAL.items()},
              "odd origin": (2, (20, 25, 128), (13, 21, 128), 256),
              "C=64": (1, (15, 17, 64), (9, 11, 64), 128),
              "O=512": (1, (14, 14, 128), (10, 10, 128), 512),
              "N=3": (3, (24, 49, 256), (20, 45, 256), 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DUAL_CASES))
def test_std_conv3x3_dual_kernel(gen, case):
    n, sshape, ushape, o = DUAL_CASES[case]
    skip, up, wa, wb, b = _dual(gen, n, sshape, ushape, o)
    off = _offset(skip, up)
    cf.reset_launches()
    _check(cf.std_conv3x3_dual(skip, up, wa, wb, b, offset=off),
           cf.std_conv3x3_dual_plain(skip, up, wa, wb, b, offset=off))
    assert cf.launches["std_conv3x3_dual"] == 1


@pytest.mark.cuda
def test_std_conv3x3_is_deterministic(gen):
    args = _single(gen, 2, *SINGLE["conv5_1"])
    dargs = _dual(gen, 2, *DUAL["conv7_1"])
    for fn, a, kw in ((cf.std_conv3x3, args, {}),
                      (cf.std_conv3x3_dual, dargs, {"offset": (16, 16)})):
        first, second = fn(*a, **kw), fn(*a, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_std_conv3x3_refuses_bad_operands(gen):
    """No fallback: a call the kernel does not take raises."""
    x, w, b = _single(gen, 1, (9, 11, 128), 128)
    with pytest.raises(TypeError):
        cf.std_conv3x3(x, w, b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="bad input shape"):
        cf.std_conv3x3(x, w[..., :64], b[:64])
    with pytest.raises(ValueError, match="strides"):
        cf.std_conv3x3(x, w.transpose(0, 1), b)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
        cf.std_conv3x3(flat[1:].view(x.shape).copy_(x), w, b)
    skip, up, wa, wb, b2 = _dual(gen, 1, (15, 17, 128), (9, 11, 128), 128)
    with pytest.raises(ValueError, match="does not cover"):
        cf.std_conv3x3_dual(skip, up, wa, wb, b2, offset=(8, 0))
    with pytest.raises(ValueError, match="strides"):
        cf.std_conv3x3_dual(skip, up, wa, wb.contiguous(), b2, offset=(3, 3))


def _params(cfg, device):
    return {k: v.to(device) for k, v in init_params(cfg, generator(1)).items()}


@pytest.mark.cuda
def test_a_bf16_request_launches_eight_singles_and_two_duals(gen):
    cfg = ModelConfig(n_classes=2, input_dims=(256, 256), n_kernels=32)
    model = UNetS2DInference(cfg)
    p = model.prepare(_params(cfg, "cuda"), dtype=torch.bfloat16,
                      device="cuda")
    x = _act(gen, 2, 256, 256, 3, device="cuda")
    cf.reset_launches()
    got = model.apply_argmax(p, x)
    assert cf.launches["std_conv3x3"] == 8
    assert cf.launches["std_conv3x3_dual"] == 2
    plain = UNetS2DInference(cfg, ops=cf.PLAIN_OPS).apply_argmax(p, x)
    assert (got == plain).float().mean().item() >= 0.99


@pytest.mark.cuda
def test_train_step_and_calibrated_int8_request_launch_none(gen, tmp_path):
    from segmentation_tpu_torch.core.config import TrainConfig
    from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8
    from segmentation_tpu_torch.training.trainer import SegmentationTrainer

    cfg = ModelConfig(n_classes=2, input_dims=(256, 256), n_kernels=32)
    trainer = SegmentationTrainer(
        UNetS2D(cfg, seed=1), device="cuda",
        train_cfg=TrainConfig(save_dir=str(tmp_path)))
    cf.reset_launches()
    trainer.loss_and_grads(SyntheticSegmentation(2, (256, 256),
                                                 seed=3).get_batch())
    assert cf.launches["packed_conv2x2"] > 0
    assert cf.launches["std_conv3x3"] == 8  # the train forward's, as served
    assert cf.launches["std_conv3x3_dual"] == 2
    x = _act(gen, 2, 256, 256, 3, device="cuda")
    cf.reset_launches()
    q = UNetS2DInt8(cfg)
    p = q.prepare(_params(cfg, "cuda"), calib_batches=[x], device="cuda")
    assert cf.launches["std_conv3x3"] == 8  # the calibration's forward
    cf.reset_launches()
    q.apply_argmax(p, x)
    assert cf.launches["std_conv3x3"] == cf.launches["std_conv3x3_dual"] \
        == 0, cf.launches
