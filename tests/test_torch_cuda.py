"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small shapes (every mode). Marked ``cuda``: they skip where
there is no GPU; run them there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py imports jax, which this file does
not need.)

Tolerance: bf16 outputs, 2e-2 of the largest reference value (the kernel
and the plain version round the same f32 sums, in another order, to 8
mantissa bits); masks may differ on margins below bf16 resolution. int8
modes: the s8 × s8 products are exact on both sides and the epilogues
round in the same order, so s8 codes may differ by at most one, on at most
1e-3 of the elements (H5's bf16 conv1_1 sums in f32 in another order).
"""

import pytest
import torch

from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
from segmentation_tpu_torch.nn.kernels import conv_flat as cf
from segmentation_tpu_torch.nn.kernels import conv_int8 as ci

pytestmark = pytest.mark.cuda
REL_TOL, MASK_AGREE = 2e-2, 0.99


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return generator(0, "cuda")


def _act(gen, *shape):
    return torch.rand(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _wgt(gen, *shape):
    k = 1
    for s in shape[:-1]:
        k *= s
    w = torch.randn(shape, generator=gen, device="cuda") / k**0.5
    return w.to(torch.bfloat16)


def _bias(gen, o4):
    return torch.randn((o4,), generator=gen, device="cuda") * 0.1


def _check(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == torch.uint8:
            assert (g == w).float().mean().item() >= MASK_AGREE
        else:
            err = (g.float() - w.float()).abs().max().item()
            assert err <= REL_TOL * w.float().abs().max().item(), err


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("mode", ["plain", "pool", "head_only", "head"])
def test_packed_conv2x2_kernel(gen, o4, mode):
    x = _act(gen, 2, 13, 21, 128)
    args = (x, _wgt(gen, 2, 2, 128, o4), _bias(gen, o4))
    kw = {"pool": mode == "pool"}
    if mode.startswith("head"):
        kw["head"] = (_wgt(gen, o4, 4),
                      torch.randn((4,), generator=gen, device="cuda"))
        kw["head_only"] = mode == "head_only"
    _check(cf.packed_conv2x2(*args, **kw),
           cf.packed_conv2x2_plain(*args, **kw))


@pytest.mark.parametrize("offset", [(0, 0), (6, 4), (5, 7), (2, 3)])
def test_packed_conv2x2_dual_kernel(gen, offset):
    skip, up = _act(gen, 2, 15, 17, 256), _act(gen, 2, 9, 11, 256)
    args = (skip, up, _wgt(gen, 2, 2, 256, 256), _wgt(gen, 2, 2, 256, 256),
            _bias(gen, 256))
    _check(cf.packed_conv2x2_dual(*args, offset=offset),
           cf.packed_conv2x2_dual_plain(*args, offset=offset))


@pytest.mark.parametrize("c,o4", [(3, 128), (32, 256), (5, 256)])
def test_strided_conv4x4s2_kernel(gen, c, o4):
    args = (_act(gen, 2, 22, 19, c), _wgt(gen, 4, 4, c, o4), _bias(gen, o4))
    _check(cf.strided_conv4x4s2(*args), cf.strided_conv4x4s2_plain(*args))


@pytest.mark.parametrize("scatter", [False, True])
def test_rows_matmul_kernel(gen, scatter):
    c = 64 if scatter else 128
    x = _act(gen, 2, 7, 9, 4 * c if scatter else c)
    args = (x, _wgt(gen, c, 128), _bias(gen, 128))
    _check(cf.rows_matmul(*args, scatter=scatter),
           cf.rows_matmul_plain(*args, scatter=scatter))


def test_wrapper_refuses_bad_operands(gen):
    x = _act(gen, 1, 5, 5, 128)
    w, b = _wgt(gen, 2, 2, 128, 128), _bias(gen, 128)
    with pytest.raises(TypeError):
        cf.packed_conv2x2(x.float(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        cf.packed_conv2x2(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="128 or 256"):
        cf.packed_conv2x2(x, _wgt(gen, 2, 2, 128, 64), _bias(gen, 64))


def test_s2d_forward_kernels_vs_plain(gen):
    from segmentation_tpu_torch.core.config import ModelConfig
    from segmentation_tpu_torch.models.unet import init_params

    cfg = ModelConfig(n_classes=2, input_dims=(208, 208), n_kernels=32)
    params = {k: v.cuda() for k, v in init_params(cfg, generator(1)).items()}
    x = torch.rand((2, 208, 208, 3), generator=gen,
                   device="cuda").to(torch.bfloat16)
    fast = UNetS2DInference(cfg)
    prepared = fast.prepare(params, dtype=torch.bfloat16, device="cuda")
    plain = UNetS2DInference(cfg, ops=cf.PLAIN_OPS)
    cf.reset_launches()
    got = fast.apply_argmax(prepared, x)
    assert all(v > 0 for v in cf.launches.values()), cf.launches
    want = plain.apply_argmax(prepared, x)
    # 800 output pixels: hold each disagreement to a margin within bf16
    # rounding of the plain forward's logits instead of a pixel share
    logits = plain.apply(prepared, x).float()
    margin = (logits[..., 1] - logits[..., 0]).abs()
    diff = got != want
    assert bool((margin[diff] <= REL_TOL * logits.abs().max()).all())
    assert diff.float().mean().item() < 0.01


# ------------------------------------------------------------- int8 modes
def _s8(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def _requant_vecs(gen, o4, k):
    """mul/add spreading relu(acc·mul + add) of random s8 operands over
    the code range (acc has std ~ 127²/3 · √k)."""
    mul = (torch.rand((o4,), generator=gen, device="cuda") + 0.5) \
        * (60.0 / (5376.0 * k**0.5))
    return mul, torch.randn((o4,), generator=gen, device="cuda") * 10


def _check_s8(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == torch.int8:
            d = (g.int() - w.int()).abs()
            assert d.max().item() <= 1
            assert (d > 0).float().mean().item() <= 1e-3
        else:
            _check(g, w)


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("mode", ["requant", "pool", "float", "head_only"])
def test_packed_conv2x2_s8_kernel(gen, o4, mode):
    c4 = 256
    mul, add = _requant_vecs(gen, o4, 4 * c4)
    if mode in ("float", "head_only"):
        mul = mul / 20  # bf16 values of O(1)
    args = (_s8(gen, 2, 13, 21, c4), _s8(gen, 2, 2, c4, o4), mul, add)
    kw = {"pool": mode == "pool", "requant": mode in ("requant", "pool")}
    if mode == "head_only":
        kw["head"] = (_wgt(gen, o4, 4),
                      torch.randn((4,), generator=gen, device="cuda"))
        kw["head_only"] = True
    _check_s8(ci.packed_conv2x2_s8(*args, **kw),
              ci.packed_conv2x2_s8_plain(*args, **kw))


@pytest.mark.parametrize("c4,o4", [(256, 256), (128, 128)])
@pytest.mark.parametrize("offset", [(0, 0), (6, 4), (5, 7), (2, 3)])
def test_packed_conv2x2_dual_s8_kernel(gen, c4, o4, offset):
    skip, up = _s8(gen, 2, 15, 17, c4), _s8(gen, 2, 9, 11, c4)
    cs_a, _ = _requant_vecs(gen, o4, 8 * c4)
    cs_b, add = _requant_vecs(gen, o4, 8 * c4)
    mul = torch.ones((o4,), device="cuda")
    args = (skip, up, _s8(gen, 2, 2, c4, o4), _s8(gen, 2, 2, c4, o4), cs_a,
            cs_b, mul, add)
    _check_s8(ci.packed_conv2x2_dual_s8(*args, offset=offset),
              ci.packed_conv2x2_dual_s8_plain(*args, offset=offset))


@pytest.mark.parametrize("c,o4", [(32, 256), (16, 128)])
def test_strided_conv4x4s2_s8_kernel(gen, c, o4):
    args = (_s8(gen, 2, 22, 19, c), _s8(gen, 4, 4, c, o4),
            *_requant_vecs(gen, o4, 16 * c))
    _check_s8(ci.strided_conv4x4s2_s8(*args),
              ci.strided_conv4x4s2_s8_plain(*args))


@pytest.mark.parametrize("scatter", [False, True])
def test_rows_matmul_s8_kernel(gen, scatter):
    c, o4 = (64, 128) if scatter else (128, 256)
    x = _s8(gen, 2, 7, 9, 4 * c if scatter else c)
    args = (x, _s8(gen, c, o4), *_requant_vecs(gen, o4, c))
    _check_s8(ci.rows_matmul_s8(*args, scatter=scatter),
              ci.rows_matmul_s8_plain(*args, scatter=scatter))


def test_entry_chain_kernel(gen):
    """Partial tiles in both directions (17 × 33 outputs)."""
    x = _act(gen, 2, 38, 70, 3)
    w4 = _wgt(gen, 4, 4, 3, 128)
    oi1 = 1.0 / 0.02
    mul1 = torch.full((128,), oi1, device="cuda")
    add1 = _bias(gen, 128) * oi1
    args = (x, w4, mul1, add1, _s8(gen, 2, 2, 128, 128),
            *_requant_vecs(gen, 128, 512))
    _check_s8(ci.entry_chain(*args), ci.entry_chain_plain(*args))


def test_conv3x3_s8_int_mm(gen):
    x, wq = _s8(gen, 2, 9, 11, 64), _s8(gen, 3, 3, 64, 128)
    got = ci.conv3x3_s8(x, wq)
    assert got.dtype == torch.int32
    assert torch.equal(got, ci.conv3x3_s8_plain(x, wq))


def test_int8_forward_kernels_vs_plain(gen):
    """The calibrated int8 forward on the kernels against the same forward
    on the plain versions (same prepared weights and scales)."""
    from segmentation_tpu_torch.core.config import ModelConfig
    from segmentation_tpu_torch.models.unet import init_params
    from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8

    cfg = ModelConfig(n_classes=2, input_dims=(256, 256), n_kernels=32)
    params = {k: v.cuda() for k, v in init_params(cfg, generator(1)).items()}
    x = torch.rand((2, 256, 256, 3), generator=gen,
                   device="cuda").to(torch.bfloat16)
    fast = UNetS2DInt8(cfg)
    prepared = fast.prepare(params, calib_batches=[x], device="cuda")
    ci.reset_launches()
    got = fast.apply_argmax(prepared, x)
    assert all(v > 0 for v in ci.launches.values()), ci.launches
    plain = UNetS2DInt8(cfg, ops=cf.PLAIN_OPS, ops8=ci.PLAIN_OPS)
    want = plain.apply_argmax(prepared, x)
    assert (got == want).float().mean().item() >= 0.99
