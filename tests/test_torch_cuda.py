"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small shapes (every mode). Marked ``cuda``: they skip where
there is no GPU; run them there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py imports jax, which this file does
not need.)

Tolerance: bf16 outputs, 2e-2 of the largest reference value (the kernel
and the plain version round the same f32 sums, in another order, to 8
mantissa bits); masks may differ on margins below bf16 resolution.
"""

import pytest
import torch

from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
from segmentation_tpu_torch.nn.kernels import conv_flat as cf

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
