"""The MC-dropout kernels on the card against their plain versions
(nn/kernels/conv_flat.py): the fan-out and the moments (csrc/mc_dropout.cu),
H1's MC head (csrc/packed_conv2x2_fwd.cuh kMcHead), both duals reading a
skip batch that divides the up batch, and the whole MC forward at a small
size. Marked ``cuda``: they skip where torch sees no GPU. On the card:

    python -m pytest tests/test_torch_mc_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py imports jax, which this file does
not need.) The fan-out is exact (a kept bf16 value doubled); the head's
sums differ from the plain version's by summation order; the moments'
shifted one-pass sums by f32 rounding.
"""

import pytest
import torch

from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.models import unet_fast as tfast
from segmentation_tpu_torch.models.unet import init_params
from segmentation_tpu_torch.nn.kernels import conv_flat as cf

pytestmark = pytest.mark.cuda
SEED = 2**33 + 2**31 + 12345


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return generator(7, "cuda")


@pytest.mark.parametrize("shape", [(2, 56, 56, 512), (1, 3, 5, 8)])
def test_mc_fanout_kernel(gen, shape):
    x = torch.rand(shape, generator=gen, device="cuda").to(torch.bfloat16)
    got = cf.mc_fanout(x, seed=SEED, samples=8, rate=0.5)
    want = cf.mc_fanout_plain(x, seed=SEED, samples=8, rate=0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("o4", [128, 256])
def test_mc_head_kernel(gen, o4):
    g = gen
    n, hp, wp, c4 = 6, 19, 45, 128
    x = torch.rand((n, hp, wp, c4), generator=g, device="cuda").to(
        torch.bfloat16)
    w2 = ((torch.rand((2, 2, c4, o4), generator=g, device="cuda") - 0.5)
          * 0.2).to(torch.bfloat16)
    b4 = (torch.rand(o4, generator=g, device="cuda") - 0.5) * 0.1
    wh = ((torch.rand((o4 // 4, 2), generator=g, device="cuda") - 0.5)
          * 0.5).to(torch.bfloat16)
    bh = torch.tensor([0.1, -0.2], device="cuda")
    got = cf.packed_conv2x2_mc_head(x, w2, b4, wh, bh, seed=SEED, tiles=3,
                                    rate=0.5)
    want = cf.packed_conv2x2_mc_head_plain(x, w2, b4, wh, bh, seed=SEED,
                                           tiles=3, rate=0.5)
    torch.cuda.synchronize()
    # the same y but where the f32 sums' order flips a bf16 rounding (a
    # rare element: a ulp of y times a head weight, doubled)
    err = (got - want).abs()
    assert float((err > 1e-5).float().mean()) < 0.01
    assert float(err.max()) < 2e-3


def test_mc_moments_kernel(gen):
    p = torch.rand((16, 21, 33, 8), generator=gen, device="cuda")
    got = cf.mc_moments(p, tiles=2)
    want = cf.mc_moments_plain(p, tiles=2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=0)
    near = (want[0][..., 1] - want[0][..., 0]).abs() < 1e-6
    assert ((got[2] == want[2]) | near).all()


def test_the_duals_read_a_broadcast_skip(gen):
    """Up image i reads skip image i mod the skip's batch, in both duals."""
    g = gen
    rnd = lambda *s: (torch.rand(s, generator=g, device="cuda") - 0.5
                      ).to(torch.bfloat16)
    skip, up = rnd(2, 30, 30, 128), rnd(6, 20, 20, 128)
    w2a, w2b = rnd(2, 2, 128, 128) * 0.1, rnd(2, 2, 128, 128) * 0.1
    b4 = torch.zeros(128, device="cuda")
    for off in ((9, 9), (10, 10)):
        got = cf.packed_conv2x2_dual(skip, up, w2a, w2b, b4, offset=off)
        want = cf.packed_conv2x2_dual(skip.repeat(3, 1, 1, 1), up, w2a, w2b,
                                      b4, offset=off)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    sk, u = rnd(2, 24, 24, 128), rnd(4, 16, 16, 128)
    w = rnd(3, 3, 256, 128) * 0.1
    b = torch.zeros(128, device="cuda")
    got = cf.std_conv3x3_dual(sk, u, w[:, :, :128], w[:, :, 128:], b,
                              offset=(4, 4))
    want = cf.std_conv3x3_dual(sk.repeat(2, 1, 1, 1), u, w[:, :, :128],
                               w[:, :, 128:], b, offset=(4, 4))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_the_mc_forward_on_the_card_is_its_plain_versions(gen):
    cfg = ModelConfig(n_classes=2, input_dims=(252, 252), n_kernels=32,
                      bayesian=True)
    params = init_params(cfg, generator(9))
    x = torch.rand((2, 252, 252, 3), generator=gen, device="cuda").to(
        torch.bfloat16)
    out = []
    for ops in (cf.KERNEL_OPS, cf.PLAIN_OPS):
        model = tfast.UNetS2DInference(cfg, ops=ops)
        prepared = model.prepare(params, dtype=torch.bfloat16, device="cuda")
        out.append(model.apply_mc(prepared, x, SEED, 4))
    torch.cuda.synchronize()
    (mean, var, cmap), (w_mean, w_var, w_map) = out
    assert (mean - w_mean).abs().max() < 2e-2
    assert (var - w_var).abs().max() < 2e-2
    assert float((cmap != w_map).float().mean()) < 0.02
