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


# x's shape at H1's cases: the 512² conv2_2 site (N = 1), ragged pixel
# counts, a last tile ragged in both directions (tests/test_torch_fwd_
# tiles.py checks that it is), one output row, column or pixel, N = 3 (a
# linear pixel index would cross images), 4C = 72 (a partial 64-channel K
# block) and 4C = 8 (one K block of 8 channels and 56 zeros); each at 4O =
# 128 (ping-pong tiles) and 256 (tiles split between the consumers)
FWD = {"conv2_2": (1, 126, 126, 256),
       "ragged": (2, 13, 21, 128),
       "ragged tiles": (1, 44, 65, 128),
       "one row": (1, 2, 40, 128),
       "one column": (1, 40, 2, 256),
       "one pixel": (2, 2, 2, 128),
       "N=3": (3, 20, 45, 256),
       "4C=72": (2, 9, 13, 72),
       "4C=8": (1, 9, 13, 8)}


def _head(gen, o4):
    return (_wgt(gen, o4, 4), torch.randn((4,), generator=gen, device="cuda"))


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("mode", ["plain", "pool", "head_only", "head"])
@pytest.mark.parametrize("shape", list(FWD))
def test_packed_conv2x2_kernel(gen, shape, o4, mode):
    x = _act(gen, *FWD[shape])
    c4 = x.shape[-1]
    args = (x, _wgt(gen, 2, 2, c4, o4), _bias(gen, o4))
    kw = {"pool": mode == "pool"}
    if mode.startswith("head"):
        kw["head"] = _head(gen, o4)
        kw["head_only"] = mode == "head_only"
    _check(cf.packed_conv2x2(*args, **kw),
           cf.packed_conv2x2_plain(*args, **kw))


# H2's cases: (skip, up, 4O) shapes and crop offsets (unpacked). 4C = 256
# (C = 64): every K block is one slot, one TMA box at the slot's origin;
# 4C = 128 (C = 32) and 96 (C = 24): odd offsets gather the skip's blocks
# (two slots of different origins in one block), even ones are one box;
# (8, 8) reaches the skip's far edge in both axes where the skip is 4
# packed pixels larger than up.
DUAL = {"4C=256": ((2, 15, 17, 256), (2, 9, 11, 256), 256),
        "4C=128": ((2, 15, 17, 128), (2, 9, 11, 128), 128),
        "4C=128 4O=256": ((1, 15, 17, 128), (1, 9, 11, 128), 256),
        "4C=256 4O=128": ((1, 15, 17, 256), (1, 9, 11, 256), 128),
        "ragged tiles": ((1, 48, 69, 128), (1, 44, 65, 128), 128),
        "ragged tiles 4O=256": ((1, 48, 69, 256), (1, 44, 65, 256), 256),
        "one row": ((1, 6, 44, 128), (1, 2, 40, 128), 128),
        "one column": ((1, 44, 6, 256), (1, 40, 2, 256), 256),
        "one pixel": ((2, 6, 6, 128), (2, 2, 2, 128), 128),
        "N=3": ((3, 24, 49, 256), (3, 20, 45, 256), 256),
        "4C=96": ((2, 15, 17, 96), (2, 9, 11, 96), 128)}
OFFSETS = [(0, 0), (6, 4), (5, 7), (2, 3), (3, 0), (8, 8), (7, 7)]


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("case", list(DUAL))
def test_packed_conv2x2_dual_kernel(gen, case, offset):
    sshape, ushape, o4 = DUAL[case]
    skip, up = _act(gen, *sshape), _act(gen, *ushape)
    c4 = up.shape[-1]
    args = (skip, up, _wgt(gen, 2, 2, c4, o4), _wgt(gen, 2, 2, c4, o4),
            _bias(gen, o4))
    _check(cf.packed_conv2x2_dual(*args, offset=offset),
           cf.packed_conv2x2_dual_plain(*args, offset=offset))


@pytest.mark.parametrize("op", ["single", "dual even", "dual slot",
                                "dual gather"])
def test_packed_conv2x2_fwd_is_deterministic(gen, op):
    """Two launches on the same inputs give the same bits (no atomics)."""
    if op == "single":
        x = _act(gen, 2, 41, 57, 128)
        args = (x, _wgt(gen, 2, 2, 128, 128), _bias(gen, 128))
        kw = {"pool": True, "head": _head(gen, 128)}
        fn = cf.packed_conv2x2
    else:
        c4 = 256 if op == "dual slot" else 128
        args = (_act(gen, 2, 45, 61, c4), _act(gen, 2, 41, 57, c4),
                _wgt(gen, 2, 2, c4, 256), _wgt(gen, 2, 2, c4, 256),
                _bias(gen, 256))
        kw = {"offset": (4, 2) if op == "dual even" else (3, 5)}
        fn = cf.packed_conv2x2_dual
    first, second = _outs(fn(*args, **kw)), _outs(fn(*args, **kw))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second, strict=True))


# H3's cases, x [N, H, W] at each C: even sides, odd H and W (the VALID
# conv never reads the last row and column), a 4×4 input (one output
# pixel), ragged tiles. C = 3 (the entry), 5, and 4 with odd W: TMA cannot
# stride the space-to-depth view, the kernel gathers im2col rows (C = 5:
# two K blocks); C = 4 with even W, 16 (a partial K block: 2C = 32 of 64),
# 32 (conv2_1) and 64 (two blocks a row parity): boxed
STRIDED = {"even": (2, 22, 20), "odd H/W": (2, 23, 19), "4x4": (1, 4, 4),
           "ragged tiles": (1, 88, 130)}


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("c", [3, 4, 5, 16, 32, 64])
@pytest.mark.parametrize("shape", list(STRIDED))
def test_strided_conv4x4s2_kernel(gen, shape, c, o4):
    args = (_act(gen, *STRIDED[shape], c), _wgt(gen, 4, 4, c, o4),
            _bias(gen, o4))
    _check(cf.strided_conv4x4s2(*args), cf.strided_conv4x4s2_plain(*args))


def test_strided_conv4x4s2_gathers_a_misaligned_x(gen):
    """C = 32 off a 16-byte line: TMA cannot take x, the kernel gathers."""
    x = _misaligned(_act(gen, 2, 22, 20, 32))
    args = (x, _wgt(gen, 4, 4, 32, 256), _bias(gen, 256))
    _check(cf.strided_conv4x4s2(*args), cf.strided_conv4x4s2_plain(*args))


# H4's cases, x [N, h, w] (C channels; 4C for the scatter, whose output is
# [N, 2h, 2w]): upconv3's shape cut down, ragged tiles, one pixel, N = 3
ROWS = {"small": (2, 7, 9), "ragged tiles": (1, 43, 37),
        "one pixel": (1, 1, 1), "N=3": (3, 10, 21)}


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("c", [64, 128, 256])
@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("shape", list(ROWS))
def test_rows_matmul_kernel(gen, shape, scatter, c, o4):
    x = _act(gen, *ROWS[shape], 4 * c if scatter else c)
    args = (x, _wgt(gen, c, o4), _bias(gen, o4))
    _check(cf.rows_matmul(*args, scatter=scatter),
           cf.rows_matmul_plain(*args, scatter=scatter))


@pytest.mark.parametrize("op", ["H3 boxed", "H3 gathered", "H4 identity",
                                "H4 scatter"])
def test_strided_rows_fwd_is_deterministic(gen, op):
    """Two launches on the same inputs give the same bits (no atomics)."""
    if op.startswith("H3"):
        c = 32 if op == "H3 boxed" else 3
        args = (_act(gen, 2, 60, 71, c), _wgt(gen, 4, 4, c, 128),
                _bias(gen, 128))
        kw, fn = {}, cf.strided_conv4x4s2
    else:
        scatter = op == "H4 scatter"
        args = (_act(gen, 2, 23, 29, 256 if scatter else 128),
                _wgt(gen, 64 if scatter else 128, 256), _bias(gen, 256))
        kw, fn = {"scatter": scatter}, cf.rows_matmul
    first, second = fn(*args, **kw), fn(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _misaligned(t):
    """A contiguous copy of t that starts 2 bytes past a 16-byte line."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_wrapper_refuses_bad_operands(gen):
    x = _act(gen, 1, 5, 5, 128)
    w, b = _wgt(gen, 2, 2, 128, 128), _bias(gen, 128)
    with pytest.raises(TypeError):
        cf.packed_conv2x2(x.float(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        cf.packed_conv2x2(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="128 or 256"):
        cf.packed_conv2x2(x, _wgt(gen, 2, 2, 128, 64), _bias(gen, 64))
    with pytest.raises(ValueError, match="bad input shape"):
        cf.packed_conv2x2(_act(gen, 1, 5, 5, 12), _wgt(gen, 2, 2, 12, 128), b)
    with pytest.raises(ValueError, match="bad input shape"):
        cf.packed_conv2x2(_act(gen, 1, 1, 5, 128), w, b)
    with pytest.raises(ValueError, match="16-byte"):
        cf.packed_conv2x2(_misaligned(x), w, b)


def test_strided_rows_wrappers_refuse_bad_operands(gen):
    x, w4, b = _act(gen, 1, 10, 10, 32), _wgt(gen, 4, 4, 32, 128), \
        _bias(gen, 128)
    with pytest.raises(ValueError, match="128 or 256"):
        cf.strided_conv4x4s2(x, _wgt(gen, 4, 4, 32, 64), _bias(gen, 64))
    with pytest.raises(ValueError, match="< 4x4"):
        cf.strided_conv4x4s2(_act(gen, 1, 3, 10, 32), w4, b)
    with pytest.raises(TypeError):
        cf.strided_conv4x4s2(x.float(), w4, b)
    with pytest.raises(ValueError, match="shape"):
        cf.strided_conv4x4s2(x, _wgt(gen, 4, 4, 16, 128), b)
    with pytest.raises(ValueError, match="contiguous"):
        cf.strided_conv4x4s2(x.transpose(1, 2), w4, b)
    with pytest.raises(ValueError, match="16-byte"):
        cf.strided_conv4x4s2(x, _misaligned(w4), b)
    xr, wm = _act(gen, 1, 5, 5, 128), _wgt(gen, 128, 256)
    b2 = _bias(gen, 256)
    with pytest.raises(ValueError, match="128 or 256"):
        cf.rows_matmul(xr, _wgt(gen, 128, 64), _bias(gen, 64))
    with pytest.raises(ValueError, match="vs wm"):
        cf.rows_matmul(xr, wm, b2, scatter=True)
    with pytest.raises(ValueError, match="vs wm"):
        cf.rows_matmul(_act(gen, 1, 5, 5, 12), _wgt(gen, 12, 256), b2)
    with pytest.raises(TypeError):
        cf.rows_matmul(xr.float(), wm, b2)
    with pytest.raises(ValueError, match="contiguous"):
        cf.rows_matmul(xr.transpose(1, 2), wm, b2)
    with pytest.raises(ValueError, match="16-byte"):
        cf.rows_matmul(_misaligned(xr), wm, b2)


def test_dual_wrapper_refuses_bad_operands(gen):
    skip, up = _act(gen, 1, 9, 9, 128), _act(gen, 1, 5, 5, 128)
    w, b = _wgt(gen, 2, 2, 128, 128), _bias(gen, 128)
    with pytest.raises(ValueError, match="does not cover"):
        cf.packed_conv2x2_dual(skip, up, w, w, b, offset=(9, 0))
    with pytest.raises(ValueError, match="does not cover"):
        cf.packed_conv2x2_dual(skip, up, w, w, b, offset=(0, -1))
    with pytest.raises(ValueError, match="bad input shape"):
        cf.packed_conv2x2_dual(_act(gen, 1, 9, 9, 48), _act(gen, 1, 5, 5, 48),
                               _wgt(gen, 2, 2, 48, 128),
                               _wgt(gen, 2, 2, 48, 128), b, offset=(0, 0))
    with pytest.raises(TypeError):
        cf.packed_conv2x2_dual(skip.float(), up, w, w, b, offset=(0, 0))
    with pytest.raises(ValueError, match="contiguous"):
        cf.packed_conv2x2_dual(skip, up.transpose(1, 2), w, w, b,
                               offset=(0, 0))
    with pytest.raises(ValueError, match="16-byte"):
        cf.packed_conv2x2_dual(skip, up, w, _misaligned(w), b, offset=(0, 0))


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
    assert all(v > 0 for k, v in cf.launches.items()
               if k not in cf.TRAIN_ONLY), cf.launches
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


# H1's int8 cases, x [N, hp, wp, 4C]: the 512² conv2_2 site (N = 1), a last
# tile ragged in both directions, one output row, one column, N = 3, and
# 4C = 16 and 48 (one K block of 128 channels, the rest TMA's zeros) and 144
# (a second block of 16); each at 4O = 128 (ping-pong tiles, s8 staged for
# TMA stores) and 256 (tiles split between the consumers, register stores)
FWD8 = {"conv2_2": (1, 126, 126, 256),
        "ragged tiles": (1, 44, 65, 128),
        "one row": (1, 2, 40, 256),
        "one column": (1, 40, 2, 128),
        "N=3": (3, 20, 45, 256),
        "4C=16": (2, 9, 13, 16),
        "4C=48": (2, 9, 13, 48),
        "4C=144": (1, 12, 17, 144)}
MODES8 = ["requant", "pool", "float", "head_only", "float pool head"]


def _s8_site(gen, x, o4, mode, **kw):
    """(args, kwargs) of H1's int8 mode ``mode`` on x: s8 weights and
    their K-major copy, epilogue vectors (bf16 values of O(1) at a float
    site), the head's operands where the mode has it."""
    c4 = x.shape[-1]
    mul, add = _requant_vecs(gen, o4, 4 * c4)
    requant = mode in ("requant", "pool")
    if not requant:
        mul = mul / 20
    wq = _s8(gen, 2, 2, c4, o4)
    kw = {**kw, "pool": "pool" in mode, "requant": requant,
          "wk": ci.k_major(wq)}
    if "head" in mode:
        kw["head"] = (_wgt(gen, o4, 4),
                      torch.randn((4,), generator=gen, device="cuda"))
        kw["head_only"] = mode == "head_only"
    return (x, wq, mul, add), kw


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("mode", MODES8)
@pytest.mark.parametrize("shape", list(FWD8))
def test_packed_conv2x2_s8_kernel(gen, shape, o4, mode):
    args, kw = _s8_site(gen, _s8(gen, *FWD8[shape]), o4, mode)
    ci.reset_launches()
    _check_s8(ci.packed_conv2x2_s8(*args, **kw),
              ci.packed_conv2x2_s8_plain(*args, **kw))
    assert ci.launches["packed_conv2x2_s8_pool" if "pool" in mode
                       else "packed_conv2x2_s8"] == 1


# H2's int8 cases: (skip, up, 4O) shapes. 4C = 256 (C = 64) and 128 (C =
# 32): an odd offset gathers the skip (two or four slots of different
# origins a K block), an even one is one box; 4C = 64 (one partial K block
# a side) and 192 (a second block of 64); ragged tiles, one row, column, N
# = 3; 4O = 128 (the consumers split a tile's rows) and 256 (its columns,
# 64-row tiles)
DUAL8 = {"4C=256": ((2, 15, 17, 256), (2, 9, 11, 256), 256),
         "4C=128": ((2, 15, 17, 128), (2, 9, 11, 128), 128),
         "4C=128 4O=256": ((1, 15, 17, 128), (1, 9, 11, 128), 256),
         "4C=256 4O=128": ((1, 15, 17, 256), (1, 9, 11, 256), 128),
         "4C=64": ((2, 15, 17, 64), (2, 9, 11, 64), 256),
         "4C=192": ((1, 15, 17, 192), (1, 9, 11, 192), 128),
         "ragged tiles": ((1, 48, 69, 128), (1, 44, 65, 128), 128),
         "ragged tiles 4O=256": ((1, 48, 69, 256), (1, 44, 65, 256), 256),
         "one row": ((1, 6, 44, 128), (1, 2, 40, 128), 256),
         "one column": ((1, 44, 6, 256), (1, 40, 2, 256), 128),
         "N=3": ((3, 24, 49, 256), (3, 20, 45, 256), 256)}


def _dual8_site(gen, case, offset, inline=""):
    sshape, ushape, o4 = DUAL8[case]
    c4 = ushape[-1]
    skip = _acts8(gen, *sshape) if "a" in inline else _s8(gen, *sshape)
    up = _acts8(gen, *ushape) if "b" in inline else _s8(gen, *ushape)
    cs_a, _ = _requant_vecs(gen, o4, 8 * c4)
    cs_b, add = _requant_vecs(gen, o4, 8 * c4)
    wqa, wqb = _s8(gen, 2, 2, c4, o4), _s8(gen, 2, 2, c4, o4)
    kw = {"offset": offset, "wka": ci.k_major(wqa), "wkb": ci.k_major(wqb),
          "act_scale_a": ACT_S if "a" in inline else None,
          "act_scale_b": ACT_S if "b" in inline else None}
    return (skip, up, wqa, wqb, cs_a, cs_b, torch.ones((o4,), device="cuda"),
            add), kw


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("case", list(DUAL8))
def test_packed_conv2x2_dual_s8_kernel(gen, case, offset):
    args, kw = _dual8_site(gen, case, offset)
    ci.reset_launches()
    _check_s8(ci.packed_conv2x2_dual_s8(*args, **kw),
              ci.packed_conv2x2_dual_s8_plain(*args, **kw))
    assert ci.launches["packed_conv2x2_dual_s8"] == 1


# H3 int8's cases, x [N, H, W] (C channels): conv2_1's 512² shape (N = 1),
# N = 3, a tile ragged in both directions (odd H and W: the VALID conv never
# reads the last row and column); each at C = 16 (2C = 32: half of each
# parity's 64 box bytes are TMA's zeros), 32 (conv2_1) and 48 (a second,
# partial K block), 4O = 128 (ping-pong, TMA stores) and 256 (split tiles)
STRIDED8 = {"conv2_1": (1, 254, 254), "N=3": (3, 22, 19),
            "ragged tiles": (1, 61, 83)}


def _strided8_site(gen, shape, c, o4, inline=False):
    x = (_acts8 if inline else _s8)(gen, *STRIDED8[shape], c)
    wq4 = _s8(gen, 4, 4, c, o4)
    kw = {"wk4": ci.strided_k_major(wq4)}
    if inline:
        kw["act_scale"] = ACT_S
    return (x, wq4, *_requant_vecs(gen, o4, 16 * c)), kw


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("c", [16, 32, 48])
@pytest.mark.parametrize("shape", list(STRIDED8))
def test_strided_conv4x4s2_s8_kernel(gen, shape, c, o4):
    args, kw = _strided8_site(gen, shape, c, o4)
    ci.reset_launches()
    _check_s8(ci.strided_conv4x4s2_s8(*args, **kw),
              ci.strided_conv4x4s2_s8_plain(*args, **kw))
    assert ci.launches["strided_conv4x4s2_s8"] == 1


# H4 int8's cases, the input grid [N, H, W] (the scatter's packed one) and
# C: the 512² sites (upconv3 identity, C = 128, boxed; upconv4 scatter, C =
# 64, gathered), a small grid, a tile ragged in both directions, N = 3, C =
# 16 (one K block, the rest zeros) and 144 (a second block of 16); each at
# both 4O (ping-pong with TMA stores, and tiles split between the consumers)
ROWS8 = {"upconv3": ((1, 84, 84), 128), "upconv4": ((1, 82, 82), 64),
         "small": ((2, 7, 9), 64), "ragged tiles": ((1, 21, 37), 128),
         "N=3": ((3, 10, 13), 128), "C=16": ((2, 5, 9), 16),
         "C=144": ((1, 6, 11), 144)}


def _rows8_site(gen, case, scatter, o4, inline=False):
    (n, h, w), c = ROWS8[case]
    x = (_acts8 if inline else _s8)(gen, n, h, w, 4 * c if scatter else c)
    wqm = _s8(gen, c, o4)
    kw = {"scatter": scatter, "wkm": ci.k_major(wqm)}
    if inline:
        kw["act_scale"] = ACT_S
    return (x, wqm, *_requant_vecs(gen, o4, c)), kw


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("case", list(ROWS8))
@pytest.mark.parametrize("scatter", [False, True])
def test_rows_matmul_s8_kernel(gen, scatter, case, o4):
    args, kw = _rows8_site(gen, case, scatter, o4)
    ci.reset_launches()
    _check_exact(ci.rows_matmul_s8(*args, **kw),
                 ci.rows_matmul_s8_plain(*args, **kw))
    assert ci.launches["rows_matmul_s8"] == 1


# H5's cases, the image [N, H, W]: 512² (N = 1; 254² outputs, ragged 8 ×
# 15 tiles), 516 × 384 (which the model's fusion gate admits; tiles that
# divide neither side), N = 3 at an odd width (two-load pairs), small
# images with a few tiles and one tile
ENTRY = {"512": (1, 512, 512), "516x384": (1, 516, 384),
         "N=3 odd W": (3, 38, 71), "partial tiles": (2, 38, 70),
         "one tile": (1, 8, 14)}


def _entry_site(gen, shape):
    x = _act(gen, *ENTRY[shape], 3)
    w4 = _wgt(gen, 4, 4, 3, 128)
    mul1 = torch.full((128,), 1.0 / 0.02, device="cuda")
    add1 = _bias(gen, 128) / 0.02
    wq2 = _s8(gen, 2, 2, 128, 128)
    return (x, w4, mul1, add1, wq2, *_requant_vecs(gen, 128, 512)), {
        "wk": ci.k_major(wq2)}


@pytest.mark.parametrize("shape", list(ENTRY))
def test_entry_chain_kernel(gen, shape):
    args, kw = _entry_site(gen, shape)
    ci.reset_launches()
    _check_s8(ci.entry_chain(*args, **kw), ci.entry_chain_plain(*args, **kw))
    assert ci.launches["entry_chain"] == 1


# the inline-quantize modes: bf16 operands whose codes at ACT_S reach past
# 127 (inverse 16: ties at k + 1/2)
ACT_S = 1 / 16.0


def _acts8(gen, *shape):
    return (torch.rand(shape, generator=gen, device="cuda")
            * (150 * ACT_S)).to(torch.bfloat16)


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("mode", MODES8)
@pytest.mark.parametrize("shape", list(FWD8))
def test_packed_conv2x2_s8_inline_kernel(gen, shape, o4, mode):
    args, kw = _s8_site(gen, _acts8(gen, *FWD8[shape]), o4, mode,
                        act_scale=ACT_S)
    ci.reset_launches()
    _check_s8(ci.packed_conv2x2_s8(*args, **kw),
              ci.packed_conv2x2_s8_plain(*args, **kw))
    assert ci.launches["packed_conv2x2_s8_inline"] == 1


@pytest.mark.parametrize("inline", ["a", "b", "ab"])
@pytest.mark.parametrize("offset", [(0, 0), (6, 4), (5, 7), (2, 3)])
@pytest.mark.parametrize("case", ["4C=256", "4C=128", "4C=64",
                                  "ragged tiles 4O=256", "N=3"])
def test_packed_conv2x2_dual_s8_inline_kernel(gen, case, offset, inline):
    args, kw = _dual8_site(gen, case, offset, inline)
    ci.reset_launches()
    _check_s8(ci.packed_conv2x2_dual_s8(*args, **kw),
              ci.packed_conv2x2_dual_s8_plain(*args, **kw))
    assert ci.launches["packed_conv2x2_dual_s8_inline"] == 1


@pytest.mark.parametrize("op", ["pool 4O=128", "float head 4O=256",
                                "inline pool 4O=256", "dual odd 4O=128",
                                "dual even 4O=256", "dual inline ab"])
def test_packed_conv2x2_s8_is_deterministic(gen, op):
    """Two launches on the same inputs give the same bits (no atomics)."""
    if op.startswith("dual"):
        case = "ragged tiles 4O=256" if "4O=256" in op else "ragged tiles"
        offset = (4, 2) if "even" in op else (3, 5)
        args, kw = _dual8_site(gen, case, offset,
                               "ab" if "inline" in op else "")
        fn = ci.packed_conv2x2_dual_s8
    else:
        o4 = 256 if "4O=256" in op else 128
        x = (_acts8 if "inline" in op else _s8)(gen, 2, 41, 57, 128)
        mode = "float pool head" if "head" in op else "pool"
        extra = {"act_scale": ACT_S} if "inline" in op else {}
        args, kw = _s8_site(gen, x, o4, mode, **extra)
        fn = ci.packed_conv2x2_s8
    first, second = _outs(fn(*args, **kw)), _outs(fn(*args, **kw))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second, strict=True))


def test_s8_wrappers_refuse_bad_operands(gen):
    """No fallback: a CUDA call the kernels do not take raises."""
    args, kw = _s8_site(gen, _s8(gen, 1, 5, 5, 128), 128, "requant")
    x, wq, mul, add = args
    with pytest.raises(ValueError, match="K-major"):
        ci.packed_conv2x2_s8(*args, **{**kw, "wk": None})
    with pytest.raises(ValueError, match="shape"):
        ci.packed_conv2x2_s8(*args, **{**kw, "wk": kw["wk"][:, :256]})
    with pytest.raises(TypeError):
        ci.packed_conv2x2_s8(*args, **{**kw, "wk": kw["wk"].float()})
    with pytest.raises(ValueError, match="contiguous"):
        ci.packed_conv2x2_s8(*args, **{**kw, "wk": wq.reshape(512, 128).t()})
    with pytest.raises(ValueError, match="bad input shape"):
        xs = _s8(gen, 1, 5, 5, 24)
        ci.packed_conv2x2_s8(xs, _s8(gen, 2, 2, 24, 128), mul, add,
                             wk=_s8(gen, 128, 96))
    with pytest.raises(ValueError, match="16-byte"):
        ci.packed_conv2x2_s8(_misaligned(x), wq, mul, add, wk=kw["wk"])
    with pytest.raises(ValueError, match="float site"):
        ci.packed_conv2x2_s8(*args, wk=kw["wk"],
                             head=(_wgt(gen, 128, 4),
                                   torch.zeros((4,), device="cuda")))
    with pytest.raises(ValueError, match="128 or 256"):
        ci.packed_conv2x2_s8(x, _s8(gen, 2, 2, 128, 64), mul[:64], add[:64],
                             wk=_s8(gen, 64, 512))
    with pytest.raises(TypeError, match="act_scale"):
        ci.packed_conv2x2_s8(_acts8(gen, 1, 5, 5, 128), wq, mul, add,
                             wk=kw["wk"])
    dargs, dkw = _dual8_site(gen, "4C=128", (3, 5))
    with pytest.raises(ValueError, match="K-major"):
        ci.packed_conv2x2_dual_s8(*dargs, **{**dkw, "wkb": None})
    with pytest.raises(ValueError, match="does not cover"):
        ci.packed_conv2x2_dual_s8(*dargs, **{**dkw, "offset": (13, 0)})
    with pytest.raises(ValueError, match="bad input shape"):
        skip, up = _s8(gen, 1, 9, 9, 96), _s8(gen, 1, 5, 5, 96)
        w = _s8(gen, 2, 2, 96, 128)
        ci.packed_conv2x2_dual_s8(skip, up, w, w, *dargs[4:], offset=(0, 0),
                                  wka=ci.k_major(w), wkb=ci.k_major(w))
    with pytest.raises(ValueError, match="16-byte"):
        ci.packed_conv2x2_dual_s8(_misaligned(dargs[0]), *dargs[1:], **dkw)


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("c", [16, 32, 48])
@pytest.mark.parametrize("shape", list(STRIDED8))
def test_strided_conv4x4s2_s8_inline_kernel(gen, shape, c, o4):
    args, kw = _strided8_site(gen, shape, c, o4, inline=True)
    ci.reset_launches()
    _check_s8(ci.strided_conv4x4s2_s8(*args, **kw),
              ci.strided_conv4x4s2_s8_plain(*args, **kw))
    assert ci.launches["strided_conv4x4s2_s8_inline"] == 1


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("case", list(ROWS8))
@pytest.mark.parametrize("scatter", [False, True])
def test_rows_matmul_s8_inline_kernel(gen, scatter, case, o4):
    args, kw = _rows8_site(gen, case, scatter, o4, inline=True)
    ci.reset_launches()
    _check_exact(ci.rows_matmul_s8(*args, **kw),
                 ci.rows_matmul_s8_plain(*args, **kw))
    assert ci.launches["rows_matmul_s8_inline"] == 1


def test_rows_matmul_s8_refuses_bad_operands(gen):
    """No fallback: H4 int8 without its K-major copy, with a bad one or a
    misaligned x raises."""
    args, kw = _rows8_site(gen, "small", False, 128)
    with pytest.raises(ValueError, match="K-major"):
        ci.rows_matmul_s8(*args, **{**kw, "wkm": None})
    with pytest.raises(ValueError, match="shape"):
        ci.rows_matmul_s8(*args, **{**kw, "wkm": kw["wkm"][:, :32]})
    with pytest.raises(ValueError, match="16-byte"):
        ci.rows_matmul_s8(_misaligned(args[0]), *args[1:], **kw)


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("shape", [(2, 38, 71), (1, 38, 70), (3, 21, 40),
                                   (1, 512, 512)])
def test_conv3entry_kernels(gen, shape, o4):
    """The image entry's requant-only mode (bf16) and s8-input mode (the
    3-byte pixels gathered): odd widths (pairs in two loads) and even,
    ragged tiles, N = 3, the 512² image."""
    mul = torch.full((o4,), 100.0, device="cuda")
    add = _bias(gen, o4) * 100
    x = _act(gen, *shape, 3)
    args = (x, _wgt(gen, 4, 4, 3, o4), mul, add)
    ci.reset_launches()
    _check_s8(ci.conv3entry_requant(*args),
              ci.conv3entry_requant_plain(*args))
    wq4 = _s8(gen, 4, 4, 3, o4)
    args8 = (_s8(gen, *shape, 3), wq4, *_requant_vecs(gen, o4, 27))
    kw8 = {"wk4": ci.strided_k_major(wq4)}
    _check_s8(ci.conv3entry_s8(*args8, **kw8),
              ci.conv3entry_s8_plain(*args8, **kw8))
    assert ci.launches["conv3entry_requant"] == 1
    assert ci.launches["conv3entry_s8"] == 1


@pytest.mark.parametrize("shape", list(ENTRY))
def test_entry_chain_is_requant_entry_plus_pool(gen, shape):
    """H5 against its two-kernel form on the card: the same im2col rows,
    wgmma steps and requant point for conv1_1, so the same codes, bit for
    bit."""
    (x, w4, mul1, add1, wq2, mul2, add2), kw = _entry_site(gen, shape)
    codes = ci.conv3entry_requant(x, w4, mul1, add1)
    two = ci.packed_conv2x2_s8(codes, wq2, mul2, add2, pool=True, **kw)
    one = ci.entry_chain(x, w4, mul1, add1, wq2, mul2, add2, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(two, one, strict=True))


@pytest.mark.parametrize("op", ["entry_chain 512", "s8 C=32 4O=256",
                                "s8 C=48 4O=128", "inline C=32 4O=256",
                                "conv3entry_s8", "conv3entry_requant"])
def test_strided_entry_s8_is_deterministic(gen, op):
    """Two launches on the same inputs give the same bits."""
    if op.startswith("entry_chain"):
        args, kw = _entry_site(gen, "512")
        fn = ci.entry_chain
    elif op.startswith("conv3entry"):
        fn = getattr(ci, op)
        x = (_s8 if op.endswith("s8") else _act)(gen, 2, 38, 71, 3)
        w = (_s8 if op.endswith("s8") else _wgt)(gen, 4, 4, 3, 128)
        args = (x, w, *_requant_vecs(gen, 128, 27))
        kw = {"wk4": ci.strided_k_major(w)} if op.endswith("s8") else {}
    else:
        c, o4 = (32, 256) if "C=32" in op else (48, 128)
        args, kw = _strided8_site(gen, "ragged tiles", c, o4,
                                  inline=op.startswith("inline"))
        fn = ci.strided_conv4x4s2_s8
    first, second = _outs(fn(*args, **kw)), _outs(fn(*args, **kw))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second, strict=True))


def test_strided_entry_s8_wrappers_refuse_bad_operands(gen):
    """No fallback: H3's int8 modes and H5 raise on a CUDA call their
    kernels do not take, the K-major copy missing included."""
    args, kw = _strided8_site(gen, "N=3", 32, 256)
    x, wq4, mul, add = args
    with pytest.raises(ValueError, match="K-major"):
        ci.strided_conv4x4s2_s8(*args)
    with pytest.raises(ValueError, match="shape"):
        ci.strided_conv4x4s2_s8(*args, wk4=kw["wk4"][:, :256])
    with pytest.raises(ValueError, match="shape"):  # bf16 H3's layout
        ci.strided_conv4x4s2_s8(*args, wk4=wq4.reshape(512, 256))
    with pytest.raises(ValueError, match="multiple of 16"):
        ci.strided_conv4x4s2_s8(_s8(gen, 1, 22, 19, 24),
                                _s8(gen, 4, 4, 24, 256), mul, add,
                                wk4=_s8(gen, 256, 384))
    with pytest.raises(ValueError, match="16-byte"):
        ci.strided_conv4x4s2_s8(_misaligned(x), *args[1:], **kw)
    with pytest.raises(TypeError, match="act_scale"):
        ci.strided_conv4x4s2_s8(_acts8(gen, 3, 22, 19, 32), *args[1:], **kw)
    with pytest.raises(ValueError, match="128 or 256"):
        ci.strided_conv4x4s2_s8(x, _s8(gen, 4, 4, 32, 64), mul[:64],
                                add[:64], wk4=_s8(gen, 64, 512))
    xe, we = _s8(gen, 1, 20, 20, 3), _s8(gen, 4, 4, 3, 128)
    ve = _requant_vecs(gen, 128, 27)
    with pytest.raises(ValueError, match="K-major"):
        ci.conv3entry_s8(xe, we, *ve)
    with pytest.raises(ValueError, match="not 3"):
        ci.conv3entry_s8(_s8(gen, 1, 20, 20, 4), _s8(gen, 4, 4, 4, 128), *ve,
                         wk4=_s8(gen, 128, 64))
    with pytest.raises(ValueError, match="bad input shape"):
        ci.conv3entry_requant(_act(gen, 1, 20, 20, 4),
                              _wgt(gen, 4, 4, 4, 128), *ve)
    eargs, ekw = _entry_site(gen, "one tile")
    with pytest.raises(ValueError, match="K-major"):
        ci.entry_chain(*eargs)
    with pytest.raises(ValueError, match="shape"):
        ci.entry_chain(*eargs, wk=eargs[4].reshape(512, 128))
    with pytest.raises(ValueError, match="bad input shape"):
        ci.entry_chain(_act(gen, 1, 5, 14, 3), *eargs[1:], **ekw)
    with pytest.raises(ValueError, match="bad input shape"):
        ci.entry_chain(_act(gen, 1, 8, 14, 4), *eargs[1:], **ekw)


def _check_exact(got, want):
    """Kernel and plain version equal bit for bit (s8 codes, bf16 values)."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


def test_quant_act_divides_on_the_card(gen):
    """The std levels' quantize (models/unet_int8.py quant_act, H8's plain
    versions) is JAX's division round(f32(x) / f32(s)) on the card as on
    the CPU, at f32 values within 4 ulps of every half-integer quotient
    under 50 scales. ATen's CUDA x / <Python float> multiplies by the
    reciprocal instead; how many codes that changes is printed."""
    import numpy as np

    from segmentation_tpu_torch.nn.kernels.conv_int8 import quant_act

    rng = np.random.default_rng(0)
    scales = (rng.uniform(1.0, 2.0, 50)
              * 2.0 ** rng.integers(-12, -2, 50)).astype(np.float32)
    ties = np.arange(-130, 130, dtype=np.float32) + np.float32(0.5)
    differ = total = 0
    for s in scales:
        bits = ((ties * s).astype(np.float32).view(np.int32)[:, None]
                + np.arange(-4, 5, dtype=np.int32))
        x = bits.reshape(-1).view(np.float32)
        want = torch.from_numpy(
            np.clip(np.rint(x / s), -127, 127).astype(np.int8))
        xt = torch.from_numpy(x)
        assert torch.equal(quant_act(xt, float(s)), want)
        assert torch.equal(quant_act(xt.cuda(), float(s)).cpu(), want)
        by_tensor = xt.cuda() / torch.full_like(xt.cuda(), float(s))
        assert torch.equal(
            torch.clamp(torch.round(by_tensor), -127, 127).to(torch.int8)
            .cpu(), want)
        by_float = torch.clamp(torch.round(xt.cuda() / float(s)), -127, 127)
        differ += int((by_float.to(torch.int8).cpu() != want).sum())
        total += x.size
    print(f"[repair] x / <Python float> on the card: {differ} of {total} "
          f"codes differ from the division")


# H8's single cases: x [N, H, W, C] and O. The int8 request's sites (N =
# 1; conv3_1 C = 64, half a K block; O = 512 two column tiles), ragged
# tiles at both column tiles, one output row, column or pixel, N = 3, C =
# 16 and 48 (one K block, the rest TMA's zeros; two k-steps), 192 (a second
# block of 64), and a row wider than the widest tile row
STD8 = {"conv3_1": ((1, 125, 125, 64), 128),
        "conv3_2": ((1, 123, 123, 128), 128),
        "conv4_1": ((1, 60, 60, 128), 256),
        "conv4_2": ((1, 58, 58, 256), 256),
        "conv5_1": ((1, 28, 28, 256), 512),
        "conv5_2": ((1, 26, 26, 512), 512),
        "conv6_2": ((1, 46, 46, 256), 256),
        "conv7_2": ((1, 86, 86, 128), 128),
        "ragged": ((2, 13, 21, 128), 128),
        "ragged O=256": ((2, 13, 21, 128), 256),
        "one row": ((1, 3, 40, 128), 128),
        "one column": ((1, 40, 3, 256), 256),
        "one pixel": ((2, 3, 3, 128), 512),
        "N=3": ((3, 20, 45, 256), 128),
        "C=16": ((2, 9, 13, 16), 128),
        "C=48": ((1, 9, 13, 48), 256),
        "C=192": ((1, 12, 17, 192), 128),
        "wide": ((1, 8, 300, 128), 128)}


def _std8_site(gen, case, requant):
    shape, o = STD8[case]
    c = shape[-1]
    wq = _s8(gen, 3, 3, c, o)
    mul, add = _requant_vecs(gen, o, 9 * c)
    if not requant:
        mul = mul / 20
    return (_s8(gen, *shape), wq, mul, add), {"requant": requant,
                                              "wk": ci.k_major(wq)}


@pytest.mark.parametrize("requant", [True, False], ids=["s8", "bf16"])
@pytest.mark.parametrize("case", list(STD8))
def test_std_conv3x3_s8_kernel(gen, case, requant):
    args, kw = _std8_site(gen, case, requant)
    ci.reset_launches()
    _check_exact(ci.std_conv3x3_s8(*args, **kw),
                 ci.std_conv3x3_s8_plain(*args, **kw))
    assert ci.launches["std_conv3x3_s8"] == 1


# H8's dual cases: skip [N, Hs, Ws, C], up [N, H, W, C], O, the crop
# origin. The request's two sites, ragged tiles, one row, N = 3, C = 64,
# O = 512 (two column tiles of 64-row tiles)
STD8_DUAL = {"conv6_1": ((1, 56, 56, 256), (1, 48, 48, 256), 256, (4, 4)),
             "conv7_1": ((1, 121, 121, 128), (1, 88, 88, 128), 128,
                         (16, 16)),
             "ragged": ((2, 20, 25, 128), (2, 13, 21, 128), 256, (3, 2)),
             "one row": ((1, 6, 44, 128), (1, 3, 40, 128), 128, (1, 2)),
             "N=3": ((3, 24, 49, 256), (3, 20, 45, 256), 128, (2, 4)),
             "C=64": ((1, 15, 17, 64), (1, 9, 11, 64), 128, (3, 3)),
             "O=512": ((1, 14, 14, 128), (1, 10, 10, 128), 512, (2, 2))}


def _masked_acts8(gen, *shape):
    """bf16 sides as a deconv's ReLU leaves them, and beyond: about half
    exact zeros (a division's slow path), the rest codes -75..150 at
    ACT_S."""
    x = (torch.rand(shape, generator=gen, device="cuda") * 225 - 75) * ACT_S
    keep = torch.rand(shape, generator=gen, device="cuda") > 0.5
    return (x * keep).to(torch.bfloat16)


def _std8_dual_site(gen, case, sides, out):
    sshape, ushape, o, offset = STD8_DUAL[case]
    c = ushape[-1]
    sk = (_masked_acts8(gen, *sshape) if sides[0] == "bf16"
          else _s8(gen, *sshape))
    up = (_masked_acts8(gen, *ushape) if sides[1] == "bf16"
          else _s8(gen, *ushape))
    wqa, wqb = _s8(gen, 3, 3, c, o), _s8(gen, 3, 3, c, o)
    cs_a, _ = _requant_vecs(gen, o, 18 * c)
    cs_b, b = _requant_vecs(gen, o, 18 * c)
    kw = {"offset": offset, "wka": ci.k_major(wqa), "wkb": ci.k_major(wqb),
          "out_scale": 1.0 if out == "s8" else None,
          "act_scale_a": ACT_S if sides[0] == "bf16" else None,
          "act_scale_b": ACT_S if sides[1] == "bf16" else None}
    return (sk, up, wqa, wqb, cs_a, cs_b, b), kw


@pytest.mark.parametrize("out", ["s8", "bf16"])
@pytest.mark.parametrize("sides", [("s8", "bf16"), ("s8", "s8"),
                                   ("bf16", "s8"), ("bf16", "bf16")],
                         ids=["skip s8 up bf16", "s8 s8", "skip bf16 up s8",
                              "bf16 bf16"])
@pytest.mark.parametrize("case", list(STD8_DUAL))
def test_std_conv3x3_dual_s8_kernel(gen, case, sides, out):
    args, kw = _std8_dual_site(gen, case, sides, out)
    ci.reset_launches()
    _check_exact(ci.std_conv3x3_dual_s8(*args, **kw),
                 ci.std_conv3x3_dual_s8_plain(*args, **kw))
    mode = "std_conv3x3_dual_s8" + ("_inline" if "bf16" in sides else "")
    assert ci.launches[mode] == 1


@pytest.mark.parametrize("op", ["single conv3_1", "single conv5_1 bf16",
                                "dual conv7_1"])
def test_std_conv3x3_s8_is_deterministic(gen, op):
    if op.startswith("single"):
        args, kw = _std8_site(gen, op.split()[1], "bf16" not in op)
        fn = ci.std_conv3x3_s8
    else:
        args, kw = _std8_dual_site(gen, "conv7_1", ("s8", "bf16"), "s8")
        fn = ci.std_conv3x3_dual_s8
    first, second = fn(*args, **kw), fn(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_std_conv3x3_s8_refuses_bad_operands(gen):
    """No fallback: an H8 call the kernel does not take raises."""
    args, kw = _std8_site(gen, "ragged", True)
    x, wq, mul, add = args
    with pytest.raises(ValueError, match="K-major"):
        ci.std_conv3x3_s8(*args, **{**kw, "wk": None})
    with pytest.raises(ValueError, match="shape"):
        ci.std_conv3x3_s8(*args, **{**kw, "wk": kw["wk"][:, :128]})
    with pytest.raises(TypeError):
        ci.std_conv3x3_s8(x.to(torch.bfloat16), wq, mul, add, **kw)
    with pytest.raises(ValueError, match="bad input shape"):
        w24 = _s8(gen, 3, 3, 24, 128)
        ci.std_conv3x3_s8(_s8(gen, 1, 5, 5, 24), w24, mul, add,
                          wk=ci.k_major(w24))
    with pytest.raises(ValueError, match="bad input shape"):
        w64 = _s8(gen, 3, 3, 128, 64)
        ci.std_conv3x3_s8(x, w64, mul[:64], add[:64], wk=ci.k_major(w64))
    with pytest.raises(ValueError, match="16-byte"):
        ci.std_conv3x3_s8(_misaligned(x), wq, mul, add, **kw)
    dargs, dkw = _std8_dual_site(gen, "ragged", ("s8", "bf16"), "s8")
    with pytest.raises(ValueError, match="K-major"):
        ci.std_conv3x3_dual_s8(*dargs, **{**dkw, "wka": None})
    with pytest.raises(ValueError, match="does not cover"):
        ci.std_conv3x3_dual_s8(*dargs, **{**dkw, "offset": (8, 0)})
    with pytest.raises(TypeError, match="act_scale"):
        ci.std_conv3x3_dual_s8(*dargs, **{**dkw, "act_scale_b": None})
    with pytest.raises(ValueError, match="16-byte"):
        ci.std_conv3x3_dual_s8(_misaligned(dargs[0]), *dargs[1:], **dkw)


# each int8 configuration's kernel modes (chip_smoke.py ROUTE_LAUNCHES):
# at 256², where the JAX route fuses level 1
_STD8 = {"std_conv3x3_s8", "std_conv3x3_dual_s8_inline"}
_ROUTE_MODES = {
    (): {"entry_chain", "strided_conv4x4s2_s8", "packed_conv2x2_s8_pool",
         "rows_matmul_s8", "packed_conv2x2_dual_s8",
         "packed_conv2x2_s8"} | _STD8,
    (("padflat", False),): {
        "strided_conv4x4s2", "rows_matmul", "packed_conv2x2_s8_pool",
        "strided_conv4x4s2_s8", "packed_conv2x2_dual_s8_inline",
        "packed_conv2x2_s8"} | _STD8,
    (("quant_deconvs", False),): {
        "entry_chain", "rows_matmul", "packed_conv2x2_s8_pool",
        "strided_conv4x4s2_s8", "packed_conv2x2_dual_s8_inline",
        "packed_conv2x2_s8"} | _STD8,
}


def _int8_forward_kernels_vs_plain(gen, **kw):
    """The calibrated int8 forward of one configuration on the kernels
    against the same forward on the plain versions (same prepared weights
    and scales); exactly the configuration's kernel modes launch."""
    from segmentation_tpu_torch.core.config import ModelConfig
    from segmentation_tpu_torch.models.unet import init_params
    from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8

    cfg = ModelConfig(n_classes=2, input_dims=(256, 256), n_kernels=32)
    params = {k: v.cuda() for k, v in init_params(cfg, generator(1)).items()}
    x = torch.rand((2, 256, 256, 3), generator=gen,
                   device="cuda").to(torch.bfloat16)
    fast = UNetS2DInt8(cfg, **kw)
    prepared = fast.prepare(params, calib_batches=[x], device="cuda")
    cf.reset_launches()
    ci.reset_launches()
    got = fast.apply_argmax(prepared, x)
    launched = {k for k, v in {**cf.launches, **ci.launches}.items() if v}
    assert launched == _ROUTE_MODES[tuple(kw.items())], launched
    plain = UNetS2DInt8(cfg, ops=cf.PLAIN_OPS, ops8=ci.PLAIN_OPS, **kw)
    want = plain.apply_argmax(prepared, x)
    assert (got == want).float().mean().item() >= 0.99


def test_int8_forward_kernels_vs_plain(gen):
    _int8_forward_kernels_vs_plain(gen)


@pytest.mark.parametrize("kw", [{"padflat": False},
                                {"quant_deconvs": False}],
                         ids=["padflat_false", "quant_deconvs_false"])
def test_int8_configurations_kernels_vs_plain(gen, kw):
    _int8_forward_kernels_vs_plain(gen, **kw)


# ------------------------------------------------------------- training
def _cot(gen, *shape):
    """A ReLU-masked cotangent: normal, zero on about half the elements."""
    g = torch.randn(shape, generator=gen, device="cuda")
    keep = torch.rand(shape, generator=gen, device="cuda") > 0.5
    return (g * keep).to(torch.bfloat16)


# g's shape and 4C at the 512² sites (N = 1), ragged pixel counts, and the
# edges of the kernel's tile plan (tiles.tile_plan): a last tile ragged
# in both directions for each tile size the plan can take (rows 256, 128,
# dual 128 and dual 64; tests/test_torch_dgrad_tiles.py checks that they
# are ragged), g of one row, one column or one pixel, N = 3 (a linear pixel
# index would cross images) and 4O = 72 (a partial 64-channel K block)
DGRAD = {"conv1_2": ((1, 254, 254, 128), 128),
         "conv2_2": ((1, 125, 125, 256), 256),
         "conv8_2": ((1, 82, 82, 256), 256),
         "conv9_2": ((1, 162, 162, 128), 128),
         "ragged 4C=128": ((2, 6, 10, 128), 128),
         "ragged 4C=256": ((1, 4, 6, 256), 256),
         "ragged tiles 4C=128": ((1, 50, 70, 128), 128),
         "ragged tiles 4C=256": ((1, 50, 70, 256), 256),
         "hg=wg=1": ((2, 1, 1, 128), 256),
         "hg=1": ((1, 1, 9, 256), 128),
         "wg=1": ((1, 7, 1, 128), 256),
         "N=3": ((3, 20, 45, 256), 128),
         "4O=72 4C=128": ((2, 9, 13, 72), 128),
         "4O=72 4C=256": ((1, 9, 13, 72), 256)}
DGRAD_DUAL = {"conv8_1": ((1, 83, 83, 256), 256),
              "conv9_1": ((1, 163, 163, 128), 128),
              "ragged 4C=128": ((2, 5, 9, 256), 128),
              "ragged 4C=256": ((1, 3, 4, 128), 256),
              "ragged tiles 8C=256": ((1, 50, 70, 128), 128),
              "ragged tiles 8C=512": ((1, 50, 70, 256), 256),
              "hg=wg=1": ((1, 1, 1, 256), 256),
              "N=3 8C=256": ((3, 9, 13, 128), 128),
              "N=3 8C=512": ((3, 20, 45, 256), 256),
              "4O=72 8C=256": ((1, 9, 13, 72), 128),
              "4O=72 8C=512": ((2, 9, 13, 72), 256)}


@pytest.mark.parametrize("site", list(DGRAD))
def test_packed_conv2x2_dgrad_kernel(gen, site):
    from segmentation_tpu_torch.nn.kernels import conv_bwd as cb

    shape, c4 = DGRAD[site]
    g, w = _cot(gen, *shape), _wgt(gen, 2, 2, c4, shape[-1])
    _check(cb.packed_conv2x2_dgrad(g, w), cb.packed_conv2x2_dgrad_plain(g, w))


@pytest.mark.parametrize("site", list(DGRAD_DUAL))
def test_packed_conv2x2_dgrad_dual_kernel(gen, site):
    from segmentation_tpu_torch.nn.kernels import conv_bwd as cb

    shape, c4 = DGRAD_DUAL[site]
    g = _cot(gen, *shape)
    wa, wb = (_wgt(gen, 2, 2, c4, shape[-1]) for _ in range(2))
    _check(cb.packed_conv2x2_dgrad_dual(g, wa, wb),
           cb.packed_conv2x2_dgrad_dual_plain(g, wa, wb))


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("c4", [128, 256])
def test_packed_conv2x2_dgrad_is_deterministic(gen, c4, dual):
    """Two launches on the same inputs give the same bits (no atomics)."""
    from segmentation_tpu_torch.nn.kernels import conv_bwd as cb

    g = _cot(gen, 2, 41, 57, 256)
    ws = [_wgt(gen, 2, 2, c4, 256) for _ in range(1 + dual)]
    fn = cb.packed_conv2x2_dgrad_dual if dual else cb.packed_conv2x2_dgrad
    first, second = _outs(fn(g, *ws)), _outs(fn(g, *ws))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second, strict=True))


def test_packed_conv2x2_dgrad_refuses_bad_operands(gen):
    from segmentation_tpu_torch.nn.kernels import conv_bwd as cb

    g, w = _cot(gen, 1, 6, 7, 128), _wgt(gen, 2, 2, 128, 128)
    with pytest.raises(ValueError, match="128 or 256"):
        cb.packed_conv2x2_dgrad(g, _wgt(gen, 2, 2, 64, 128))
    with pytest.raises(ValueError, match="contiguous"):
        cb.packed_conv2x2_dgrad(g.transpose(1, 2), w)
    with pytest.raises(TypeError):
        cb.packed_conv2x2_dgrad(g.float(), w)
    with pytest.raises(TypeError):
        cb.packed_conv2x2_dgrad_dual(g.float(), w, w)


def _outs(v):
    return v if isinstance(v, tuple) else (v,)


def _fn_operands(gen, site):
    def act(*s):
        return _act(gen, *s).requires_grad_()

    def wgt(*s):
        return _wgt(gen, *s).float().requires_grad_()

    # biases of ±4 keep every pre-activation far from 0, so that bf16
    # rounding in either forward flips no ReLU mask; half the outputs are 0
    o4 = 256 if site != "deconv_packed_t" else 128
    b = 4.0 - 8.0 * (torch.arange(o4, device="cuda") % 2).float()
    return {
        "conv2x2_t": (act(2, 13, 21, 128), wgt(2, 2, 128, 256)),
        "conv2x2_dual_t": (act(2, 9, 11, 256), act(2, 9, 11, 256),
                           wgt(2, 2, 256, 256), wgt(2, 2, 256, 256)),
        "conv4x4s2_t": (act(2, 22, 20, 32), wgt(4, 4, 32, 256)),
        "matmul_rows_t": (act(2, 7, 9, 128), wgt(128, 256)),
        "deconv_packed_t": (act(2, 7, 9, 256), wgt(64, 128)),
    }[site] + (b.requires_grad_(),)


@pytest.mark.parametrize("site", ["conv2x2_t", "conv2x2_dual_t",
                                  "conv4x4s2_t", "matmul_rows_t",
                                  "deconv_packed_t"])
def test_train_function_kernels_vs_plain(gen, site):
    """Value and the grads to every operand, on the kernels (H1–H4
    forward, H6 dgrad) against the same Function on the plain versions."""
    from segmentation_tpu_torch.nn.kernels import train as kt

    fn = getattr(kt, site)
    args = _fn_operands(gen, site)
    outs, grads = [], []
    for kw in ({}, {"ops": cf.PLAIN_OPS}):
        for a in args:
            a.grad = None
        y = fn(*args, **kw)
        cot = torch.randn(y.shape, generator=generator(1, "cuda"),
                          device="cuda")
        (y.float() * cot).sum().backward()
        outs.append(y.detach())
        grads.append([a.grad.clone() for a in args])
    _check(outs[0], outs[1])
    for g, w in zip(*grads):
        _check(g, w)


def _step_grads(hw, save_dir):
    """One bf16 train step's loss and param grads (the flagship, n_kernels
    = 32 and 4 levels, at hw², B = 2, the xentropy objective on a
    synthetic batch) on the kernels and on the plain versions, from the
    same params; and the f32 plain U-Net's grads under autograd. Every
    kernel must launch in the kernel path's step."""
    from segmentation_tpu_torch.core.config import ModelConfig, TrainConfig
    from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation
    from segmentation_tpu_torch.models.unet import UNet
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.nn.kernels import conv_bwd as cb
    from segmentation_tpu_torch.nn.shapes import center_crop_or_pad
    from segmentation_tpu_torch.training.losses import segmentation_xentropy
    from segmentation_tpu_torch.training.trainer import SegmentationTrainer

    cfg = ModelConfig(n_classes=2, input_dims=(hw, hw), n_kernels=32)
    batch = SyntheticSegmentation(2, (hw, hw), seed=3).get_batch()
    out = []
    for ops in (cf.KERNEL_OPS, cf.PLAIN_OPS):
        trainer = SegmentationTrainer(
            UNetS2D(cfg, seed=1, ops=ops), device="cuda",
            train_cfg=TrainConfig(save_dir=str(save_dir)))
        cf.reset_launches()
        cb.reset_launches()
        loss, grads = trainer.loss_and_grads(batch)
        if ops is cf.KERNEL_OPS:
            assert all(v > 0 for v in cf.launches.values()), cf.launches
            assert all(v > 0 for v in cb.launches.values()), cb.launches
        out.append((loss.item(), grads))
    ref = UNet(cfg, params=trainer.model.param_dict()).cuda()
    for p in ref.params.values():
        p.requires_grad_(True)
    logits = ref(torch.as_tensor(batch["image"], device="cuda"))
    mask = center_crop_or_pad(torch.as_tensor(batch["mask"], device="cuda"),
                              logits.shape[1], logits.shape[2])
    segmentation_xentropy(logits, mask, 2).backward()
    return out, {n: p.grad for n, p in ref.params.items()}


def _agree(got, want):
    """(cosine, relative L2 error) of got against want."""
    g, w = got.double().flatten(), want.double().flatten()
    cos = torch.nn.functional.cosine_similarity(g, w, dim=0).item()
    return cos, ((g - w).norm() / w.norm()).item()


def test_unet_s2d_step_kernels_vs_plain(gen, tmp_path):
    """The 512² step on the kernels against the same trainer on the plain
    versions, at chip_smoke.py's bars: the loss agrees to 1e-2 relative,
    each param's grad has cosine >= 0.999 and relative L2 error <= 5e-2."""
    ((loss_k, g_k), (loss_p, g_p)), _ = _step_grads(512, tmp_path)
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    for n, g in g_k.items():
        cos, rel = _agree(g, g_p[n])
        assert cos >= 0.999 and rel <= 5e-2, (n, cos, rel)


def test_unet_s2d_step_208_no_further_from_f32_than_plain(gen, tmp_path):
    """At 208² (the output is 20², and on either path the bf16 grads of the
    worst params lie 13–28 % in relative L2 from the f32 U-Net's) the 512² bar
    fails even between two plain-version runs that differ only in the
    batch split. So each param's grad is held against the f32 plain U-Net:
    the kernel path's relative L2 error may be at most 1.5x the plain
    path's, plus 2e-3 (six seeds on the card gave at most 1.29x), and the
    median over the params of its error against the plain path at most
    5e-2 (at most 2.7e-2 seen)."""
    ((loss_k, g_k), (loss_p, g_p)), g_f32 = _step_grads(208, tmp_path)
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    vs_plain = []
    for n, g in g_k.items():
        rel_k, rel_p = _agree(g, g_f32[n])[1], _agree(g_p[n], g_f32[n])[1]
        assert rel_k <= 1.5 * rel_p + 2e-3, (n, rel_k, rel_p)
        vs_plain.append(_agree(g, g_p[n])[1])
    vs_plain.sort()
    assert vs_plain[len(vs_plain) // 2] <= 5e-2, vs_plain


def test_unet_s2d_shape_outside_kernels_raises(gen):
    """On the card the train hooks have no shape gate and no plain branch
    but the C = 3 entry: n_kernels = 16 gives 4O = 64 at conv1_2, which H1
    does not take, so the step raises instead of training on cuDNN."""
    from segmentation_tpu_torch.core.config import ModelConfig
    from segmentation_tpu_torch.models.unet_fast import UNetS2D

    cfg = ModelConfig(n_classes=2, input_dims=(92, 92), n_kernels=16)
    model = UNetS2D(cfg, levels=2).cuda()
    x = _act(gen, 1, 92, 92, 3)
    cf.reset_launches()
    with pytest.raises(ValueError, match="4O = 64"):
        model(x)
    assert not any(cf.launches.values()), cf.launches


# ---------------------------------------------------------------- H7 and data
@pytest.mark.parametrize("n,h,w,c,crop", [
    (3, 37, 45, 3, 29),    # crop·C = 87, not a multiple of the block
    (4, 300, 301, 3, 257),  # a row of 771 bytes: four block strides
    (2, 20, 20, 1, 20),    # the whole image
    (5, 64, 70, 1, 33),
])
@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32,
                                       torch.bfloat16])
def test_crop_normalize_kernel(gen, n, h, w, c, crop, out_dtype):
    """H7 against its plain version, exactly: odd x offsets, every flip,
    and offsets beyond the image (clamped on both sides)."""
    from segmentation_tpu_torch.nn.kernels import augment as aug

    x = torch.randint(0, 256, (n, h, w, c), generator=gen, device="cuda",
                      dtype=torch.uint8)
    ys = torch.randint(0, h - crop + 1, (n,), generator=gen, device="cuda")
    xs = torch.randint(0, w - crop + 1, (n,), generator=gen, device="cuda")
    xs[0] = w  # clamped to w - crop
    if w > crop:  # the largest odd offset that fits
        xs[-1] = (w - crop) - (1 - (w - crop) % 2)
    flips = torch.arange(n, device="cuda") % 2
    aug.reset_launches()
    got = aug.crop_normalize(x, ys, xs, flips, crop, out_dtype)
    want = aug.crop_normalize_plain(x, ys, xs, flips, crop, out_dtype)
    torch.cuda.synchronize()
    assert aug.launches["crop_normalize"] == 1
    assert got.dtype == out_dtype and torch.equal(got, want)


def test_fused_augment_on_the_card(gen):
    from segmentation_tpu_torch.nn.kernels import augment as aug

    imgs = torch.randint(0, 256, (6, 40, 47, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    masks = imgs[..., :1].clone()
    aug.reset_launches()
    out_i, out_m = aug.fused_augment(gen, imgs, masks, 24,
                                     out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert aug.launches["crop_normalize"] == 1  # image and mask together
    table = torch.from_numpy(aug.byte_table()).cuda()
    assert torch.equal(out_i[..., 0], table[out_m[..., 0].long()])


def test_prefetcher_on_the_card_delivers_the_source_bytes(gen):
    import numpy as np

    from segmentation_tpu_torch.data.pipeline import DevicePrefetcher

    rng = np.random.default_rng(0)
    src = [{"image": rng.integers(0, 256, (4, 33, 35, 3), dtype=np.uint8),
            "mask": rng.integers(0, 2, (4, 33, 35, 1), dtype=np.uint8),
            "weight": rng.random((4,), dtype=np.float32)}
           for _ in range(7)]
    pf = DevicePrefetcher(iter(src), depth=2)
    got = list(pf)
    assert len(got) == len(src)
    for g, s in zip(got, src):
        for k, v in s.items():
            assert g[k].device.type == "cuda"
            np.testing.assert_array_equal(g[k].cpu().numpy(), v)
    # the pinned buffers came back for reuse: fewer than one set a batch
    kept = sum(map(len, pf._free.values())) + sum(
        len(bufs) for _, bufs in pf._in_flight)
    assert kept < 3 * len(src), kept


def test_trainer_defaults_to_the_card_and_keeps_device_batches(gen,
                                                               tmp_path):
    from segmentation_tpu_torch.core.config import ModelConfig, TrainConfig
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.training.trainer import SegmentationTrainer

    cfg = ModelConfig(n_classes=2, input_dims=(92, 92), n_kernels=32)
    trainer = SegmentationTrainer(UNetS2D(cfg, levels=2),
                                  train_cfg=TrainConfig(save_dir=str(tmp_path)))
    assert all(p.is_cuda for p in trainer.model.parameters())
    batch = {"image": _act(gen, 2, 92, 92, 3),
             "mask": torch.zeros((2, 92, 92, 1), dtype=torch.uint8,
                                 device="cuda")}
    placed = trainer._place(batch)
    assert all(placed[k].data_ptr() == batch[k].data_ptr() for k in batch)
    assert torch.isfinite(torch.tensor(trainer.train_step(batch)["seg_loss"]))


# ------------------------------------------------- the train step's glue
# relu_bias_grad's sites: the cotangent's shape [N, h, w, 4O] at the ten
# packed train sites of a 512² step (N = 1), then ragged shapes (N = 3, one
# pixel, 4O = 72 and 8); the mode (pool: the level sites; pad: the 2×2
# sites' zero-margined buffer)
GLUE = {"conv1_1": ((1, 255, 255, 128), {}),
        "conv1_2 pool": ((1, 254, 254, 128), {"pool": True, "pad": True}),
        "conv2_1": ((1, 126, 126, 256), {}),
        "conv2_2 pool": ((1, 125, 125, 256), {"pool": True, "pad": True}),
        "upconv3": ((1, 84, 84, 256), {}),
        "conv8_1 dual": ((1, 83, 83, 256), {"pad": True}),
        "conv8_2": ((1, 82, 82, 256), {"pad": True}),
        "upconv4": ((1, 164, 164, 128), {}),
        "conv9_1 dual": ((1, 163, 163, 128), {"pad": True}),
        "conv9_2": ((1, 162, 162, 128), {"pad": True}),
        "ragged N=3 pool": ((3, 7, 13, 128), {"pool": True, "pad": True}),
        "ragged pool no g": ((2, 9, 5, 256), {"pool": True, "pad": True,
                                              "no_g": True}),
        "one pixel": ((2, 1, 1, 256), {"pad": True}),
        "4O=72": ((2, 9, 13, 72), {}),
        "4O=8": ((1, 5, 6, 8), {"pad": True})}


def _glue_operands(gen, shape, mode):
    """g, y (a post-ReLU output, zero on about half the elements, with -0
    and +0 cotangents among g) and the pool's (gp, idx) where asked."""
    n, h, w, o4 = shape
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    g.view(-1)[::7] = -0.0
    y = torch.relu(torch.randn(shape, generator=gen, device="cuda")
                   ).to(torch.bfloat16)
    pool = None
    if mode.get("pool"):
        gp = torch.randn((n, h, w, o4 // 4), generator=gen,
                         device="cuda").to(torch.bfloat16)
        gp.view(-1)[::5] = -0.0
        idx = torch.randint(0, 4, (n, h, w, o4 // 4), generator=gen,
                            device="cuda", dtype=torch.int8)
        pool = (gp, idx)
    return (None if mode.get("no_g") else g), y, pool


GLUE_512 = tuple(GLUE)[:10]  # the 512² sites


@pytest.mark.parametrize("site", list(GLUE))
def test_relu_bias_grad_kernel(gen, site):
    """gm bit for bit equal to the plain version, margin included; db
    within its f32 bound (train_glue.db_error_bound: the depth of the
    kernel's sums) of the exact (f64) sum of gm, a bound that a db of
    zeros or of half the pixels exceeds at the 512² sites; two launches
    give the same bits."""
    from segmentation_tpu_torch.nn.kernels import train_glue as tg

    shape, mode = GLUE[site]
    g, y, pool = _glue_operands(gen, shape, mode)
    kw = {k: v for k, v in mode.items() if k == "pad"}
    tg.reset_launches()
    got = tg.relu_bias_grad(g, y, pool=pool, **kw)
    again = tg.relu_bias_grad(g, y, pool=pool, **kw)
    want = tg.relu_bias_grad_plain(g, y, pool=pool, **kw)
    torch.cuda.synchronize()
    name = "relu_bias_grad_pool" if pool is not None else "relu_bias_grad"
    assert tg.launches[name] == 2
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if a.dtype == torch.bfloat16:  # the bits, signs of zero included
            assert torch.equal(a.view(torch.int16), b.view(torch.int16)), i
    exact = want[0].double().sum((0, 1, 2))
    bound = tg.db_error_bound(want[0])
    err = (got[1].double() - exact).abs()
    assert (err <= bound).all(), (err - bound).max().item()
    if site in GLUE_512:
        half = want[0].double().flatten(0, 2)
        half = half[: half.shape[0] // 2].sum(0)
        assert ((exact.abs() > bound).any()
                and ((exact - half).abs() > bound).any())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# the duals' skip-side weight gradient (conv_bwd.conv2x2_wgrad_crop) at
# the 512² sites: (skip shape, the cotangent buffer's grid, crop offset)
WGRAD_CROP = {"conv8_1 (41,41)": ((8, 125, 125, 256), (84, 84), (41, 41)),
              "conv9_1 (90,90)": ((8, 254, 254, 128), (164, 164), (90, 90))}


@pytest.mark.parametrize("site", list(WGRAD_CROP))
def test_conv2x2_wgrad_crop_bf16_sums_in_f32(gen, site):
    """dwa in bf16 against the f64 product of the same bf16 operands:
    within one bf16 rounding of the result (2^-8 |ref|) plus 2^-16 Σ|a·b|
    for the f32 sum. The images come in pairs whose cotangents nearly
    cancel (skip post-ReLU, gm ≈ ±(1 + noise)), so each image's partial is
    large and their sum small: a partial rounded to bf16 per image (2^-9
    of a partial) would exceed the bound."""
    from segmentation_tpu_torch.nn.kernels import conv_bwd as cb

    shape, (hp, wp), offset = WGRAD_CROP[site]
    n, c4 = shape[0], shape[-1]
    skip = torch.relu(torch.randn(shape, generator=gen, device="cuda"))
    skip[1::2] = skip[0::2]
    g = torch.randn((n, hp - 1, wp - 1, c4), generator=gen, device="cuda")
    g[0::2] += 1.0
    g[1::2] = -g[0::2] + 2.0**-4 * g[1::2]
    gp = torch.zeros((n, hp, wp, c4), device="cuda", dtype=torch.bfloat16)
    gp[:, :-1, :-1] = g
    skip = skip.to(torch.bfloat16)
    got = cb.conv2x2_wgrad_crop(skip, gp, offset)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2, c4, c4)
    ref = cb.conv2x2_wgrad_crop(skip.double(), gp.double(), offset)
    mag = cb.conv2x2_wgrad_crop(skip.double().abs(), gp.double().abs(),
                                offset)
    err = (got.double() - ref).abs()
    bound = 2.0**-8 * ref.abs() + 2.0**-16 * mag
    assert (err <= bound).all(), (err / bound).max().item()


# (skip shape, up's packed grid, crop offset): the 512² sites, then small
# ones at either parity and at the far edge
MARGIN = {"conv8_1": ((2, 125, 125, 256), (84, 84), (41, 41)),
          "conv9_1": ((1, 254, 254, 128), (164, 164), (90, 90)),
          "same": ((3, 20, 23, 128), (20, 23), (0, 0)),
          "odd rows": ((3, 20, 23, 128), (17, 19), (3, 6)),
          "odd cols 4C=256": ((2, 17, 19, 256), (15, 14), (2, 5)),
          "far edge": ((1, 9, 9, 128), (6, 6), (5, 5))}


@pytest.mark.parametrize("case", list(MARGIN))
def test_crop_margin_zero_kernel(gen, case):
    """Zeros outside the crop window, the window untouched, bit for bit as
    the plain version (odd offsets: the edge pixels' slots one by one)."""
    from segmentation_tpu_torch.nn.kernels import train_glue as tg

    shape, (hp, wp), offset = MARGIN[case]
    n, hpa, wpa, c4 = shape
    buf = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    want = tg.crop_margin_zero_plain(buf.clone(), hp, wp, offset)
    got = tg.crop_margin_zero(buf.clone(), hp, wp, offset)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    keep = tg.window_mask(shape, hp, wp, offset, "cuda")
    assert torch.equal(got.view(n, hpa, wpa, 4, -1) * keep,
                       buf.view(n, hpa, wpa, 4, -1) * keep)


@pytest.mark.parametrize("o4", [128, 256])
@pytest.mark.parametrize("shape", ["conv2_2", "ragged", "ragged tiles",
                                   "one pixel", "N=3"])
def test_packed_conv2x2_pool_index_kernel(gen, shape, o4):
    """H1's train pool mode: y within the bf16 tolerance of the plain
    version; the pool and its index bit for bit pool_select's of the
    kernel's own y, with ties forced (zero input pixels give four equal
    slots under a bias tiled over the slots, a negative bias four zero
    slots): the first slot wins."""
    x = _act(gen, *FWD[shape])
    x[:, :4] = 0
    c4 = x.shape[-1]
    b = _bias(gen, o4 // 4)
    b[::4] = -5.0
    args = (x, _wgt(gen, 2, 2, c4, o4), b.repeat(4))  # one bias a slot
    y, pooled, idx = cf.packed_conv2x2(*args, pool_index=True)
    want = cf.packed_conv2x2_plain(*args, pool_index=True)
    _check(y, want[0])
    best, first = cf.pool_select(y)
    torch.cuda.synchronize()
    assert torch.equal(pooled, best) and torch.equal(idx, first)
    assert (idx == 0).float().mean().item() > 0.3  # the ties went first


# H6's dual in training: g the [N, hg, wg] window of its zero-margined
# buffer, dxa into the skip's crop window (the 512² sites' crops, then
# ragged ones at either parity)
DGRAD_CROP = {"conv8_1 (41,41)": ((1, 83, 83, 256), (1, 125, 125, 256),
                                  (41, 41)),
              "conv9_1 (90,90)": ((1, 163, 163, 128), (1, 254, 254, 128),
                                  (90, 90)),
              "odd 4C=128": ((2, 9, 13, 128), (2, 16, 19, 128), (5, 3)),
              "even 4C=256": ((3, 6, 7, 256), (3, 10, 10, 256), (4, 2)),
              "odd 4O=72": ((1, 9, 13, 72), (1, 12, 16, 256), (1, 2))}


@pytest.mark.parametrize("site", list(DGRAD_CROP))
def test_packed_conv2x2_dgrad_dual_crop_store(gen, site):
    from segmentation_tpu_torch.nn.kernels import conv_bwd as cb
    from segmentation_tpu_torch.nn.kernels import train_glue as tg

    gshape, sshape, offset = DGRAD_CROP[site]
    n, hg, wg, o4 = gshape
    c4 = sshape[-1]
    buf = torch.zeros((n, hg + 1, wg + 1, o4), device="cuda",
                      dtype=torch.bfloat16)
    buf[:, :hg, :wg] = _cot(gen, *gshape)
    g = buf[:, :hg, :wg]
    wa, wb = (_wgt(gen, 2, 2, c4, o4) for _ in range(2))
    tg.reset_launches()
    got = cb.packed_conv2x2_dgrad_dual(g, wa, wb, skip_shape=sshape,
                                       offset=offset)
    want = cb.packed_conv2x2_dgrad_dual_plain(g, wa, wb, skip_shape=sshape,
                                              offset=offset)
    _check(got, want)
    keep = tg.window_mask(sshape, hg + 1, wg + 1, offset, "cuda")
    outside = got[0].view(n, *sshape[1:3], 4, -1) * ~keep
    assert not outside.any() and tg.launches["crop_margin_zero"] == 1
    # the window equals the compact dxa of the same g, bit for bit
    compact = cb.packed_conv2x2_dgrad_dual(g.contiguous(), wa, wb)[0]
    from segmentation_tpu_torch.nn.packing import crop_packed

    assert torch.equal(crop_packed(got[0], compact.shape, offset), compact)


def _train_operands(gen, site):
    def act(*s):
        return _act(gen, *s).requires_grad_()

    def wgt(*s):
        return _wgt(gen, *s).float().requires_grad_()

    # biases of ±4 keep every pre-activation far from 0, so that bf16
    # rounding in either forward flips no ReLU mask; for the pool, slot
    # biases 4, 12, 20, 28 (the winner rotating with the channel) and every
    # fifth channel far below zero in all slots, so that rounding moves no
    # argmax either
    o = torch.arange(256, device="cuda")
    b = 4.0 - 8.0 * (o % 2).float()
    if site == "conv2x2_pool_t":
        b = (8.0 * ((o // 64 + o % 64) % 4).float() + 4.0
             - 40.0 * (o % 64 % 5 == 0))
    b = b.requires_grad_()
    args, kw = {
        "conv2x2_pool_t": ((act(2, 13, 21, 256), wgt(2, 2, 256, 256)), {}),
        "dual odd (5,3)": ((act(2, 16, 19, 256), act(2, 9, 11, 256),
                            wgt(2, 2, 256, 256), wgt(2, 2, 256, 256)),
                           {"offset": (5, 3)}),
        "dual even (4,6)": ((act(1, 13, 15, 128), act(1, 9, 11, 128),
                             wgt(2, 2, 128, 256), wgt(2, 2, 128, 256)),
                            {"offset": (4, 6)}),
    }[site]
    return args + (b,), kw


@pytest.mark.parametrize("site", ["conv2x2_pool_t", "dual odd (5,3)",
                                  "dual even (4,6)"])
def test_train_glue_functions_kernels_vs_plain(gen, site):
    """The level Function (H1 pool index, relu_bias_grad_pool) and the
    crop-folded dual (H2 at an offset, H6's crop store, crop_margin_zero,
    the crop wgrad): values and grads to every operand, the skip's
    included, against the same Functions on the plain versions."""
    from segmentation_tpu_torch.nn.kernels import train as kt

    args, kw = _train_operands(gen, site)
    fn = kt.conv2x2_pool_t if site == "conv2x2_pool_t" else kt.conv2x2_dual_t
    outs, grads = [], []
    for ops in (cf.KERNEL_OPS, cf.PLAIN_OPS):
        for a in args:
            a.grad = None
        ys = _outs(fn(*args, ops=ops, **kw))
        loss = sum((y.float() * torch.randn(
            y.shape, generator=generator(i + 1, "cuda"), device="cuda")
        ).sum() for i, y in enumerate(ys))
        loss.backward()
        outs.append([y.detach() for y in ys])
        grads.append([a.grad.clone() for a in args])
    for g, w in zip(outs[0], outs[1]):
        _check(g, w)
    for g, w in zip(*grads):
        _check(g, w)


@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32,
                                       torch.bfloat16])
@pytest.mark.parametrize("xs_kind", ["multiples of 8", "any"])
def test_crop_normalize_pair_kernel(gen, xs_kind, out_dtype):
    """H7's one launch for image and mask at the data path's shape (600²
    staging, crop 512) with half the samples flipped, x offsets multiples
    of 8 (fused_augment's) or any column: both outputs equal to the plain
    version byte for byte."""
    from segmentation_tpu_torch.nn.kernels import augment as aug

    n, tile, crop = 6, 600, 512
    x = torch.randint(0, 256, (n, tile, tile, 3), generator=gen,
                      device="cuda", dtype=torch.uint8)
    m = torch.randint(0, 2, (n, tile, tile, 1), generator=gen,
                      device="cuda", dtype=torch.uint8)
    ys = torch.randint(0, tile - crop + 1, (n,), generator=gen, device="cuda")
    xs = torch.randint(0, tile - crop + 1, (n,), generator=gen, device="cuda")
    if xs_kind == "multiples of 8":
        xs = xs // 8 * 8
    else:
        xs[:3] = torch.tensor([1, 7, 83], device="cuda")
    flips = torch.arange(n, device="cuda") % 2
    aug.reset_launches()
    got = aug.crop_normalize_pair(x, m, ys, xs, flips, crop, out_dtype)
    want = aug.crop_normalize_pair(x.cpu(), m.cpu(), ys.cpu(), xs.cpu(),
                                   flips.cpu(), crop, out_dtype)
    torch.cuda.synchronize()
    assert aug.launches["crop_normalize"] == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
