"""The tile plans of the MC-dropout forward at 1024² (the Bayesian U-Net's
configuration: B = 2 tiles, S = 8 samples, ``n_kernels`` 32), which no
512² cell plans: level 1's packed images 511 wide, the decoder at
B·S = 16.

The shapes are the forward's own: ``apply_mc`` runs on meta tensors
through the plain versions, and each call's operands are recorded. For
every site, the plan its wrapper makes (nn/kernels/conv_flat.py) must
keep TMA's rule (a box at most 256 a side, a tile within its kernel's
GEMM rows, H8's rows within W_MAX) and cover the output grid exactly once;
the duals' skip batch of 2 must divide the up batch of 16, and every
output pixel's skip reads lie inside the skip, whichever image it is.
"""

import numpy as np
import pytest
import torch

from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.models.unet import init_params
from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
from segmentation_tpu_torch.nn.kernels import conv_flat as cf
from segmentation_tpu_torch.nn.kernels import tiles

B, S = 2, 8


@pytest.fixture(scope="module")
def calls():
    """[(op, args, kwargs)] of one MC request at 1024², on meta tensors."""
    cfg = ModelConfig(n_classes=2, input_dims=(1024, 1024), n_kernels=32,
                      bayesian=True)
    model = UNetS2DInference(cfg)
    prepared = {k: v.to("meta") for k, v in model.prepare(
        init_params(cfg, generator(0)), dtype=torch.bfloat16).items()}
    out = []

    def rec(name, f):
        def op(*a, **kw):
            out.append((name, a, kw))
            return f(*a, **kw)
        return op

    model.ops = cf.Ops(*(rec(n, f) for n, f in
                         zip(cf.Ops._fields, cf.PLAIN_OPS)))
    x = torch.empty((B, 1024, 1024, 3), dtype=torch.bfloat16, device="meta")
    mean, var, cmap = model.apply_mc(prepared, x, 2**32 + 1, S)
    assert tuple(mean.shape) == (B, 836, 836, 2)
    assert tuple(cmap.shape) == (B, 836, 836)
    return out


def _coverage(plan):
    """Each output pixel's count of tiles that hold it (vectorised over
    the tiles of one image: every image has the same walk)."""
    hits = np.zeros((plan.hx, plan.wx), np.int64)
    per = plan.tiles_h * plan.tiles_w
    for t in range(per):
        _, i0, j0 = plan.origin(t)
        assert 0 <= i0 < plan.hx and 0 <= j0 < plan.wx
        hits[i0:i0 + plan.th, j0:j0 + plan.tw] += 1
    assert plan.count == plan.n * per
    return hits


def _check(plan, rows, halo, max_w=256):
    assert plan.th * (plan.tw + halo) <= rows, plan
    assert plan.th + halo <= 256 and plan.tw + halo <= min(256, max_w), plan
    assert (_coverage(plan) == 1).all(), plan


def _batches(calls, name):
    return [(a, kw) for op, a, kw in calls if op == name]


def test_every_packed_site_is_planned(calls):
    """H1 (conv1_2, conv2_2 at B; conv8_2 at B·S; the MC head), H2
    (conv8_1, conv9_1), H3 (conv1_1 gathered, conv2_1 boxed), H4
    (upconv3 identity, upconv4 scatter)."""
    seen = {}
    for op, a, kw in calls:
        if op in ("packed_conv2x2", "packed_conv2x2_mc_head"):
            x, w2 = a[0], a[1]
            n, hp, wp, _ = x.shape
            _check(cf._fwd_plan(n, hp - 1, wp - 1, w2.shape[-1]),
                   cf.FWD_TILE_ROWS, 1)
        elif op == "packed_conv2x2_dual":
            skip, up, w2a = a[0], a[1], a[2]
            n, hp, wp, _ = up.shape
            _check(cf._fwd_plan(n, hp - 1, wp - 1, w2a.shape[-1]),
                   cf.FWD_TILE_ROWS, 1)
        elif op == "strided_conv4x4s2":
            x, w4 = a[0], a[1]
            n, h, w, c = x.shape
            halo = int(all(v % 16 == 0 for v in
                           (4 * c, 2 * w * c, 4 * w * c, 2 * h * w * c)))
            _check(cf._fwd_plan(n, (h - 2) // 2, (w - 2) // 2,
                                w4.shape[-1], halo=halo),
                   cf.FWD_TILE_ROWS, halo)
        elif op == "rows_matmul":
            x, wm = a[0], a[1]
            plan = cf.rows_plan(x, wm.shape[-1], kw.get("scatter", False))
            _check(plan, cf.FWD_TILE_ROWS, 0)
            if kw.get("scatter"):
                assert plan.tw % 8 == 0
        else:
            continue
        seen.setdefault(op, []).append(tuple(a[1 if op.endswith("dual")
                                               else 0].shape))
    assert seen["strided_conv4x4s2"] == [(B, 1024, 1024, 3),
                                         (B, 510, 510, 32)]
    assert seen["packed_conv2x2"] == [(B, 511, 511, 128), (B, 254, 254, 256),
                                      (B * S, 211, 211, 256)]
    assert seen["packed_conv2x2_dual"] == [(B * S, 212, 212, 256),
                                           (B * S, 420, 420, 128)]
    assert seen["rows_matmul"] == [(B * S, 212, 212, 128),
                                   (B * S, 210, 210, 256)]
    assert seen["packed_conv2x2_mc_head"] == [(B * S, 419, 419, 128)]


def test_every_std_site_is_planned(calls):
    """H8 at B (conv3_1 … conv5_2) and at B·S (conv6_1 … conv7_2)."""
    batches = []
    for op, a, kw in calls:
        if op not in ("std_conv3x3", "std_conv3x3_dual"):
            continue
        x = a[1] if op == "std_conv3x3_dual" else a[0]
        o = a[2].shape[-1]
        n, h, w, _ = x.shape
        nb, bm, w_max = tiles.std_tile(o, 1)
        _check(tiles.std_plan(n, h - 2, w - 2, o, 1), bm, 2, w_max)
        batches.append(n)
    assert batches == [B] * 6 + [B * S] * 4


def test_the_duals_read_two_skips_under_sixteen(calls):
    """The skip batch divides the up batch, and the crop of the skip
    covers every output pixel's reads in each skip image."""
    packed = _batches(calls, "packed_conv2x2_dual")
    std = _batches(calls, "std_conv3x3_dual")
    assert len(packed) == len(std) == 2
    for a, kw in packed:
        skip, up = a[0], a[1]
        assert skip.shape[0] == B and up.shape[0] == B * S
        oh, ow = kw["offset"]
        assert oh + 2 * up.shape[1] <= 2 * skip.shape[1]
        assert ow + 2 * up.shape[2] <= 2 * skip.shape[2]
    for a, kw in std:
        skip, up = a[0], a[1]
        assert skip.shape[0] == B and up.shape[0] == B * S
        oh, ow = kw["offset"]
        assert oh + up.shape[1] <= skip.shape[1]
        assert ow + up.shape[2] <= skip.shape[2]
    # tile t of the up batch's walk reads skip image n % B
    plan = cf._fwd_plan(B * S, 419, 419, 128)
    per = plan.count // plan.n
    images = {plan.origin(t)[0] % B for t in range(0, plan.count, per)}
    assert images == set(range(B))
