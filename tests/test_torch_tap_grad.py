"""H9, the packed 2×2 sites' weight gradient (conv_bwd.packed_conv2x2_wgrad,
packed_conv2x2_wgrad_dual; csrc/packed_conv2x2_wgrad.cu).

On the CPU: the sites' geometry (``unet_fast.packed_wgrad_sites``)
against the operands a train step hands the ops; the wrapper's checks
(``tap_grad_operands``); the planner
(``tap_grad_plan``) at every site shape of the 512² U-Net at n_kernels 32
and 64, B = 2, 16 and 128: one wave of blocks, its K splits a partition of
each side's K blocks; ``crop_chunks`` against crop_packed's slot rule; the
plain dual against conv2x2_wgrad / conv2x2_wgrad_crop and torch's own conv
weight gradient at even and odd crops; and a torch emulation of the
kernel's walk (this file's ``_emulate``: per split and side and K block
the boxes the kernel loads, zero outside the tensor as TMA fills them,
the crop's last segment of a row in its narrower box, each tap's rows,
the k-steps a crop segment runs, the split partials summed in order)
against the plain versions in f64 at the sites' shapes (N = 1) and ragged
ones.

On the card (marked ``cuda``; they skip elsewhere):

    python -m pytest tests/test_torch_tap_grad.py -m cuda --noconftest

The kernel against the plain version in f64 at every site shape of both
widths (B = 2 and 16), the dual's skip read in place at conv8_1's (41, 41)
and conv9_1's (90, 90); a sum that bf16 partials would fail; two launches
bit-equal; a B = 16 train step at each width launching H9 six times with
no library GEMM or copy under the six sites' ``bwd:<site>/wgrad`` spans.
Card tolerance: the kernel rounds its f32 sum once to bf16, so within
2^-8 of the f64 result (a bf16 rounding, 2^-9, with room) plus 2^-16 of
Σ|x·g| for the f32 sum over up to a million pixels.
"""

import pytest
import torch

from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.models.unet_fast import packed_wgrad_sites
from segmentation_tpu_torch.nn.kernels import conv_bwd as cb
from segmentation_tpu_torch.nn.kernels import conv_flat as cf
from segmentation_tpu_torch.nn.packing import crop_packed

# the six packed sites of the 512² U-Net at n_kernels 32 and 64 (the model's
# site table at each width): (x's grid [hp, wp] = the cotangent buffer's,
# 4C, the dual's skip [hpa, wpa] and crop offset)
WIDTHS = {"n32": 32, "n64": 64}
GEOMETRY = {w: packed_wgrad_sites((512, 512), 4, k)
            for w, k in WIDTHS.items()}
SITES = tuple(GEOMETRY["n32"])
SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small products: one intra-op thread each, so that the CPU tests
    do not stall beside other test processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _site(name, width):
    (hp, wp), c4, skip_hw, offset = GEOMETRY[width][name]
    return hp, wp, c4, skip_hw, offset


def _operands(gen, n, hp, wp, c4, o4, skip_hw=None, device="cpu"):
    """x (or the dual's skip and up) post-ReLU-like, and the masked
    cotangent in its zero-margined buffer [n, hp, wp, 4O], bf16."""
    def act(*shape):
        return torch.rand(shape, generator=gen, device=device).to(
            torch.bfloat16)

    gp = torch.zeros((n, hp, wp, o4), device=device, dtype=torch.bfloat16)
    g = torch.randn((n, hp - 1, wp - 1, o4), generator=gen, device=device)
    keep = torch.rand(g.shape, generator=gen, device=device) > 0.5
    gp[:, :-1, :-1] = (g * keep).to(torch.bfloat16)
    xs = [act(n, *skip_hw, c4)] if skip_hw else []
    xs.append(act(n, hp, wp, c4))
    return xs, gp


def _plain(xs, gp, offset):
    if len(xs) == 2:
        return cb.conv2x2_wgrad_dual_plain(*xs, gp, offset=offset)
    return (cb.conv2x2_wgrad(xs[0], gp),)


# ------------------------------------------------------------ CPU: checks
def test_wrapper_checks_refuse_what_the_kernel_does_not_take():
    gen = generator(0)
    (x,), gp = _operands(gen, 2, 6, 7, 128, 128)
    name = "packed_conv2x2_wgrad"
    assert cb.tap_grad_operands(name, gp, (x,)) is None
    bad = [
        ((x.float(),), gp),                       # dtype
        ((x,), gp.float()),
        ((x[..., :64].contiguous(),), gp),        # 4C = 64
        ((torch.cat([x, x[..., :64]], -1),), gp),  # 4C = 192
        ((x,), gp[..., :64].contiguous()),        # 4O = 64
        ((x[:, :5].contiguous(),), gp),           # another grid
        ((x,), torch.zeros((2, 7, 8, 128), dtype=torch.bfloat16)[:, :6,
                                                                  :7]),
        ((x.transpose(1, 2).contiguous().transpose(1, 2),), gp),  # strided
        ((torch.zeros((2, 1, 7, 128), dtype=torch.bfloat16),),
         torch.zeros((2, 1, 7, 128), dtype=torch.bfloat16)),  # one row
    ]
    for operands, g in bad:
        with pytest.raises((ValueError, TypeError)):
            cb.tap_grad_operands(name, g, operands)
    flat = torch.zeros(2 * 6 * 7 * 128 + 8, dtype=torch.bfloat16)
    shifted = flat[8:].view(2, 6, 7, 128)     # 16-byte aligned
    cb.tap_grad_operands(name, gp, (shifted,))
    misaligned = flat[1:1 + 2 * 6 * 7 * 128].view(2, 6, 7, 128)
    with pytest.raises(ValueError, match="aligned"):
        cb.tap_grad_operands(name, gp, (misaligned,))


def test_dual_checks_and_the_crop_read_in_place():
    gen = generator(1)
    name = "packed_conv2x2_wgrad_dual"
    (skip, up), gp = _operands(gen, 2, 6, 7, 256, 128, skip_hw=(9, 10))
    # C = 64: the odd crop's slots are whole boxes
    assert cb.tap_grad_operands(name, gp, (skip, up), (3, 5)) is not None
    (skip2, up2), gp2 = _operands(gen, 2, 6, 7, 128, 128, skip_hw=(9, 10))
    # even: a window
    assert cb.tap_grad_operands(name, gp2, (skip2, up2), (2, 4)) is not None
    with pytest.raises(ValueError, match="odd crop"):  # C = 32 a slot
        cb.tap_grad_operands(name, gp2, (skip2, up2), (3, 4))
    # no crop: flat
    assert cb.tap_grad_operands(name, gp2, (up2, up2), (0, 0)) is None
    for offset in [(-2, 0), (8, 0), (0, 9), (7, 7)]:
        with pytest.raises(ValueError, match="crop"):
            cb.tap_grad_operands(name, gp2, (skip2, up2), offset)
    with pytest.raises(ValueError):
        cb.tap_grad_operands(name, gp2, (skip2[..., :64].contiguous(), up2),
                             (2, 4))


# ------------------------------------------------------------ CPU: sites
@pytest.mark.parametrize("hw,levels", [(92, 2), (192, 4)])
def test_site_geometry_is_what_a_train_step_hands_h9(hw, levels):
    """packed_wgrad_sites gives the operands a train step's packed sites
    hand the wgrad ops: x's grid and 4C, and the dual's skip grid and crop
    offset (192² at four levels crops as 512² does, at (41, 41) and
    (90, 90))."""
    from collections import Counter

    from segmentation_tpu_torch.core.config import ModelConfig
    from segmentation_tpu_torch.models.unet_fast import UNetS2D

    seen = Counter()

    def single(x, gp):
        seen[(tuple(x.shape[1:3]), x.shape[3], None, None)] += 1
        return cf.PLAIN_OPS.packed_conv2x2_wgrad(x, gp)

    def dual(skip, up, gp, *, offset):
        seen[(tuple(up.shape[1:3]), up.shape[3], tuple(skip.shape[1:3]),
              tuple(offset))] += 1
        return cf.PLAIN_OPS.packed_conv2x2_wgrad_dual(skip, up, gp,
                                                      offset=offset)

    ops = cf.PLAIN_OPS._replace(packed_conv2x2_wgrad=single,
                                packed_conv2x2_wgrad_dual=dual)
    cfg = ModelConfig(n_classes=2, input_dims=(hw, hw), n_kernels=4)
    model = UNetS2D(cfg, levels=levels, ops=ops)
    model(torch.rand((1, hw, hw, 3))).float().sum().backward()
    assert seen == Counter(packed_wgrad_sites((hw, hw), levels, 4).values())


# ------------------------------------------------------------ CPU: plan
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("n", [2, 16, 128])
@pytest.mark.parametrize("site", SITES)
def test_plan_fills_one_wave_and_splits_every_k_block_once(site, n, width):
    hp, wp, c4, skip_hw, _ = _site(site, width)
    crops = (True, False) if skip_hw else (False,)
    plan = cb.tap_grad_plan(n, hp, wp, c4, c4, crops, SMS)
    units = 2 * (c4 // 128) ** 2  # blocks a split
    assert plan.blocks == plan.splits * units <= SMS
    # every SM that another split could fill is filled
    assert plan.blocks > SMS - units
    for side, crop in enumerate(crops):
        k = plan.k_blocks[side]
        assert k == cb.tap_k_blocks(n, hp, wp, crop)
        assert 1 <= plan.splits <= k
        edges = [plan.k_range(side, t) for t in range(plan.splits)]
        assert edges[0][0] == 0 and edges[-1][1] == k
        assert all(a < b for a, b in edges)
        assert all(e[1] == f[0] for e, f in zip(edges, edges[1:]))
        # the crop's K blocks run whole rows of 128 columns: the real
        # columns need at most one segment more than the flat walk's rows
        if crop:
            assert k == n * (hp - 1) * -(-(wp - 1) // 128)


def test_plan_at_the_cells_batch():
    """B = 128: the blocks of each site (one wave of 128 or 132 on 132
    SMs) and their K splits (a dual's block sums both sides)."""
    want = {("conv1_2", "n32"): (66, 132), ("conv2_2", "n32"): (16, 128),
            ("conv8_1", "n32"): (16, 128), ("conv8_2", "n32"): (16, 128),
            ("conv9_1", "n32"): (66, 132), ("conv9_2", "n32"): (66, 132),
            ("conv1_2", "n64"): (16, 128), ("conv2_2", "n64"): (4, 128),
            ("conv8_1", "n64"): (4, 128), ("conv8_2", "n64"): (4, 128),
            ("conv9_1", "n64"): (16, 128), ("conv9_2", "n64"): (16, 128)}
    for (site, width), (splits, blocks) in want.items():
        hp, wp, c4, skip_hw, _ = _site(site, width)
        crops = (True, False) if skip_hw else (False,)
        plan = cb.tap_grad_plan(128, hp, wp, c4, c4, crops, SMS)
        assert (plan.splits, plan.blocks) == (splits, blocks), (site, width)


@pytest.mark.parametrize("c4", [128, 256, 512])
@pytest.mark.parametrize("offset", [(0, 0), (2, 4), (41, 41), (90, 90),
                                    (3, 6), (2, 5), (1, 1)])
def test_crop_chunks_follow_the_slot_rule(c4, offset):
    """Chunk q of the crop's pixel (i, j) is the skip's 64 channels from cc
    at (i + di, j + dj): the crop crop_packed makes, chunk by chunk; None
    only where an odd crop's slot (C channels) is not whole chunks."""
    c = c4 // 4
    hp, wp = 5, 6
    hpa, wpa = hp + offset[0] // 2 + 1, wp + offset[1] // 2 + 1
    skip = torch.arange(2 * hpa * wpa * c4, dtype=torch.float64).reshape(
        2, hpa, wpa, c4)
    chunks = cb.crop_chunks(c4, offset)
    odd = offset[0] % 2 or offset[1] % 2
    if odd and c % 64:
        assert chunks is None
        return
    want = crop_packed(skip, (2, hp, wp, c4), offset)
    di, dj, cc = chunks
    for q in range(c4 // 64):
        got = skip[:, di[q]:di[q] + hp, dj[q]:dj[q] + wp, cc[q]:cc[q] + 64]
        assert torch.equal(got, want[..., 64 * q:64 * q + 64]), q


# ------------------------------------------------------------ CPU: plain
@pytest.mark.parametrize("offset", [(0, 0), (2, 4), (3, 3), (5, 2)])
def test_plain_dual_is_both_sides_wgrads(offset):
    """KERNEL_OPS' dual on CPU tensors (the plain version) is
    conv2x2_wgrad_crop of the skip and conv2x2_wgrad of up, and both equal
    torch's conv weight gradient of the conv of the crop and of up."""
    gen = generator(2)
    n, hp, wp, c4, o4 = 2, 6, 7, 128, 64
    skip = torch.randn((n, hp + 3, wp + 3, c4), generator=gen,
                       dtype=torch.float64)
    up = torch.randn((n, hp, wp, c4), generator=gen, dtype=torch.float64)
    gp = torch.zeros((n, hp, wp, o4), dtype=torch.float64)
    gp[:, :-1, :-1] = torch.randn((n, hp - 1, wp - 1, o4), generator=gen,
                                  dtype=torch.float64)
    dwa, dwb = cf.KERNEL_OPS.packed_conv2x2_wgrad_dual(skip, up, gp,
                                                       offset=offset)
    assert torch.equal(dwa, cb.conv2x2_wgrad_crop(skip, gp, offset))
    assert torch.equal(dwb, cb.conv2x2_wgrad(up, gp))
    assert torch.equal(cf.KERNEL_OPS.packed_conv2x2_wgrad(up, gp), dwb)
    gn = gp[:, :-1, :-1].permute(0, 3, 1, 2)
    for x, dw in ((crop_packed(skip, up.shape, offset), dwa), (up, dwb)):
        want = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2),
                                           (o4, c4, 2, 2), gn)
        torch.testing.assert_close(dw, want.permute(2, 3, 1, 0),
                                   rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------ CPU: the walk
def _box(t, starts, sizes):
    """The box of ``t`` at ``starts`` of ``sizes`` (any dims), zero outside
    t: TMA's load."""
    out = t.new_zeros(sizes)
    src, dst = [], []
    for s, k, d in zip(starts, sizes, t.shape):
        lo, hi = max(s, 0), min(s + k, d)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s, hi - s))
    out[tuple(dst)] = t[tuple(src)]
    return out


def _emulate(gp, xs, offset, sms):
    """dw of each side as the kernel computes it, in f64 (see the module
    docstring)."""
    chunks = cb.tap_grad_operands("emulate", gp, xs, offset)
    n, hp, wp, o4 = gp.shape
    c4 = xs[0].shape[-1]
    crops = (chunks is not None, False)[:len(xs)]
    plan = cb.tap_grad_plan(n, hp, wp, c4, o4, crops, sms)
    g = gp.double()
    rows = cb.TAP_K_ROWS
    out = []
    for side, (x, crop) in enumerate(zip(xs, crops)):
        x = x.double()
        partials = []
        for t in range(plan.splits):
            part = torch.zeros((2, 2, c4, o4), dtype=torch.float64)
            for k in range(*plan.k_range(side, t)):
                if not crop:  # flat rows; x's box one row longer
                    p0 = k * rows
                    b = _box(g.reshape(-1, o4), (p0, 0), (rows, o4))
                    for u in range(2):
                        a = _box(x.reshape(-1, c4), (p0 + u * wp, 0),
                                 (rows + 1, c4))
                        for v in range(2):
                            part[u, v] += a[v:v + rows].T @ b
                    continue
                segs = -(-(wp - 1) // rows)
                nn, r = divmod(k, (hp - 1) * segs)
                i, sg = divmod(r, segs)
                j0 = sg * rows
                steps = -(-min(rows, wp - 1 - j0) // 16)
                # a whole segment's boxes, or the row's last: its own
                b = _box(g, (nn, i, j0, 0), (1, 1, 16 * steps, o4))[0, 0]
                di, dj, cc = chunks
                width = 16 * steps + 1
                for u in range(2):
                    a = torch.cat([
                        _box(x, (nn, i + u + di[q], j0 + dj[q], cc[q]),
                             (1, 1, width, 64))[0, 0]
                        for q in range(c4 // 64)], dim=1)
                    for v in range(2):
                        part[u, v] += a[v:v + 16 * steps].T @ b
            partials.append(part)
        out.append(sum(partials[1:], partials[0]))
    return out


EMULATED = {  # (n, hp, wp, 4C, 4O, the dual's skip [hpa, wpa], offset)
    "flat ragged": (2, 9, 13, 128, 256, None, None),
    "flat 4C=256 4O=128": (1, 12, 11, 256, 128, None, None),
    "dual odd (3,5) C=64": (2, 8, 9, 256, 128, (11, 12), (3, 5)),
    "dual even (2,4)": (1, 7, 6, 128, 128, (10, 9), (2, 4)),
    "dual uncropped": (1, 6, 7, 128, 128, (6, 7), (0, 0)),
    "dual wide rows": (1, 4, 150, 128, 128, (6, 200), (2, 90)),
    "conv8_1 n32 N=1": (1, 84, 84, 256, 256, (125, 125), (41, 41)),
    "conv9_1 n32 N=1": (1, 164, 164, 128, 128, (254, 254), (90, 90)),
    "conv8_2 n32 N=1": (1, 83, 83, 256, 256, None, None),
}


@pytest.mark.parametrize("sms", [SMS, 7])
@pytest.mark.parametrize("case", list(EMULATED))
def test_the_walk_sums_each_tap_once(case, sms):
    """The emulated kernel equals the plain version (f64): every real
    pixel's taps enter one split of one side once, and nothing else
    does."""
    n, hp, wp, c4, o4, skip_hw, offset = EMULATED[case]
    if n * hp * wp > 8000 and sms != SMS:
        pytest.skip("the sites' shapes run at the card's SM count only")
    xs, gp = _operands(generator(3), n, hp, wp, c4, o4, skip_hw)
    got = _emulate(gp, xs, offset, sms)
    want = _plain([x.double() for x in xs], gp.double(), offset)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-9)


# ------------------------------------------------------------ card
@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return generator(0, "cuda")


def _check(got, xs, gp, offset):
    """Each side within 2^-8 |ref| + 2^-16 Σ|x·g| of the f64 product."""
    torch.cuda.synchronize()
    ref = _plain([x.double() for x in xs], gp.double(), offset)
    mag = _plain([x.double().abs() for x in xs], gp.double().abs(), offset)
    assert len(got) == len(ref)
    for dw, r, m in zip(got, ref, mag):
        assert dw.dtype == torch.bfloat16 and dw.shape == r.shape
        err = (dw.double() - r).abs()
        bound = 2.0**-8 * r.abs() + 2.0**-16 * m
        assert (err <= bound).all(), (err / bound).max().item()


def _kernel(xs, gp, offset):
    if len(xs) == 2:
        return cb.packed_conv2x2_wgrad_dual(*xs, gp, offset=offset)
    return (cb.packed_conv2x2_wgrad(xs[0], gp),)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 16])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("site", SITES)
def test_tap_grad_kernel_vs_plain(gen, site, width, n):
    hp, wp, c4, skip_hw, offset = _site(site, width)
    xs, gp = _operands(gen, n, hp, wp, c4, c4, skip_hw, device="cuda")
    cb.reset_launches()
    got = _kernel(xs, gp, offset)
    assert cb.launches["packed_conv2x2_wgrad"] == 1
    _check(got, xs, gp, offset)
    again = _kernel(xs, gp, offset)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in EMULATED if "N=1" not in c])
def test_tap_grad_kernel_at_ragged_shapes(gen, case):
    n, hp, wp, c4, o4, skip_hw, offset = EMULATED[case]
    xs, gp = _operands(gen, n, hp, wp, c4, o4, skip_hw, device="cuda")
    _check(_kernel(xs, gp, offset), xs, gp, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["conv8_1", "conv9_1", "conv8_2"])
def test_tap_grad_sums_in_f32(gen, site):
    """Images in pairs whose cotangents nearly cancel (x post-ReLU, g ≈
    ±(1 + noise)): each image's partial is large and their sum small, so a
    partial rounded to bf16 per image (2^-9 of a partial) would exceed the
    bound."""
    hp, wp, c4, skip_hw, offset = _site(site, "n32")
    n = 8
    xs = [torch.relu(torch.randn((n, *hw, c4), generator=gen,
                                 device="cuda"))
          for hw in ([skip_hw] if skip_hw else []) + [(hp, wp)]]
    for x in xs:
        x[1::2] = x[0::2]
    g = torch.randn((n, hp - 1, wp - 1, c4), generator=gen, device="cuda")
    g[0::2] += 1.0
    g[1::2] = -g[0::2] + 2.0**-4 * g[1::2]
    gp = torch.zeros((n, hp, wp, c4), device="cuda", dtype=torch.bfloat16)
    gp[:, :-1, :-1] = g
    xs = [x.to(torch.bfloat16) for x in xs]
    _check(_kernel(xs, gp, offset), xs, gp, offset)


@pytest.mark.cuda
def test_tap_grad_refuses_bad_operands_on_the_card(gen):
    xs, gp = _operands(gen, 2, 6, 7, 128, 128, device="cuda")
    with pytest.raises(TypeError):
        cb.packed_conv2x2_wgrad(xs[0].float(), gp)
    with pytest.raises(ValueError):
        cb.packed_conv2x2_wgrad(xs[0], gp.cpu())
    with pytest.raises(ValueError):
        cb.packed_conv2x2_wgrad(xs[0][..., :64].contiguous(), gp)


@pytest.mark.cuda
@pytest.mark.parametrize("n_kernels", [32, 64])
def test_unet_step_runs_h9_at_every_packed_wgrad(gen, n_kernels):
    """One B = 16 forward and backward at 512²: six H9 launches, none of
    the plain four products, and under each packed site's
    ``bwd:<site>/wgrad`` span H9's two kernels alone (no library GEMM, no
    copy)."""
    from segmentation_tpu_torch.core.config import ModelConfig
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.profile_serving import group_of
    from segmentation_tpu_torch.profile_train import attribute, trace_steps

    cfg = ModelConfig(n_classes=2, input_dims=(512, 512),
                      n_kernels=n_kernels)
    model = UNetS2D(cfg, seed=1, ops=cf.KERNEL_OPS).to("cuda")
    x = torch.rand((16, 512, 512, 3), generator=gen,
                   device="cuda").to(torch.bfloat16)

    def step():
        model(x).float().square().mean().backward()

    plain = []
    wgrad = cb.conv2x2_wgrad
    cb.conv2x2_wgrad = lambda *a: plain.append(a) or wgrad(*a)
    try:
        step()
        torch.cuda.synchronize()
        cb.reset_launches()
        step()
        torch.cuda.synchronize()
        launches = dict(cb.launches)
        _, _, by_group, _, _ = attribute(trace_steps(step, 1)[1], 1)
    finally:
        cb.conv2x2_wgrad = wgrad
    assert launches["packed_conv2x2_wgrad"] == 6, launches
    assert not plain
    seen = {}
    for (site, group), ms in by_group.items():
        name = site.rpartition("bwd:")[2]
        if name.endswith("/wgrad") and name[:-6] in SITES:
            seen.setdefault(name[:-6], set()).add(group)
    assert set(seen) == set(SITES), seen
    h9 = {group_of("void segk::packed_tap_grad_kernel(segk::TapGradParams)"),
          group_of("void segk::tap_grad_sum_kernel(float const*, "
                   "__nv_bfloat16*, int, int)")}
    assert not h9 & {"library GEMM", "library conv", "copies"}, h9
    for site, groups in seen.items():
        assert groups <= h9, (site, groups)
