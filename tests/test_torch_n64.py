"""The U-Net at the paper's widths (n_kernels = 64, widths 64–1024): level
2's packed sites at 4O = 512 (and H6 at 4C = 512).

On the CPU: the models at n_kernels = 64 on the plain versions against
the JAX package's U-Net (f64: see their tolerances), and the int8 route's
refusal. The 4O = 512 column tiles, and a torch emulation of the kernels'
column-tiled loads against JAX's Pallas kernels, are in
tests/test_torch_fwd_tiles.py and tests/test_torch_dgrad_tiles.py.

The ``cuda`` tests run each 4O = 512 mode, the glue at 512 channels, one
n_kernels = 64 train step and the bf16 server on the card against their
plain versions (``python -m pytest tests/test_torch_n64.py -m cuda
--noconftest``; bf16 values within 2e-2 of the largest reference value:
the kernel and the plain version round the same f32 sums, in another
order, to 8 mantissa bits).
"""

import numpy as np
import pytest
import torch

from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.models.unet import init_params, unet_param_shapes
from segmentation_tpu_torch.nn.kernels import conv_bwd as cb
from segmentation_tpu_torch.nn.kernels import conv_flat as cf
from segmentation_tpu_torch.nn.kernels import train_glue as tg

REL_TOL = 2e-2  # bf16 values: 2e-2 of the largest reference value
HW, LEVELS = 92, 2  # levels 2 keeps level 2 packed at 4C = 4O = 512


def _rng(seed=0):
    return np.random.default_rng(seed)


# ------------------------------------------------------------ the models
def _cfg(hw):
    return ModelConfig(n_classes=2, input_dims=(hw, hw), n_kernels=64)


def _np_params(seed):
    """Seeded xavier-uniform weights and biases uniform in ±0.01 (the
    benchmark's draw: every bias path carries a value), f64, by JAX name."""
    rng = _rng(seed)
    out = {}
    for name, shape in unet_param_shapes(_cfg(HW), LEVELS):
        if name.endswith("/w"):
            fan_in = int(np.prod(shape[:-1]))
            fan_out = int(np.prod(shape[:-2])) * shape[-1]
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            out[name] = rng.uniform(-lim, lim, shape)
        else:
            out[name] = rng.uniform(-0.01, 0.01, shape)
    return out


def _jax_unet(params, x, cot=None):
    """JAX's U-Net at n_kernels = 64 in f64: its logits, or the loss Σ
    logits · cot and its gradient by name. (JAX is imported here: the
    card's tests below run where it is not installed.)"""
    import jax
    import jax.numpy as jnp

    from segmentation_tpu.core.config import ModelConfig as JConfig
    from segmentation_tpu.models.unet import UNet as JUNet
    from segmentation_tpu.nn import module as hk

    jcfg = JConfig(n_classes=2, input_dims=(HW, HW), n_kernels=64)
    fwd = hk.transform(lambda v: JUNet(jcfg, levels=LEVELS)(v))
    with jax.enable_x64(True):
        p = {k: jnp.asarray(v) for k, v in params.items()}
        xj = jnp.asarray(x)

        def logits(q):
            return fwd.apply(q, {}, None, xj, train=False)[0]

        if cot is None:
            return np.asarray(jax.jit(logits)(p))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda q: jnp.sum(logits(q) * jnp.asarray(cot))))(p)
        return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def test_n64_train_model_matches_unet():
    """UNetS2D at n_kernels = 64 (levels 2: level 2 packed at 4C = 4O =
    512, the bottleneck at 256 channels) on the plain versions against JAX's
    U-Net, both in f64 on the same seeded params, on one batch: the loss Σ
    logits · cot and every param's gradient to 1e-5 of its largest entry.
    f64, because in f32 a pre-activation within summation-order noise of 0
    flips its ReLU on one path only (seen at upconv1, 0.9 % of its
    gradient); the plain versions' epilogue rounds to f32 (``_epilogue``),
    ~1e-7 relative."""
    from segmentation_tpu_torch.models.unet_fast import UNetS2D

    params = _np_params(5)
    x = _rng(4).uniform(0, 1, (2, HW, HW, 3))
    model = UNetS2D(_cfg(HW), levels=LEVELS, ops=cf.PLAIN_OPS,
                    params={k: torch.from_numpy(v.copy())
                            for k, v in params.items()}).double()
    assert model.params["conv2_2/w"].shape == (3, 3, 128, 128)
    logits = model(torch.from_numpy(x))
    cot = _rng(5).standard_normal(tuple(logits.shape))
    want, want_g = _jax_unet(params, x, cot)
    got = (logits * torch.from_numpy(cot)).sum()
    got.backward()
    assert abs(got.item() - want) <= 1e-5 * abs(want)
    assert set(model.params) == set(want_g)
    for k, p in model.params.items():
        r = want_g[k]
        assert np.abs(p.grad.numpy() - r).max() <= 1e-5 * np.abs(r).max(), k


def test_n64_inference_matches_unet():
    """UNetS2DInference at n_kernels = 64 (levels 2) on the plain
    versions, f64 weights, against JAX's U-Net's logits to 1e-5 of their
    largest magnitude (the plain epilogue's f32 rounding), and its class map
    against their argmax but where the two logits lie within the bf16
    tolerance: the class map's head takes bf16 operands by design (the
    kernel's: the stored value and w1 - w0 rounded to 8 mantissa bits)."""
    from segmentation_tpu_torch.models.unet_fast import UNetS2DInference

    params = _np_params(7)
    x = _rng(6).uniform(0, 1, (2, HW, HW, 3))
    model = UNetS2DInference(_cfg(HW), levels=LEVELS, ops=cf.PLAIN_OPS)
    prepared = model.prepare({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             dtype=torch.float64)
    assert prepared["conv4_1/w2a"].shape == (2, 2, 512, 512)  # conv8_1 at 4 levels
    with torch.no_grad():
        got = model.apply(prepared, torch.from_numpy(x)).numpy()
        masks = model.apply_argmax(prepared, torch.from_numpy(x)).numpy()
    want = _jax_unet(params, x)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    margin = np.abs(want[..., 1] - want[..., 0])
    diff = masks != want.argmax(-1)
    assert np.all(margin[diff] <= REL_TOL * scale)
    assert diff.mean() < 0.01


def test_int8_route_refuses_n64():
    """The int8 route has no s8 mode at 4O = 512: UNetS2DInt8 refuses
    n_kernels = 64 when it is built, not with a CUDA error at launch."""
    from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8

    with pytest.raises(ValueError, match=r"4O = 512.*s8 modes"):
        UNetS2DInt8(_cfg(512))
    UNetS2DInt8(ModelConfig(n_classes=2, input_dims=(512, 512),
                            n_kernels=32))  # the flagship still builds


# ------------------------------------------------------------ on the card


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return generator(0, "cuda")


def _params(cfg, levels, seed=5):
    """Seeded xavier weights and biases uniform in ±0.01, f32."""
    params = init_params(cfg, generator(seed), levels)
    gen = generator(seed + 1)
    for k, v in params.items():
        if k.endswith("/b"):
            params[k] = (torch.rand(v.shape, generator=gen) - 0.5) * 0.02
    return params


def _act(gen, *shape):
    return torch.rand(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _wgt(gen, *shape):
    w = torch.randn(shape, generator=gen, device="cuda")
    return (w / np.prod(shape[:-1]) ** 0.5).to(torch.bfloat16)


def _bias(gen, o4):
    return torch.randn((o4,), generator=gen, device="cuda") * 0.1


def _check(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = (g.float() - w.float()).abs().max().item()
        assert err <= REL_TOL * w.float().abs().max().item(), err


# x's shape at H1's 4O = 512 cases: the 512² conv2_2 and conv8_2 sites, a
# last tile ragged both ways, one row, one pixel, N = 3, 4C = 72 (a
# partial K block)
FWD = {"conv2_2": (1, 126, 126, 512), "conv8_2": (1, 83, 83, 512),
       "ragged tiles": (1, 44, 65, 512), "one row": (1, 2, 40, 512),
       "one pixel": (2, 2, 2, 512), "N=3": (3, 20, 45, 256),
       "4C=72": (2, 9, 13, 72)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "pool", "pool_index"])
@pytest.mark.parametrize("shape", list(FWD))
def test_packed_conv2x2_512_kernel(gen, shape, mode):
    """y (and the pool) within the bf16 tolerance of the plain version;
    the pool and its index bit for bit pool_select's of the kernel's own y,
    with ties forced (zero input rows, one bias a slot) where the first
    slot must win."""
    x = _act(gen, *FWD[shape])
    x[:, :2] = 0
    b = _bias(gen, 128)
    b[::4] = -5.0
    args = (x, _wgt(gen, 2, 2, x.shape[-1], 512), b.repeat(4))
    cf.reset_launches()
    if mode == "plain":
        _check(cf.packed_conv2x2(*args), cf.packed_conv2x2_plain(*args))
        return
    kw = {mode: True}
    got = cf.packed_conv2x2(*args, **kw)
    _check(got[:2], cf.packed_conv2x2_plain(*args, **kw)[:2])
    best, first = cf.pool_select(got[0])
    assert torch.equal(got[1], best)
    if mode == "pool_index":
        assert torch.equal(got[2], first)
        assert cf.launches["packed_conv2x2_pool_index"] == 1


# H2's 4O = 512 cases: (skip, up) shapes and the unpacked crop offset;
# conv8_1's site at 512² (C = 128: each K block one slot's box), an even
# offset, ragged tiles, N = 3; C = 32 at an odd offset gathers the skip,
# a mode with no 4O = 512, and is refused
DUAL = {"conv8_1": ((1, 125, 125, 512), (1, 84, 84, 512), (41, 41)),
        "even": ((2, 15, 17, 512), (2, 9, 11, 512), (4, 6)),
        "odd ragged": ((1, 48, 69, 512), (1, 44, 65, 512), (3, 5)),
        "N=3": ((3, 24, 49, 256), (3, 20, 45, 256), (2, 3)),
        "odd C=32 refused": ((1, 15, 17, 128), (1, 9, 11, 128), (3, 5))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DUAL))
def test_packed_conv2x2_dual_512_kernel(gen, case):
    sshape, ushape, offset = DUAL[case]
    skip, up = _act(gen, *sshape), _act(gen, *ushape)
    c4 = ushape[-1]
    wa, wb = (_wgt(gen, 2, 2, c4, 512) for _ in range(2))
    b = _bias(gen, 512)
    if (c4 // 4) % 64 and (offset[0] | offset[1]) % 2:
        with pytest.raises(ValueError, match="no 4O = 512"):
            cf.packed_conv2x2_dual(skip, up, wa, wb, b, offset=offset)
        return
    _check(cf.packed_conv2x2_dual(skip, up, wa, wb, b, offset=offset),
           cf.packed_conv2x2_dual_plain(skip, up, wa, wb, b, offset=offset))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 254, 254, 64), (2, 22, 20, 64),
                                   (3, 10, 14, 32)])
def test_strided_conv4x4s2_512_kernel(gen, shape):
    """H3 boxed at 4O = 512: conv2_1's site at 512², ragged, N = 3."""
    x = _act(gen, *shape)
    args = (x, _wgt(gen, 4, 4, shape[-1], 512), _bias(gen, 512))
    _check(cf.strided_conv4x4s2(*args), cf.strided_conv4x4s2_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 84, 84, 256), (2, 7, 9, 128),
                                   (3, 5, 13, 64)])
def test_rows_matmul_512_kernel(gen, shape):
    """H4's identity at 4O = 512: upconv3's site at 512², ragged, N = 3;
    the scatter has no 4O = 512 mode and refuses it."""
    x = _act(gen, *shape)
    args = (x, _wgt(gen, shape[-1], 512), _bias(gen, 512))
    _check(cf.rows_matmul(*args), cf.rows_matmul_plain(*args))
    with pytest.raises(ValueError, match="no 4O = 512"):
        cf.rows_matmul(_act(gen, 1, 4, 4, 4 * shape[-1]), *args[1:],
                       scatter=True)


def _cot(gen, *shape):
    g = torch.randn(shape, generator=gen, device="cuda")
    keep = torch.rand(shape, generator=gen, device="cuda") > 0.5
    return (g * keep).to(torch.bfloat16)


# g's shape at H6's 4C = 512 cases: conv2_2's and conv8_2's sites at 512²,
# ragged tiles, N = 3, 4O = 72; the dual: conv8_1's site with its crop
# store (41, 41), an even crop, no crop
DGRAD = {"conv2_2": (1, 125, 125, 512), "conv8_2": (1, 82, 82, 512),
         "ragged tiles": (1, 50, 70, 512), "N=3": (3, 20, 45, 256),
         "4O=72": (2, 9, 13, 72)}
DGRAD_DUAL = {"conv8_1": ((1, 83, 83, 512), (1, 125, 125, 512), (41, 41)),
              "even crop": ((2, 9, 13, 512), (2, 14, 16, 512), (4, 2)),
              "no crop": ((3, 20, 45, 256), None, (0, 0))}


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(DGRAD))
def test_packed_conv2x2_dgrad_512_kernel(gen, site):
    shape = DGRAD[site]
    g, w = _cot(gen, *shape), _wgt(gen, 2, 2, 512, shape[-1])
    _check(cb.packed_conv2x2_dgrad(g, w), cb.packed_conv2x2_dgrad_plain(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(DGRAD_DUAL))
def test_packed_conv2x2_dgrad_dual_512_kernel(gen, site):
    """The dual from g's window of its zero-margined buffer, dxa stored
    into the skip's crop window, zeros outside it."""
    gshape, sshape, offset = DGRAD_DUAL[site]
    n, hg, wg, o4 = gshape
    buf = torch.zeros((n, hg + 1, wg + 1, o4), device="cuda",
                      dtype=torch.bfloat16)
    buf[:, :hg, :wg] = _cot(gen, *gshape)
    g = buf[:, :hg, :wg]
    wa, wb = (_wgt(gen, 2, 2, 512, o4) for _ in range(2))
    kw = {} if sshape is None else {"skip_shape": sshape, "offset": offset}
    got = cb.packed_conv2x2_dgrad_dual(g, wa, wb, **kw)
    _check(got, cb.packed_conv2x2_dgrad_dual_plain(g, wa, wb, **kw))
    if sshape is not None:
        keep = tg.window_mask(sshape, hg + 1, wg + 1, offset, "cuda")
        assert not (got[0].view(n, *sshape[1:3], 4, -1) * ~keep).any()


@pytest.mark.cuda
def test_n64_step_kernels_vs_plain(gen, tmp_path):
    """One B = 2 512² train step at n_kernels = 64 on the kernels against
    the same trainer on the plain versions, at the flagship's bars (loss
    to 1e-2 relative; each param's grad cosine >= 0.999, relative L2 error
    <= 5e-2); every packed kernel mode of training launches, H6 too."""
    from segmentation_tpu_torch.core.config import TrainConfig
    from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.training.trainer import SegmentationTrainer

    cfg = _cfg(512)
    batch = SyntheticSegmentation(2, (512, 512), seed=3).get_batch()
    out = []
    for ops in (cf.KERNEL_OPS, cf.PLAIN_OPS):
        trainer = SegmentationTrainer(
            UNetS2D(cfg, seed=1, ops=ops), device="cuda",
            train_cfg=TrainConfig(save_dir=str(tmp_path)))
        cf.reset_launches()
        cb.reset_launches()
        loss, grads = trainer.loss_and_grads(batch)
        if ops is cf.KERNEL_OPS:
            assert all(v > 0 for v in cf.launches.values()), cf.launches
            assert all(v > 0 for v in cb.launches.values()), cb.launches
        out.append((loss.item(), grads))
        del trainer
    (loss_k, g_k), (loss_p, g_p) = out
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    for k, g in g_k.items():
        a, b = g.double().flatten(), g_p[k].double().flatten()
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        rel = ((a - b).norm() / b.norm()).item()
        assert cos >= 0.999 and rel <= 5e-2, (k, cos, rel)


@pytest.mark.cuda
def test_n64_server_vs_plain(gen):
    """The bf16 server at n_kernels = 64 (512², B = 2) against the same
    model on the plain versions: every disagreeing pixel's plain logit
    margin within the bf16 tolerance, under 1 % of the pixels; every
    serving kernel mode launches."""
    from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
    from segmentation_tpu_torch.serving import Server

    cfg = _cfg(512)
    params = {k: v.cuda() for k, v in _params(cfg, 4).items()}
    x = _act(gen, 2, 512, 512, 3)
    model = UNetS2DInference(cfg)
    server = Server(model, params, model.prepare(params, dtype=torch.bfloat16,
                                                 device="cuda"))
    cf.reset_launches()
    got = server(x)
    assert all(v > 0 for k, v in cf.launches.items()
               if k not in cf.TRAIN_ONLY), cf.launches
    plain = UNetS2DInference(cfg, ops=cf.PLAIN_OPS)
    prepared = plain.prepare(params, dtype=torch.bfloat16, device="cuda")
    want = plain.apply_argmax(prepared, x)
    logits = plain.apply(prepared, x).float()
    margin = (logits[..., 1] - logits[..., 0]).abs()
    diff = got != want
    assert bool((margin[diff] <= REL_TOL * logits.abs().max()).all())
    assert diff.float().mean().item() < 0.01


# the train glue at level 2's 512-channel buffers (512², N = 1): conv2_1's
# mask, conv2_2's pool mode into the zero-margined buffer, conv8_1's and
# conv8_2's padded masks
GLUE = {"conv2_1": ((1, 126, 126, 512), {}),
        "conv2_2 pool": ((1, 125, 125, 512), {"pool": True, "pad": True}),
        "conv8_1 dual": ((1, 83, 83, 512), {"pad": True}),
        "conv8_2": ((1, 82, 82, 512), {"pad": True})}


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(GLUE))
def test_relu_bias_grad_512(gen, site):
    """gm bit for bit the plain version's, margin included; db within its
    f32 bound (train_glue.db_error_bound) of the exact sum."""
    shape, mode = GLUE[site]
    n, h, w, o4 = shape
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    y = torch.relu(torch.randn(shape, generator=gen, device="cuda")
                   ).to(torch.bfloat16)
    pool = None
    if mode.get("pool"):
        gp = torch.randn((n, h, w, o4 // 4), generator=gen,
                         device="cuda").to(torch.bfloat16)
        idx = torch.randint(0, 4, (n, h, w, o4 // 4), generator=gen,
                            device="cuda", dtype=torch.int8)
        pool = (gp, idx)
    pad = mode.get("pad", False)
    got = tg.relu_bias_grad(g, y, pool=pool, pad=pad)
    want = tg.relu_bias_grad_plain(g, y, pool=pool, pad=pad)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
    exact = want[0].double().sum((0, 1, 2))
    assert ((got[1].double() - exact).abs()
            <= tg.db_error_bound(want[0])).all()


@pytest.mark.cuda
def test_crop_margin_zero_512(gen):
    """conv8_1's skip gradient [1, 125, 125, 512] outside the crop window
    of [84, 84] packed pixels at (41, 41)."""
    buf = torch.randn((1, 125, 125, 512), generator=gen,
                      device="cuda").to(torch.bfloat16)
    want = tg.crop_margin_zero_plain(buf.clone(), 84, 84, (41, 41))
    got = tg.crop_margin_zero(buf.clone(), 84, 84, (41, 41))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
