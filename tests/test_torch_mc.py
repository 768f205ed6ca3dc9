"""The Bayesian U-Net's MC-dropout forward on the CPU (the plain versions),
and its kernels on the card.

The mask stream (nn/mc_mask.py) is a counter-based hash of (seed, site,
sample, tile, y, x, c): reproducible, a keep share within binomial
bounds, and each site's bits unrelated to the other site's and to the
sample's. The MC server (``serving.MCServer`` over
``UNetS2DInference.apply_mc`` on ``PLAIN_OPS``) draws the same bits as the
plain U-Net (models/unet.py ``forward(masks=...)`` and ``mc_moments``)
and must equal it per sample and in the mean, the variance and the map,
in f32 on seeded weights at 204² (``n_kernels`` 8, B = 2 tiles, S = 3
samples): its shared encoder with one decoder at S·B equals S whole
forwards with the same masks; at rate 0 it is the deterministic model.
The JAX package's UNetS2DInference, with ``dropout_fn`` injecting the same
masks, agrees. The kernels' own tests are tests/test_torch_mc_cuda.py.
Tolerances: f32 everywhere; the packed forward reassociates every conv,
so logits agree to 1e-3 (tests/test_torch_unet_fast.py) and
probabilities, whose sigmoid has slope at most 1/4, to 5e-4; a class may
differ only where the reference's mean margin is under 1e-3.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_tpu.core.config import ModelConfig as JConfig
from segmentation_tpu.models import unet_fast as jfast
from segmentation_tpu_torch import interop, serving
from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.models import unet_fast as tfast
from segmentation_tpu_torch.models.unet import (
    UNet,
    mc_moments,
    unet_param_shapes,
)
from segmentation_tpu_torch.nn import mc_mask
from segmentation_tpu_torch.nn.kernels import conv_flat as cf
from segmentation_tpu_torch.nn.packing import pack2, unpack2

HW, K, B, S = 204, 8, 2, 3
SEED = 2**33 + 2**31 + 12345  # both words of the mask seed in use
PROB_TOL = 5e-4
BOTTLENECK, HEAD = mc_mask.SITES["bottleneck"], mc_mask.SITES["head"]


def _np_params(cfg, seed=0):
    """Xavier-uniform weights and small random biases, by name."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in unet_param_shapes(cfg):
        if name.endswith("/w"):
            fan_in = int(np.prod(shape[:-1]))
            fan_out = int(np.prod(shape[:-2])) * shape[-1]
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            out[name] = rng.uniform(-lim, lim, shape).astype(np.float32)
        else:
            out[name] = rng.normal(0, 0.05, shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def mc():
    cfg = ModelConfig(n_classes=2, input_dims=(HW, HW), n_kernels=K,
                      bayesian=True)
    params_np = _np_params(cfg, seed=4)
    params = interop.params_from_jax(params_np)
    x = torch.from_numpy(np.random.default_rng(5).random(
        (B, HW, HW, 3)).astype(np.float32))
    model = tfast.UNetS2DInference(cfg, ops=cf.PLAIN_OPS)
    prepared = model.prepare(params)
    server = serving.MCServer(model, params, prepared, S)
    return cfg, params_np, params, x, model, prepared, server


def _site_shapes(model, prepared, x):
    """The unpacked [H, W, C] of the bottleneck's and conv9_2's outputs."""
    enc = model._encode(prepared, x)
    bottleneck = tuple(enc[-1].shape[1:])
    h4 = model._decode(prepared, enc, packed_out=True)
    n, hp, wp, c4 = h4.shape
    return bottleneck, (2 * hp, 2 * wp, c4 // 4)


def _masks(shapes, s):
    """Sample s's (bottleneck, decoder-end) multipliers [B, H, W, C]."""
    return tuple(
        torch.stack([mc_mask.multiplier(SEED, site, s, n, shape, 0.5)
                     for n in range(B)])
        for site, shape in zip((BOTTLENECK, HEAD), shapes))


def _reference(mc):
    """The plain U-Net's S sampled probabilities [S, B, h, w, 2]."""
    cfg, _, params, x, model, prepared, _ = mc
    net = UNet(cfg, params=params)
    shapes = _site_shapes(model, prepared, x)
    with torch.no_grad():
        return torch.stack([torch.sigmoid(net(x, _masks(shapes, s)))
                            for s in range(S)])


# ------------------------------------------------------------ mask stream
def test_the_mask_stream_is_reproducible():
    shape = (9, 11, 32)
    a = mc_mask.multiplier(SEED, HEAD, 2, 1, shape, 0.5)
    assert torch.equal(a, mc_mask.multiplier(SEED, HEAD, 2, 1, shape, 0.5))
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert not torch.equal(a, mc_mask.multiplier(SEED + 1, HEAD, 2, 1,
                                                 shape, 0.5))
    assert not torch.equal(a, mc_mask.multiplier(SEED + 2**32, HEAD, 2, 1,
                                                 shape, 0.5))
    # the bits are a function of (y, x, c) alone: a smaller activation is
    # not a crop of a larger one's (W and C enter the counter), but one
    # stream's element is the same wherever the activation is drawn
    full = mc_mask.batch_multiplier(SEED, HEAD, 3, 2, shape, 0.5)
    assert torch.equal(full[2 * 2 + 1], a)
    assert mc_mask.threshold(0.5) == 128 and mc_mask.keep_scale(0.5) == 2.0
    with pytest.raises(ValueError):
        mc_mask.threshold(0.3)
    with pytest.raises(ValueError):
        mc_mask.split_seed(-1)


@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_the_keep_share_is_binomial(rate):
    n = 64 * 64 * 128
    m = mc_mask.multiplier(SEED, BOTTLENECK, 0, 0, (64, 64, 128), rate)
    kept = int((m > 0).sum())
    p = 1 - rate
    assert abs(kept - n * p) < 5 * math.sqrt(n * p * (1 - p)), kept / n
    assert float(m.max()) == np.float32(1 / p)
    # per channel, the share is the same: no channel is favoured
    share = (m > 0).float().mean(dim=(0, 1))
    assert (share - p).abs().max() < 5 * math.sqrt(p * (1 - p) / 4096)


def _agreement(a, b):
    return float(((a > 0) == (b > 0)).float().mean())


def test_each_site_and_sample_draws_its_own_bits():
    """Two streams that differ by the site, the sample or the tile agree on
    half the bits (independent coins), within binomial bounds."""
    shape = (48, 48, 64)
    n = math.prod(shape)
    base = mc_mask.multiplier(SEED, BOTTLENECK, 0, 0, shape, 0.5)
    others = {"site": (HEAD, 0, 0), "sample": (BOTTLENECK, 1, 0),
              "tile": (BOTTLENECK, 0, 1), "sample 7": (BOTTLENECK, 7, 1)}
    for what, (site, s, t) in others.items():
        other = mc_mask.multiplier(SEED, site, s, t, shape, 0.5)
        assert abs(_agreement(base, other) - 0.5) < 5 * 0.5 / math.sqrt(n), \
            what
    # neighbours within one stream are unrelated too
    assert abs(_agreement(base[:, :, :-1], base[:, :, 1:]) - 0.5) < 0.01
    assert abs(_agreement(base[:, :-1], base[:, 1:]) - 0.5) < 0.01


# ------------------------------------------------------------- the server
def _per_sample(mc):
    """The MC path's S·B sampled probabilities, as apply_mc computes them
    before the moments, unpacked to [S, B, h, w, 2]."""
    cfg, _, _, x, model, prepared, _ = mc
    rate = cfg.dropout_rate
    enc = model._encode(prepared, x)
    enc.append(model.ops.mc_fanout(enc.pop(), seed=SEED, samples=S,
                                   rate=rate))
    probs = model._decode(prepared, enc, mc=(SEED, B, rate))
    n, hp, wp, _ = probs.shape
    return unpack2(probs.view(n, hp, wp, 4, 2)).view(S, B, 2 * hp, 2 * wp, 2)


def test_the_mc_server_equals_the_plain_reference(mc):
    *_, server = mc
    want = _reference(mc)
    got = _per_sample(mc)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=PROB_TOL, rtol=0)
    mean, var, cmap = server(SEED, mc[3])
    w_mean, w_var, w_map = mc_moments(want)
    assert mean.dtype == var.dtype == torch.float32
    assert cmap.dtype == torch.uint8 and cmap.shape == w_map.shape
    torch.testing.assert_close(mean, w_mean, atol=PROB_TOL, rtol=0)
    torch.testing.assert_close(var, w_var, atol=PROB_TOL, rtol=0)
    assert float(w_var.mean()) > 1e-5  # the masks move the answer
    margin = (w_mean[..., 1] - w_mean[..., 0]).abs()
    assert (margin[cmap != w_map] < 1e-3).all()


def test_one_decoder_at_s_b_is_s_whole_forwards(mc):
    """S whole forwards of the port (the encoder each time, the decoder at
    B, each sample's masks applied by hand) give the shared-encoder, S·B
    decoder path's probabilities."""
    cfg, _, _, x, model, prepared, _ = mc
    shapes = _site_shapes(model, prepared, x)
    w, b = prepared["output/w"][0, 0], prepared["output/b"]
    whole = []
    for s in range(S):
        m_b, m_h = _masks(shapes, s)
        enc = model._encode(prepared, x)
        enc.append(enc.pop() * m_b)
        h4 = model._decode(prepared, enc, packed_out=True)
        n, hp, wp, c4 = h4.shape
        y = tfast.unpack2(h4.view(n, hp, wp, 4, c4 // 4)) * m_h
        whole.append(torch.sigmoid(y @ w + b))
    torch.testing.assert_close(_per_sample(mc), torch.stack(whole),
                               atol=1e-6, rtol=0)


def test_rate_zero_is_the_deterministic_model(mc):
    _, _, params, x, model, prepared, _ = mc
    cfg0 = ModelConfig(n_classes=2, input_dims=(HW, HW), n_kernels=K,
                       bayesian=True, dropout_rate=0.0)
    mean, var, cmap = tfast.UNetS2DInference(
        cfg0, ops=cf.PLAIN_OPS).apply_mc(prepared, x, SEED, S)
    assert float(var.abs().max()) < 1e-12
    logits = model.apply(prepared, x)
    torch.testing.assert_close(mean, torch.sigmoid(logits), atol=1e-6,
                               rtol=0)
    margin = (logits[..., 1] - logits[..., 0]).abs()
    assert (margin[cmap != model.apply_argmax(prepared, x)] < 1e-5).all()


def test_the_deterministic_forward_is_unchanged(mc):
    """A bayesian config serves the deterministic forward unchanged: the
    same logits and class map, bit for bit, as the plain config's model
    on the same weights; the plain U-Net with all-ones masks is the plain
    U-Net."""
    cfg, _, params, x, model, prepared, _ = mc
    plain_cfg = ModelConfig(n_classes=2, input_dims=(HW, HW), n_kernels=K)
    det = tfast.UNetS2DInference(plain_cfg, ops=cf.PLAIN_OPS)
    dp = det.prepare(params)
    assert set(prepared) - set(dp) == {"head/wh", "head/bh"}
    assert torch.equal(model.apply(prepared, x), det.apply(dp, x))
    assert torch.equal(model.apply_argmax(prepared, x),
                       det.apply_argmax(dp, x))
    net = UNet(cfg, params=params)
    shapes = _site_shapes(model, prepared, x)
    ones = tuple(torch.ones((B, *s)) for s in shapes)
    with torch.no_grad():
        assert torch.equal(net(x, ones), net(x))


def test_the_mc_entry_on_cpu():
    server, (x0,) = serving.entry("cpu", batch=2, mc_samples=8)
    assert isinstance(server, serving.MCServer) and server.samples == 8
    assert tuple(x0.shape) == (2, 1024, 1024, 3)
    assert server.model.cfg.bayesian and server.model.cfg.dropout_rate == 0.5
    assert server.prepared["head/wh"].shape == (32, 2)
    assert server.prepared["head/wh"].dtype == torch.bfloat16
    assert server.prepared["head/bh"].dtype == torch.float32
    assert server.model.output_hw((1024, 1024)) == (836, 836)


def test_the_mc_path_matches_jax_with_the_same_masks(mc):
    """JAX UNetS2DInference (its 4-D XLA route) with ``dropout_fn`` putting
    the same multipliers at its two MC sites (the bottleneck, and the
    packed decoder end), sample by sample."""
    cfg, params_np, _, x, model, prepared, _ = mc
    jcfg = JConfig(n_classes=2, input_dims=(HW, HW), n_kernels=K,
                   bayesian=True)
    oracle = jfast.UNetS2DInference(jcfg, allow_pallas=False, padflat=False)
    jprep = oracle.prepare({k: jnp.asarray(v) for k, v in params_np.items()})

    def run(p, xx, m_b, m_h):
        def drop(h):
            return h * (m_b if h.shape == m_b.shape else m_h)

        net = jfast.UNetS2DInference(jcfg, allow_pallas=False, padflat=False,
                                     dropout_fn=drop)
        return jax.nn.sigmoid(net.apply(p, xx))

    jrun = jax.jit(run)
    shapes = _site_shapes(model, prepared, x)
    want = []
    for s in range(S):
        m_b, m_h = _masks(shapes, s)
        n, hh, ww, c = m_h.shape
        m_h4 = pack2(m_h).reshape(n, hh // 2, ww // 2, 4 * c)
        want.append(np.asarray(jrun(jprep, jnp.asarray(x.numpy()),
                                    jnp.asarray(m_b.numpy()),
                                    jnp.asarray(m_h4.numpy()))))
    want = torch.from_numpy(np.stack(want))
    torch.testing.assert_close(_per_sample(mc), want, atol=PROB_TOL, rtol=0)
    w_mean, w_var, _ = mc_moments(want)
    mean, var, _ = model.apply_mc(prepared, x, SEED, S)
    torch.testing.assert_close(mean, w_mean, atol=PROB_TOL, rtol=0)
    torch.testing.assert_close(var, w_var, atol=PROB_TOL, rtol=0)
