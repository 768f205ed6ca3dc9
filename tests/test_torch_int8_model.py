"""The port's calibrated int8 U-Net (segmentation_tpu_torch/models/
unet_int8.py) against the JAX UNetS2DInt8 on CPU.

Both sides get the same float32 params and inputs, made with numpy from a
seed; the inputs are rounded to bf16 (the serving dtype) for both. The
JAX side runs its padded-flat int8 route with every Pallas kernel in
interpret mode (SEG_PALLAS_INTERPRET=1, as tests/test_unet_padflat.py
does) at 256², k = 32, where the fused level-1 chain (entry_chain_pf2)
engages; the port runs its plain versions, which
tests/test_torch_int8_kernels.py holds against those kernels.

Tolerances:
- quantized weights: bit-equal (the same numpy arithmetic);
- calibrated scales: 2e-2 relative — both calibrate on a bf16 forward,
  but the two forwards round and sum in another order;
- the whole int8 forward on JAX-prepared weights and scales
  (prepared_from_jax): masks agree on ≥ 0.99 of the pixels and logits
  correlate ≥ 0.995 — JAX's own bar between two int8 chains
  (tests/test_unet_padflat.py), since one requant step of difference
  flips near-zero margins of random weights;
- int8_conv / int8_std_dual_conv: the s32 products exact, the outputs
  within one code (or one bf16 ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from segmentation_tpu.core.config import ModelConfig as JConfig
from segmentation_tpu.models import unet_fast as jfast
from segmentation_tpu.models import unet_int8 as jq
from segmentation_tpu_torch import interop
from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.models import unet_int8 as tq
from segmentation_tpu_torch.models.unet import unet_param_shapes
from segmentation_tpu_torch.models.unet_fast import UNetS2D, UNetS2DInference
from segmentation_tpu_torch.nn.kernels import conv_int8 as tci

HW = 256
_DN = ("NHWC", "HWIO", "NHWC")


def _np_params(cfg, seed=0):
    """Xavier-uniform weights and small random biases, by JAX name."""
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


def _bf16_input(seed, hw=HW, b=1):
    """Inputs as the serving path sees them: bf16 values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 0.25, (b, hw, hw, 3)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _jx(xb):
    return jnp.asarray(xb.float().numpy(), jnp.bfloat16)


@pytest.fixture(scope="module")
def case():
    """JAX: prepare with one calibration batch, then the padflat int8
    logits and masks (interpret mode)."""
    cfg = ModelConfig(n_classes=2, input_dims=(HW, HW), n_kernels=32)
    params = _np_params(cfg)
    x, calib = _bf16_input(2), _bf16_input(3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEG_PALLAS_INTERPRET", "1")
        q = jq.UNetS2DInt8(JConfig(n_classes=2, input_dims=(HW, HW),
                                   n_kernels=32))
        jprep = q.prepare({k: jnp.asarray(v) for k, v in params.items()},
                          calib_batches=[_jx(calib)])
        assert q._pf_supported(jprep, _jx(x))
        assert q._pf_entry_chain(jprep, "conv1_1", "conv1_2",
                                 _jx(x)) is not None
        logits = np.asarray(q.apply(jprep, _jx(x)), np.float32)
        mask = np.asarray(q.apply_argmax(jprep, _jx(x)))
    return dict(cfg=cfg, params=params, x=x, calib=calib, q=q,
                jprep=jprep, logits=logits, mask=mask)


@pytest.fixture(scope="module")
def port_prep(case):
    model = tq.UNetS2DInt8(case["cfg"], ops8=tci.PLAIN_OPS)
    params = interop.params_from_jax(case["params"])
    return model, model.prepare(params, calib_batches=[case["calib"]])


def test_quantized_weights_match_jax(case, port_prep):
    _, prep = port_prep
    jkeys = {k for k in case["jprep"] if "/wq" in k or "/wscale" in k}
    assert jkeys == {k for k in prep if "/wq" in k or "/wscale" in k}
    for k in sorted(jkeys):
        want = np.asarray(case["jprep"][k])
        got = prep[k].numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_calibrated_scales_match_jax(case, port_prep):
    _, prep = port_prep
    jkeys = {k for k in case["jprep"] if "/ascale" in k}
    assert jkeys == {k for k in prep if "/ascale" in k}
    assert len(jkeys) == 24  # every site of the flagship topology
    for k in sorted(jkeys):
        want = float(case["jprep"][k])
        np.testing.assert_allclose(float(prep[k]), want, rtol=2e-2,
                                   err_msg=k)


def test_scale_graph_matches_jax(case):
    """Each site stores its output at its consumer's scale (skips at the
    next level's), as JAX's _out_scale_of / _skip_scale_of say."""
    model = tq.UNetS2DInt8(case["cfg"])
    prep = interop.prepared_from_jax(case["jprep"], model)
    names = {k.rsplit("/", 1)[0] for k in prep if "/" in k}
    for name in sorted(n for n in names if n.startswith(("conv", "upconv"))):
        assert model._out_scale_of(prep, name) == \
            case["q"]._out_scale_of(case["jprep"], name), name
    for name in ("conv6_1", "conv7_1", "conv8_1", "conv9_1"):
        assert model._skip_scale_of(prep, name) == \
            case["q"]._skip_scale_of(case["jprep"], name), name
    assert model._out_scale_of(prep, "conv5_2") is None
    assert model._out_scale_of(prep, "conv6_2") is None
    assert model._out_scale_of(prep, "conv9_2") is None


@pytest.mark.parametrize("quant_deconvs", [True, False])
@pytest.mark.parametrize("levels", [2, 3, 4, 5])
def test_site_table_matches_jax(levels, quant_deconvs):
    """The site table (``UNetS2DInference.sites``) lists the sites of the
    JAX UNetS2DInt8's name walks, and the int8 scale graph read off its
    consumers and skips stores each output where JAX's _out_scale_of and
    _skip_scale_of say: every scale key a site could read holds its own
    value here."""
    cfg = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=4)
    model = tq.UNetS2DInt8(cfg, levels=levels, quant_deconvs=quant_deconvs)
    ref = jq.UNetS2DInt8(JConfig(n_classes=2, input_dims=(188, 188),
                                 n_kernels=4),
                         levels=levels, quant_deconvs=quant_deconvs)
    s = model.sites
    entry, packed = ref._packed_conv_names()
    assert list(s.entry) == entry
    assert sorted(s.packed + s.dual) == sorted(packed)
    assert list(s.dual) == ref._dual_conv_names()
    assert list(s.std) == ref._std_conv_names()
    assert list(s.std_dual) == ref._std_dual_names()
    assert list(model._int8_ups) == ref._deconv_names()
    assert len(s.ups) == len(s.dual)
    names = [n for pair in s.encoder for n in pair] + [
        n for _, up, c1, c2 in s.decoder for n in (up, c1, c2)]
    assert len(names) == len(set(names)) == 5 * levels + 2
    keys = [f"{n}/ascale{side}" for n in names for side in ("", "_a", "_b")]
    p = {k: float(i + 1) for i, k in enumerate(keys)}
    for name in names:
        assert model._out_scale_of(p, name) == ref._out_scale_of(p, name), \
            name
    for name in s.dual + s.std_dual:
        assert model._skip_scale_of(p, name) == ref._skip_scale_of(p, name)


def test_prepare_packs_as_packed_and_quantizes_as_jax():
    """One packer: the serving prepare's packed weights and tiled biases
    are UNetS2D.packed()'s, detached and cast, bit for bit (f32 and bf16);
    the int8 prepare's codes and scales are JAX's _quantize_weight /
    _quantize_matrix of JAX's numpy packers, at the sites JAX names."""
    cfg = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=4)
    params = _np_params(cfg)
    tparams = interop.params_from_jax(params)
    want = UNetS2D(cfg, params=tparams).packed()
    packed_keys = [k for k in want if k not in params]
    # 2 w4, 4 w2, 2 pairs w2a / w2b, 2 wm and the ten sites' b4
    assert len(packed_keys) == 2 + 4 + 4 + 2 + 10
    for dtype in (torch.float32, torch.bfloat16):
        got = UNetS2DInference(cfg).prepare(tparams, dtype=dtype)
        for k in packed_keys:
            dt = torch.float32 if k.endswith("/b4") else dtype
            assert got[k].dtype == dt, k
            assert torch.equal(got[k], want[k].detach().to(dt)), k

    ref = jq.UNetS2DInt8(JConfig(n_classes=2, input_dims=(188, 188),
                                 n_kernels=4))
    jwant = {}

    def quantized(name, wq_key, ws_key, wq_ws):
        jwant[f"{name}/{wq_key}"], jwant[f"{name}/{ws_key}"] = wq_ws

    entry, packed = ref._packed_conv_names()
    duals = ref._dual_conv_names()
    for name in entry:
        quantized(name, "wq4", "wscale4", jq._quantize_weight(
            jfast.pack_conv3_weight_s2(params[f"{name}/w"])))
    for name in packed:
        w = params[f"{name}/w"]
        if name not in duals:
            quantized(name, "wq", "wscale",
                      jq._quantize_weight(jfast.pack_conv3_weight(w)))
            continue
        ci = w.shape[2] // 2
        quantized(name, "wq_a", "wscale_a",
                  jq._quantize_weight(jfast.pack_conv3_weight(w[:, :, :ci])))
        quantized(name, "wq_b", "wscale_b",
                  jq._quantize_weight(jfast.pack_conv3_weight(w[:, :, ci:])))
    for name in ref._std_conv_names():
        quantized(name, "wq", "wscale",
                  jq._quantize_weight(params[f"{name}/w"]))
    for name in ref._std_dual_names():
        w = params[f"{name}/w"]
        ci = w.shape[2] // 2
        quantized(name, "wq_a", "wscale_a", jq._quantize_weight(w[:, :, :ci]))
        quantized(name, "wq_b", "wscale_b", jq._quantize_weight(w[:, :, ci:]))
    for name in ref._deconv_names():
        w = params[f"{name}/w"]
        wm = np.transpose(w, (2, 0, 1, 3)).reshape(w.shape[2], -1)
        quantized(name, "wqm", "wscale", jq._quantize_matrix(wm))
    prep = tq.UNetS2DInt8(cfg).prepare(tparams)
    assert set(jwant) == {k for k in prep if "/wq" in k or "/wscale" in k}
    for k, v in jwant.items():
        assert prep[k].dtype == torch.from_numpy(v).dtype, k
        np.testing.assert_array_equal(prep[k].numpy(), v, err_msg=k)


def test_int8_forward_matches_jax(case):
    """The whole padflat int8 route, on the JAX-prepared weights and
    scales carried by prepared_from_jax."""
    model = tq.UNetS2DInt8(case["cfg"], ops8=tci.PLAIN_OPS)
    prep = interop.prepared_from_jax(case["jprep"], model)
    assert not any(k.endswith(("/we", "/wh", "/wl")) for k in prep)
    assert prep["conv2_2/wq"].dtype == torch.int8
    logits = model.apply(prep, case["x"]).float().numpy()
    want = case["logits"]
    assert logits.shape == want.shape
    agree = (logits.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.99, agree
    corr = np.corrcoef(logits.ravel(), want.ravel())[0, 1]
    assert corr >= 0.995, corr
    mask = model.apply_argmax(prep, case["x"]).numpy()
    assert mask.dtype == np.uint8 and mask.shape == case["mask"].shape
    assert (mask == case["mask"]).mean() >= 0.99


def test_port_calibrated_forward_tracks_jax(case, port_prep):
    """The port's own prepare (its calibration) end to end."""
    model, prep = port_prep
    mask = model.apply_argmax(prep, case["x"]).numpy()
    assert (mask == case["mask"]).mean() >= 0.99


def test_uncalibrated_int8_is_the_bf16_forward():
    """prepare() without calibration batches quantizes no activation: the
    forward is the bf16 s2d forward (the JAX class behaves so too)."""
    cfg = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=4)
    params = interop.params_from_jax(_np_params(cfg, seed=4))
    x = _bf16_input(5, hw=188)
    q = tq.UNetS2DInt8(cfg)
    prep = q.prepare(params)
    assert not any("ascale" in k for k in prep)
    ref = UNetS2DInference(cfg)
    want = ref.apply(ref.prepare(params, dtype=torch.bfloat16), x)
    assert torch.equal(q.apply(prep, x), want)


# ------------------------------------------------ std-level int8 convs
def _s8(rng, *shape, lo=-127):
    return rng.integers(lo, 128, size=shape).astype(np.int8)


def _jconv_s32(x, w):
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "VALID",
        dimension_numbers=_DN, preferred_element_type=jnp.int32))


def _close(got, want):
    got, want = torch.as_tensor(got), np.asarray(want)
    if got.dtype == torch.int8:
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    else:
        w32 = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), w32, rtol=0,
                                   atol=2.0**-7 * np.abs(w32).max())


@pytest.mark.parametrize("out_scale", [None, 0.03])
@pytest.mark.parametrize("resident", [True, False])
def test_int8_conv_matches_jax(np_rng, out_scale, resident):
    c, o = 64, 128
    x = (_s8(np_rng, 2, 9, 10, c, lo=0) if resident
         else np_rng.random((2, 9, 10, c)).astype(np.float32))
    wq, ws = tq.quantize_weight(np_rng.normal(0, 0.1, (3, 3, c, o)))
    b = np_rng.normal(0, 0.05, o).astype(np.float32)
    act = 0.7 / 127
    xj = jnp.asarray(x) if resident else jnp.asarray(x, jnp.bfloat16)
    xt = (torch.from_numpy(x) if resident
          else torch.from_numpy(x).to(torch.bfloat16))
    if resident:  # the s32 product is exact
        np.testing.assert_array_equal(
            tci.conv3x3_s8_plain(xt, torch.from_numpy(wq)).numpy(),
            _jconv_s32(x, wq))
    want = jq.int8_conv(xj, jnp.asarray(wq), jnp.asarray(ws),
                        jnp.float32(act), jnp.asarray(b),
                        out_scale=out_scale)
    got = tq.int8_conv(xt, torch.from_numpy(wq), torch.from_numpy(ws), act,
                       torch.from_numpy(b), out_scale=out_scale)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got, want)


@pytest.mark.parametrize("out_scale", [None, 0.05])
def test_int8_std_dual_conv_matches_jax(np_rng, out_scale):
    c = 32
    sk = _s8(np_rng, 1, 10, 10, c, lo=0)
    up = np_rng.random((1, 10, 10, c)).astype(np.float32) * 2
    w = np_rng.normal(0, 0.1, (3, 3, 2 * c, c)).astype(np.float32)
    (wqa, wsa), (wqb, wsb) = (tq.quantize_weight(w[:, :, :c]),
                              tq.quantize_weight(w[:, :, c:]))
    b = np_rng.normal(0, 0.05, c).astype(np.float32)
    sks, asb = 0.9 / 127, 2.0 / 127
    want = jq.int8_std_dual_conv(
        jnp.asarray(sk), jnp.asarray(up, jnp.bfloat16), jnp.asarray(wqa),
        jnp.asarray(wsa), sks, jnp.asarray(wqb), jnp.asarray(wsb), asb,
        jnp.asarray(b), out_scale=out_scale)
    got = tq.int8_std_dual_conv(
        torch.from_numpy(sk), torch.from_numpy(up).to(torch.bfloat16),
        torch.from_numpy(wqa), torch.from_numpy(wsa), sks,
        torch.from_numpy(wqb), torch.from_numpy(wsb), asb,
        torch.from_numpy(b), out_scale=out_scale)
    _close(got, want)


def test_quantize_helpers_match_jax(np_rng):
    w = np_rng.normal(0, 0.1, (2, 2, 8, 16)).astype(np.float32)
    w[..., 3] = 0.0  # the 1e-8 floor
    for got, want in zip(tq.quantize_weight(w), jq._quantize_weight(w)):
        np.testing.assert_array_equal(got, want)
    m = np_rng.normal(0, 0.1, (8, 16)).astype(np.float32)
    for got, want in zip(tq.quantize_weight(m), jq._quantize_matrix(m)):
        np.testing.assert_array_equal(got, want)
    x = np_rng.normal(0, 1, (2, 5, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tq.quant_act(torch.from_numpy(x), 0.01).numpy(),
        np.asarray(jq._quant_act(jnp.asarray(x), jnp.float32(0.01))))
