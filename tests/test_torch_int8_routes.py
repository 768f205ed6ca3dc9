"""The port's two further int8 configurations of UNetS2DInt8 against the
JAX class on CPU, and the bf16 forward against the JAX 4-D route:

- ``padflat=False``: the JAX 4-D int8 route (UNetS2DInference.apply with
  the int8 hooks): conv1_1 in bf16 then quantized, bf16 packed-decoder
  deconvs on dequantized inputs, duals quantizing their bf16 up side
  inline with the skip crop folded in;
- ``quant_deconvs=False``: the padded-flat int8 route with bf16
  packed-decoder deconvs.

Both packages run on the same quantized weights and scales: JAX prepares
(calibrating on one seeded batch) and interop.prepared_from_jax carries
the dict over. The JAX side runs every Pallas kernel in interpret mode
(SEG_PALLAS_INTERPRET=1, as tests/test_unet_padflat.py does) at its
tests' sizes, 204² (no paired-column level 1) and 244² (paired), k = 32;
the port runs its plain versions, which tests/test_torch_int8_inline.py
holds against those kernels. Bars: masks agree on ≥ 0.99 of the pixels
and logits correlate ≥ 0.995, JAX's own bar between two int8 chains
(tests/test_unet_padflat.py), since one requant step of difference flips
near-zero margins of random weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_tpu.core.config import ModelConfig as JConfig
from segmentation_tpu.models import unet_fast as jfast
from segmentation_tpu.models import unet_int8 as jq
from segmentation_tpu_torch import interop
from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.models import unet_int8 as tq
from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
from segmentation_tpu_torch.nn.kernels import conv_flat as tcf
from segmentation_tpu_torch.nn.kernels import conv_int8 as tci
from test_torch_int8_model import _bf16_input, _jx, _np_params

CONFIGS = {"4d": {"padflat": False}, "fdeconv": {"quant_deconvs": False}}


@pytest.fixture(scope="module", params=[204, 244])
def case(request):
    """Per size: the params, the input, and for each configuration JAX's
    prepared dict, logits and masks (interpret mode)."""
    hw = request.param
    cfg = ModelConfig(n_classes=2, input_dims=(hw, hw), n_kernels=32)
    jcfg = JConfig(n_classes=2, input_dims=(hw, hw), n_kernels=32)
    params = _np_params(cfg)
    x, calib = _bf16_input(2, hw), _bf16_input(3, hw)
    out = dict(hw=hw, cfg=cfg, params=params, x=x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEG_PALLAS_INTERPRET", "1")
        for tag, kw in CONFIGS.items():
            q = jq.UNetS2DInt8(jcfg, **kw)
            jprep = q.prepare({k: jnp.asarray(v) for k, v in params.items()},
                              calib_batches=[_jx(calib)])
            assert q._pf_supported(jprep, _jx(x)) == q.padflat
            out[tag] = dict(
                q=q, jprep=jprep,
                logits=np.asarray(q.apply(jprep, _jx(x)), np.float32),
                mask=np.asarray(q.apply_argmax(jprep, _jx(x))))
        oracle = jfast.UNetS2DInference(jcfg, padflat=False)
        jp = oracle.prepare({k: jnp.asarray(v) for k, v in params.items()})
        out["bf16"] = np.asarray(oracle.apply(jp, _jx(x)), np.float32)
    return out


def _recording(ops, calls, tag):
    """``ops`` (a NamedTuple of functions) with each call recorded as
    (tag:field, the keyword arguments that pick its mode, input dtype)."""
    def wrap(name, fn):
        def call(*args, **kw):
            mode = {k: v for k, v in kw.items()
                    if k in ("pool", "scatter", "act_scale", "act_scale_a",
                             "act_scale_b", "offset") and v is not None}
            calls.append((f"{tag}:{name}", mode, args[0].dtype))
            return fn(*args, **kw)
        return call

    return type(ops)(*(wrap(n, f) for n, f in zip(ops._fields, ops)))


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_int8_route_matches_jax(case, tag):
    """The whole forward of each configuration, logits and fused-head
    masks, on the JAX-prepared weights and scales."""
    want = case[tag]
    model = tq.UNetS2DInt8(case["cfg"], ops8=tci.PLAIN_OPS, **CONFIGS[tag])
    prep = interop.prepared_from_jax(want["jprep"], model)
    assert any(k.endswith("/wqm") for k in prep) == model.quant_deconvs
    logits = model.apply(prep, case["x"]).float().numpy()
    assert logits.shape == want["logits"].shape
    agree = (logits.argmax(-1) == want["logits"].argmax(-1)).mean()
    corr = np.corrcoef(logits.ravel(), want["logits"].ravel())[0, 1]
    assert agree >= 0.99, agree
    assert corr >= 0.995, corr
    mask = model.apply_argmax(prep, case["x"]).numpy()
    assert mask.dtype == np.uint8 and mask.shape == want["mask"].shape
    assert (mask == want["mask"]).mean() >= 0.99


def test_port_calibration_tracks_jax(case):
    """The port's own prepare and calibration, end to end, for both
    configurations (its scales are JAX's within the bf16 forwards'
    rounding: tests/test_torch_int8_model.py)."""
    params = interop.params_from_jax(case["params"])
    calib = _bf16_input(3, case["hw"])
    for tag, kw in CONFIGS.items():
        model = tq.UNetS2DInt8(case["cfg"], ops8=tci.PLAIN_OPS, **kw)
        prep = model.prepare(params, calib_batches=[calib])
        jkeys = {k for k in case[tag]["jprep"] if "/ascale" in k}
        assert jkeys == {k for k in prep if "/ascale" in k}, tag
        mask = model.apply_argmax(prep, case["x"]).numpy()
        assert (mask == case[tag]["mask"]).mean() >= 0.99, tag


@pytest.mark.parametrize("padflat", [True, False])
def test_bf16_forward_matches_jax_4d(case, padflat):
    """UNetS2DInference computes one bf16 function for either padflat:
    both values against the JAX 4-D route, in bf16 (k = 32, interpret
    mode). Each side rounds ~18 convs to bf16 in its own order: logits
    within 5e-2 of the largest, masks ≥ 0.99."""
    model = UNetS2DInference(case["cfg"], padflat=padflat,
                             ops=tcf.PLAIN_OPS)
    prep = model.prepare(interop.params_from_jax(case["params"]),
                         dtype=torch.bfloat16)
    got = model.apply(prep, case["x"]).float().numpy()
    want = case["bf16"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def test_level1_gate_is_jax_route_choice(case):
    """Where the JAX padded-flat route fuses level 1 (its paired-column
    gate and the fused chain's width gate), the port runs H5; elsewhere
    both run conv1_1 in bf16, quantize, then conv1_2 in s8."""
    q = case["fdeconv"]["q"]
    model = tq.UNetS2DInt8(case["cfg"], quant_deconvs=False)
    for h, w in [(204, 204), (244, 244), (256, 256), (512, 512), (256, 384),
                 (260, 512), (512, 260), (388, 388), (768, 640)]:
        x = jnp.zeros((1, h, w, 3), jnp.bfloat16)
        jax_fuses = q._pf2_ok(x) and w % 4 == 0 and (w // 4) % 32 == 0
        assert model._fused_level1(torch.zeros(1, h, w, 3)) == jax_fuses
    assert not tq.UNetS2DInt8(case["cfg"], padflat=False)._fused_level1(
        torch.zeros(1, 512, 512, 3))


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_route_runs_the_configurations_modes(case, tag):
    """Which kernel mode each site of a configuration takes (on the plain
    versions, recorded): no packed site falls back, the former
    NotImplementedError is gone."""
    calls = []
    model = tq.UNetS2DInt8(case["cfg"],
                           ops=_recording(tcf.PLAIN_OPS, calls, "bf16"),
                           ops8=_recording(tci.PLAIN_OPS, calls, "s8"),
                           **CONFIGS[tag])
    prep = interop.prepared_from_jax(case[tag]["jprep"], model)
    model.apply_argmax(prep, case["x"])
    s8, bf16 = torch.int8, torch.bfloat16
    duals = [m for n, m, _ in calls if n == "s8:packed_conv2x2_dual"]
    assert len(duals) == 2
    assert all(m["act_scale_b"] > 0 and "act_scale_a" not in m
               for m in duals)
    # the deconvs run in bf16 on bf16 inputs
    assert [(n, d) for n, _, d in calls if n.endswith("rows_matmul")] == \
        [("bf16:rows_matmul", bf16)] * 2
    # level 1 (neither size passes the fusion gate), then level 2
    assert not any(n == "s8:entry_chain" for n, _, _ in calls)
    assert calls[:4] == [("bf16:strided_conv4x4s2", {}, bf16),
                         ("s8:packed_conv2x2", {"pool": True}, s8),
                         ("s8:strided_conv4x4s2", {}, s8),
                         ("s8:packed_conv2x2", {"pool": True}, s8)]
    # no other bf16 packed site
    assert sum(n.startswith("bf16:") for n, _, _ in calls) == 3


def test_bf16_at_an_int8_site_without_scale_raises(case):
    """Only a dual's up side is ever a float operand (a bf16 deconv's
    output), quantized as the kernel loads it at its calibrated scale; a
    float tensor at any other int8 packed site raises in the wrapper, on
    the CPU as on the card."""
    model = tq.UNetS2DInt8(case["cfg"], padflat=False)
    prep = interop.prepared_from_jax(case["4d"]["jprep"], model)
    h4 = torch.rand((1, 20, 20, 256)).bfloat16()
    with pytest.raises(TypeError, match="act_scale"):
        model._packed_conv(prep, "conv8_2", h4)
    with pytest.raises(TypeError, match="act_scale"):
        tci.packed_conv2x2_s8(h4, prep["conv8_2/wq"], prep["conv8_2/qmul"],
                              prep["conv8_2/qadd"])


def test_prepared_from_jax_keeps_the_deconv_quantization(case):
    """A dict prepared with quant_deconvs=False has no wqm: it serves only
    a model built so, and the other way round."""
    with pytest.raises(ValueError, match="quant_deconvs"):
        interop.prepared_from_jax(case["fdeconv"]["jprep"],
                                  tq.UNetS2DInt8(case["cfg"]))
    with pytest.raises(ValueError, match="quant_deconvs"):
        interop.prepared_from_jax(
            case["4d"]["jprep"],
            tq.UNetS2DInt8(case["cfg"], quant_deconvs=False))
