"""The port's trainable U-Net (UNetS2D) against the JAX package's on CPU.

Both packages get the same float32 params and the same batches (made with
numpy, or drawn from the shared synthetic generator). The whole forward
runs in f32 on both sides. Tolerances: loss value rtol 1e-3, every param
grad rtol/atol 2e-3 (tests/test_pallas_train.py's bar; the packed convs
reassociate sums).

Sizes: 92², levels = 2 runs every packed site through the JAX wrappers in
interpret mode (SEG_PALLAS_INTERPRET=1); 208², levels = 4 has the crop
phases of 512² (odd 41 at the level-2 decoder, even 90 at level 1), on
JAX's XLA route (SEG_PALLAS_TRAIN=0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_tpu.core.config import ModelConfig as JConfig
from segmentation_tpu.models.unet_fast import UNetS2D as JUNetS2D
from segmentation_tpu.nn import module as hk
from segmentation_tpu_torch import interop
from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.models.unet_fast import UNetS2D
from segmentation_tpu_torch.nn.kernels import conv_flat


def _grads_case(monkeypatch, hw, levels, route):
    """(port loss, port grads, JAX loss, JAX grads) of sum(logits · cot)."""
    mcfg = JConfig(name="unet", n_classes=2, input_dims=(hw, hw),
                   n_kernels=32)
    jmodel = JUNetS2D(mcfg, levels=levels)
    fwd = hk.transform(lambda x: jmodel(x))
    rng = np.random.default_rng(hw)
    x = rng.normal(0.5, 0.2, (2, hw, hw, 3)).astype(np.float32)
    params, state = fwd.init(jax.random.PRNGKey(0), jnp.asarray(x),
                             train=True)
    cot = rng.normal(size=(2, *jmodel.output_hw((hw, hw)), 2))
    cot = cot.astype(np.float32)

    def loss(p):
        y, _ = fwd.apply(p, state, jax.random.PRNGKey(1), jnp.asarray(x),
                         train=True)
        return jnp.sum(y * cot)

    for k, v in route.items():
        monkeypatch.setenv(k, v)
    want_v, want_g = jax.value_and_grad(loss)(params)

    model = UNetS2D(ModelConfig(n_classes=2, input_dims=(hw, hw),
                                n_kernels=32), levels=levels,
                    params=interop.params_from_jax(params))
    got_v = (model(torch.from_numpy(x)) * torch.from_numpy(cot)).sum()
    got_v.backward()
    got_g = {n: p.grad.numpy() for n, p in model.params.items()}
    return got_v.item(), got_g, float(want_v), want_g


@pytest.mark.parametrize("hw,levels,route", [
    (92, 2, {"SEG_PALLAS_INTERPRET": "1"}),
    (208, 4, {"SEG_PALLAS_TRAIN": "0"}),
])
def test_unet_s2d_loss_and_grads_match_jax(monkeypatch, hw, levels, route):
    monkeypatch.delenv("SEG_PALLAS_TRAIN", raising=False)
    got_v, got_g, want_v, want_g = _grads_case(monkeypatch, hw, levels, route)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-3)
    assert set(got_g) == set(want_g)
    for name in want_g:
        np.testing.assert_allclose(got_g[name], np.asarray(want_g[name]),
                                   rtol=2e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("k", [32, 16])
def test_unet_s2d_runs_every_function(monkeypatch, k):
    """Every packed site, the C = 3 entry included (H3's gathered mode),
    and the bottleneck's two std convs (H8) take their Functions (recorded
    through the ops: each forward op, each 2×2 site's H6 dgrad and H9
    wgrad and each site's mask and bias grad, relu_bias_grad), with no
    shape gate: also
    at k = 16, whose 4C = 64 the JAX package's lane gate would leave to
    XLA (on the card the kernels' wrappers then raise). bf16 activations
    give f32 grads."""
    calls = []

    def rec(name, f):
        def op(*a, **kw):
            calls.append(name)
            return f(*a, **kw)
        return op

    ops = conv_flat.Ops(*(rec(n, f) for n, f in
                          zip(conv_flat.Ops._fields, conv_flat.PLAIN_OPS)))
    cfg = ModelConfig(n_classes=2, input_dims=(92, 92), n_kernels=k)
    model = UNetS2D(cfg, levels=2, ops=ops)
    x = torch.rand((1, 92, 92, 3)).to(torch.bfloat16)
    model(x).float().sum().backward()
    assert sorted(calls) == sorted(
        ["strided_conv4x4s2"] * 2 + ["packed_conv2x2"] * 4
        + ["packed_conv2x2_dual"] * 2 + ["rows_matmul"] * 2
        + ["packed_conv2x2_dgrad"] * 4 + ["packed_conv2x2_dgrad_dual"] * 2
        + ["packed_conv2x2_wgrad"] * 4 + ["packed_conv2x2_wgrad_dual"] * 2
        + ["std_conv3x3"] * 2 + ["relu_bias_grad"] * 12)
    for name, p in model.params.items():
        assert p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
