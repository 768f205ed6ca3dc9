"""The port's U-Net serving path against the JAX package on CPU.

Both sides get the same float32 params and inputs, made with numpy from a
seed. The JAX space-to-depth model runs its XLA oracle route
(allow_pallas=False, padflat=False, as tests/test_unet_padflat.py does);
the port runs its plain versions, which tests/test_torch_kernels.py holds
against the Pallas kernels. Tolerances: float32 everywhere, so layer and
plain-U-Net outputs agree to 1e-4 (summation order only); the packed
forward reassociates every conv (16C-term packed sums, split dual
convs), so logits are held to 1e-3 and masks may differ only where the
JAX logit margin is below 1e-3.

Input sizes: 208² has the decoder crop phases of 512² (offset 41, odd, at
the level-2 decoder; 90, even, at level 1); 206² puts the odd phase (89)
at level 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from segmentation_tpu.core.config import ModelConfig as JConfig
from segmentation_tpu.models import unet_fast as jfast
from segmentation_tpu.models.unet import UNet as JUNet
from segmentation_tpu.nn import module as hk
from segmentation_tpu.nn import shapes as jshapes
from segmentation_tpu.nn.layers import max_pool as jmax_pool
from segmentation_tpu.utils import checkpoint as jckpt
from segmentation_tpu_torch import interop, serving
from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.models import unet_fast as tfast
from segmentation_tpu_torch.models.unet import UNet, unet_param_shapes
from segmentation_tpu_torch.nn import layers
from segmentation_tpu_torch.nn.kernels import conv_flat as tcf
from segmentation_tpu_torch.nn.shapes import unet_output_hw
from segmentation_tpu_torch.utils.checkpoint import load_params

_DN = ("NHWC", "HWIO", "NHWC")
# decoder crop offsets (unpacked units): level-2 decoder, then level 1
PHASES = {208: [(41, 41), (90, 90)], 206: [(40, 40), (89, 89)]}


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


def _input(hw, b=2, seed=1):
    rng = np.random.default_rng(seed)
    return rng.random((b, hw, hw, 3)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ------------------------------------------------------------- packing
def test_pack2_unpack2_match_jax(np_rng):
    x = np_rng.normal(size=(2, 6, 8, 5)).astype(np.float32)
    got = tfast.pack2(_t(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfast.pack2(jnp.asarray(x))))
    np.testing.assert_array_equal(tfast.unpack2(got).numpy(), x)
    with pytest.raises(ValueError, match="even"):
        tfast.pack2(_t(x[:, :5]))


def test_weight_packing_matches_jax(np_rng):
    w = np_rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(tfast.pack_conv3_weight_t(_t(w)).numpy(),
                                  jfast.pack_conv3_weight(w))
    np.testing.assert_array_equal(
        tfast.pack_conv3_weight_s2_t(_t(w)).numpy(),
        jfast.pack_conv3_weight_s2(w))
    b = np_rng.normal(size=(7,)).astype(np.float32)
    np.testing.assert_array_equal(tfast.tile_bias4(_t(b)).numpy(),
                                  np.asarray(jfast.tile_bias4(b)))


def test_head_diff_matches_jax(np_rng):
    p = {"output/w": np_rng.normal(size=(1, 1, 6, 2)).astype(np.float32),
         "output/b": np_rng.normal(size=(2,)).astype(np.float32)}
    cfg = JConfig(n_classes=2, n_kernels=6)
    wd, bd = jfast.UNetS2DInference(cfg)._head_diff(p)
    twd, tbd = tfast.head_diff(_t(p["output/w"]), _t(p["output/b"]))
    np.testing.assert_array_equal(twd.numpy(), np.asarray(wd))
    np.testing.assert_allclose(tbd.numpy(), np.asarray(bd), rtol=1e-7)


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (2, 2)])
def test_conv2d_matches_lax(np_rng, k, s):
    x = np_rng.normal(size=(2, 9, 10, 3)).astype(np.float32)
    w = np_rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    b = np_rng.normal(size=(4,)).astype(np.float32)
    want = jax.nn.relu(lax.conv_general_dilated(
        x, w, (s, s), "VALID", dimension_numbers=_DN) + b)
    got = layers.conv2d(_t(x), _t(w), _t(b), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    with pytest.raises(ValueError, match="too small"):
        layers.conv2d(_t(x[:, : k - 1]), _t(w), _t(b))


@pytest.mark.parametrize("k,s", [(2, 2), (3, 2), (2, 1)])
def test_conv2d_transpose_matches_lax(np_rng, k, s):
    """TF VALID sizing (n-1)·s + k, no kernel flip."""
    x = np_rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    w = np_rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    b = np_rng.normal(size=(4,)).astype(np.float32)
    want = lax.conv_transpose(x, jnp.swapaxes(w, 2, 3), (s, s), "VALID",
                              dimension_numbers=_DN, transpose_kernel=True)
    want = np.asarray(want + b)
    got = layers.conv2d_transpose(_t(x), _t(w), _t(b), s, activation=None)
    assert tuple(got.shape) == want.shape
    assert got.shape[1] == jshapes.deconv_out(5, k, s, "VALID")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_max_pool_and_crop_match_jax(np_rng):
    x = np_rng.normal(size=(2, 9, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(layers.max_pool(_t(x), 2).numpy(),
                                  np.asarray(jmax_pool(jnp.asarray(x), 2)))
    for th, tw in ((5, 4), (9, 3), (8, 6)):
        target = torch.zeros((1, th, tw, 1))
        np.testing.assert_array_equal(
            layers.center_crop_like(_t(x), target).numpy(),
            np.asarray(jshapes.center_crop_or_pad(jnp.asarray(x), th, tw)),
        )
    with pytest.raises(ValueError, match="cannot crop"):
        layers.center_crop_like(_t(x), torch.zeros((1, 10, 4, 1)))


def test_unet_output_hw_matches_jax():
    for hw in ((188, 188), (206, 208), (512, 512)):
        assert unet_output_hw(hw) == jshapes.unet_output_hw(hw)


# --------------------------------------------------------------- models
@pytest.fixture(scope="module", params=[208, 206])
def case(request):
    hw = request.param
    cfg = ModelConfig(n_classes=2, input_dims=(hw, hw), n_kernels=4)
    jcfg = JConfig(n_classes=2, input_dims=(hw, hw), n_kernels=4)
    params = _np_params(cfg)
    x = _input(hw)
    oracle = jfast.UNetS2DInference(jcfg, allow_pallas=False, padflat=False)
    prepared = oracle.prepare({k: jnp.asarray(v) for k, v in params.items()})
    logits = np.asarray(jax.jit(oracle.apply)(prepared, jnp.asarray(x)))
    mask = np.asarray(jax.jit(oracle.apply_argmax)(prepared, jnp.asarray(x)))
    return hw, cfg, jcfg, params, x, logits, mask


def test_unet_matches_jax(case):
    hw, cfg, jcfg, params, x, _, _ = case
    fwd = hk.transform(lambda v: JUNet(jcfg)(v))
    want, _ = jax.jit(
        lambda p, v: fwd.apply(p, {}, None, v, train=False)
    )({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    model = UNet(cfg, params=interop.params_from_jax(params))
    assert set(model.param_dict()) == set(params)
    got = model(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _recording_ops(offsets):
    def dual(*args, offset, **kw):
        offsets.append(tuple(offset))
        return tcf.packed_conv2x2_dual(*args, offset=offset, **kw)

    return tcf.KERNEL_OPS._replace(packed_conv2x2_dual=dual)


def test_s2d_apply_matches_jax(case):
    hw, cfg, _, params, x, want, _ = case
    offsets = []
    model = tfast.UNetS2DInference(cfg, ops=_recording_ops(offsets))
    prepared = model.prepare(interop.params_from_jax(params))
    got = model.apply(prepared, _t(x))
    assert offsets == PHASES[hw]  # odd slot phase and even offset both run
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_s2d_apply_argmax_matches_jax(case):
    hw, cfg, _, params, x, logits, want = case
    model = tfast.UNetS2DInference(cfg)
    prepared = model.prepare(interop.params_from_jax(params))
    got = model.apply_argmax(prepared, _t(x)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    margin = np.abs(logits[..., 1] - logits[..., 0])
    diff = got != want
    assert np.all(margin[diff] < 1e-3), margin[diff].max()


def test_s2d_apply_argmax_general_head(np_rng):
    """n_classes > 2 takes the packed 1×1 head + argmax instead of the
    fused mask."""
    cfg = ModelConfig(n_classes=3, input_dims=(188, 188), n_kernels=4)
    params = interop.params_from_jax(_np_params(cfg, seed=3))
    model = tfast.UNetS2DInference(cfg)
    prepared = model.prepare(params)
    x = _t(_input(188, b=1))
    want = model.apply(prepared, x).argmax(-1).to(torch.uint8)
    assert torch.equal(model.apply_argmax(prepared, x), want)


# ---------------------------------------------------------- checkpoints
def test_jax_checkpoint_loads_in_port(tmp_path):
    from segmentation_tpu.models.base import TrainState

    cfg = ModelConfig(n_kernels=4)
    params = _np_params(cfg)
    path = jckpt.save(str(tmp_path), "unet", 7,
                      {k: jnp.asarray(v) for k, v in params.items()})
    got = load_params(path)
    assert set(got) == set(params)
    for k in params:
        np.testing.assert_array_equal(got[k], params[k])

    # a trainer's TrainState: the port picks .params, not adv_params
    other = {k: v + 1 for k, v in params.items()}
    state = TrainState(step=jnp.int32(9), rng=jnp.zeros(2, jnp.uint32),
                       params=params, model_state={}, opt_state=(),
                       adv_params=other, adv_model_state={},
                       adv_opt_state=(), extra_opt_state=())
    path = jckpt.save(str(tmp_path / "ts"), "unet", 9, state)
    got = load_params(path)
    for k in params:
        np.testing.assert_array_equal(got[k], params[k])


def test_serving_entry_on_cpu(tmp_path):
    """The flagship entry: seeded params, or a JAX-written checkpoint, and
    a forward (run here at a small input on the plain versions)."""
    server, (x0,) = serving.entry("cpu", batch=1, seed=0)
    assert tuple(x0.shape) == (1, 512, 512, 3) and x0.dtype == torch.bfloat16
    assert server.prepared["conv1_1/w4"].shape == (4, 4, 3, 128)
    assert server.prepared["conv1_1/w4"].dtype == torch.bfloat16
    assert server.prepared["conv1_1/b4"].dtype == torch.float32
    assert server.prepared["head/wd"].dtype == torch.bfloat16
    assert server.params["conv1_1/w"].dtype == torch.float32
    again, _ = serving.entry("cpu", batch=1, seed=0)
    assert all(torch.equal(server.params[k], again.params[k])
               for k in server.params)

    npz = {k: jnp.asarray(v.numpy()) for k, v in server.params.items()}
    path = jckpt.save(str(tmp_path), "unet", 1, npz)
    loaded, _ = serving.entry("cpu", batch=1, checkpoint=path)
    assert all(torch.equal(server.params[k], loaded.params[k])
               for k in server.params)

    # the flagship width in f32 at a small input, on the plain versions
    x = torch.rand((1, 188, 188, 3), generator=generator(5))
    logits = UNet(server.model.cfg, params=server.params)(x)
    got = server.model.apply_argmax(server.model.prepare(server.params), x)
    margin = (logits[..., 1] - logits[..., 0]).abs()
    diff = got != logits.argmax(-1)
    assert bool((margin[diff] < 1e-3).all())
