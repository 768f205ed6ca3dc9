"""The port's SegmentationTrainer against the JAX package's on CPU.

Both trainers start from the same float32 params (the JAX trainer's
initial ones) and draw the same batches from the shared synthetic
generator; both compute in f32, JAX on its XLA route
(SEG_PALLAS_TRAIN=0). Adam moves an element by about lr a step, and a
near-zero grad whose sign differs between the two sides may flip a move,
so after three steps params are held within 2·lr·steps everywhere and
within 0.1·lr on 99.9 % of the elements; losses within rtol 1e-3. The
snapshot format is the JAX TrainState's, so each package restores the
other's files.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segmentation_tpu.core.config import ModelConfig as JConfig
from segmentation_tpu.core.config import TrainConfig as JTrainConfig
from segmentation_tpu.data.synthetic import SyntheticSegmentation as JSynth
from segmentation_tpu.models.base import SegmentationTrainer as JTrainer
from segmentation_tpu.models.unet_fast import UNetS2D as JUNetS2D
from segmentation_tpu.utils import checkpoint as jckpt
from segmentation_tpu_torch import interop
from segmentation_tpu_torch.core.config import ModelConfig, TrainConfig
from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation
from segmentation_tpu_torch.models.unet_fast import UNetS2D
from segmentation_tpu_torch.training.trainer import SegmentationTrainer
from segmentation_tpu_torch.utils.checkpoint import list_checkpoints

LR = 1e-4


HW, B = 92, 2


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """JAX's trainer (f32 compute, XLA route) after three steps, with its
    initial params and its per-step losses."""
    old = os.environ.get("SEG_PALLAS_TRAIN")
    os.environ["SEG_PALLAS_TRAIN"] = "0"
    try:
        mcfg = JConfig(name="unet", n_classes=2, input_dims=(HW, HW),
                       n_kernels=32)
        tcfg = JTrainConfig(save_dir=str(tmp_path_factory.mktemp("jax")),
                            compute_dtype="float32", learning_rate=LR)
        trainer = JTrainer(JUNetS2D(mcfg, levels=2),
                           JSynth(B, (HW, HW), seed=3),
                           JSynth(B, (HW, HW), seed=4), mcfg, tcfg)
        params0 = jax.device_get(trainer.state.params)
        test0 = trainer.test()
        infer0 = trainer.infer(JSynth(B, (HW, HW), seed=5).get_batch()["image"])
        losses = [trainer.train_step()["seg_xentropy"] for _ in range(3)]
        return {"trainer": trainer, "params0": params0, "losses": losses,
                "test0": test0, "infer0": infer0}
    finally:
        if old is None:
            os.environ.pop("SEG_PALLAS_TRAIN")
        else:
            os.environ["SEG_PALLAS_TRAIN"] = old


def _port_trainer(params, save_dir, **tcfg):
    cfg = ModelConfig(n_classes=2, input_dims=(HW, HW), n_kernels=32)
    model = UNetS2D(cfg, levels=2, params=interop.params_from_jax(params))
    return SegmentationTrainer(
        model, SyntheticSegmentation(B, (HW, HW), seed=3),
        SyntheticSegmentation(B, (HW, HW), seed=4), device="cpu",
        train_cfg=TrainConfig(save_dir=str(save_dir), compute_dtype="float32",
                              learning_rate=LR, **tcfg))


def test_trainer_steps_match_jax(jax_trainer, tmp_path):
    ours = _port_trainer(jax_trainer["params0"], tmp_path)
    losses = [ours.train_step()["seg_xentropy"] for _ in range(3)]
    np.testing.assert_allclose(losses, jax_trainer["losses"], rtol=1e-3)
    want = jax.device_get(jax_trainer["trainer"].state.params)
    diffs = np.concatenate([
        np.abs(p.detach().numpy() - np.asarray(want[n])).ravel()
        for n, p in ours.model.params.items()])
    assert diffs.max() <= 2 * LR * 3, diffs.max()
    assert np.mean(diffs <= 0.1 * LR) >= 0.999, np.mean(diffs <= 0.1 * LR)
    assert ours.global_step == 3


def test_trainer_test_and_infer_match_jax(jax_trainer, tmp_path):
    ours = _port_trainer(jax_trainer["params0"], tmp_path)
    got = ours.test()
    want = jax_trainer["test0"]
    assert set(got) == {"test_loss", "miou", "pixel_acc"}
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=1e-4)
    for k in ("miou", "pixel_acc"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)
    sig, amap = ours.infer(SyntheticSegmentation(B, (HW, HW),
                                                 seed=5).get_batch()["image"])
    want_sig, want_map = jax_trainer["infer0"]
    assert sig.shape == want_sig.shape and amap.shape == want_map.shape
    np.testing.assert_allclose(sig, want_sig, atol=1e-4)
    margin = np.abs(want_sig[..., 1] - want_sig[..., 0])[..., None]
    assert np.all(margin[amap != want_map] < 1e-4)


def test_grad_accum_averages_microbatches(jax_trainer, tmp_path):
    """grad_accum = 2 gives the mean of the two half-batch grads (and the
    same step as the JAX trainer's scan would)."""
    params = jax_trainer["params0"]
    whole = _port_trainer(params, tmp_path / "a")
    split = _port_trainer(params, tmp_path / "b", grad_accum=2)
    batch = SyntheticSegmentation(B, (HW, HW), seed=9).get_batch()
    halves = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(2)]
    loss, grads = split.loss_and_grads(batch)
    grads = {n: g.clone() for n, g in grads.items()}
    parts = [whole.loss_and_grads(h) for h in halves]
    parts = [(lo, {n: g.clone() for n, g in gs.items()}) for lo, gs in parts]
    np.testing.assert_allclose(loss.item(),
                               np.mean([lo.item() for lo, _ in parts]),
                               rtol=1e-5)
    for n, g in grads.items():
        mean = (parts[0][1][n] + parts[1][1][n]) / 2
        np.testing.assert_allclose(g.numpy(), mean.numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=n)


def test_u8_batches_are_normalized_on_the_device(jax_trainer, tmp_path):
    """A u8 image batch trains as the same batch / 255 in float."""
    ours = _port_trainer(jax_trainer["params0"], tmp_path)
    batch = SyntheticSegmentation(B, (HW, HW), seed=6).get_batch()
    u8 = dict(batch, image=np.round(batch["image"] * 255).astype(np.uint8))
    f32 = dict(batch, image=u8["image"].astype(np.float32) / 255)
    loss_u8, _ = ours.loss_and_grads(u8)
    loss_f, _ = ours.loss_and_grads(f32)
    np.testing.assert_allclose(loss_u8.item(), loss_f.item(), rtol=1e-6)


def test_torch_adam_is_optax_adam(np_rng):
    """torch.optim.Adam(lr, (b1, 0.999), eps=1e-8) against optax.adam on
    the same params and grads, three steps."""
    p0 = np_rng.normal(size=(5, 7)).astype(np.float32)
    grads = [np_rng.normal(size=(5, 7)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    opt = optax.adam(1e-3, b1=0.9)
    jp, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.Adam([tp], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6)


def test_snapshot_round_trip_and_jax_reads_it(jax_trainer, tmp_path):
    ours = _port_trainer(jax_trainer["params0"], tmp_path, max_to_keep=2)
    for _ in range(3):
        ours.train_step()
        ours.snapshot()
    assert [s for _, s in list_checkpoints(str(tmp_path), "unet")] == [2, 3]
    path = str(tmp_path / "unet.ckpt-3.npz")

    back = _port_trainer(jax_trainer["params0"], tmp_path, load_snapshot=True)
    assert back.global_step == 3
    for (n, p), q in zip(ours.model.params.items(),
                         back.model.params.values()):
        assert torch.equal(p, q), n
        for slot in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(ours.optimizer.state[p][slot],
                               back.optimizer.state[q][slot]), (n, slot)

    # the JAX trainer restores the port's snapshot leaf for leaf
    jstate = jax_trainer["trainer"].state
    restored, step = jckpt.restore(path, jax.device_get(jstate))
    assert step == 3 and int(restored.step) == 3
    assert int(restored.opt_state[0].count) == 3
    for n, p in ours.model.params.items():
        np.testing.assert_array_equal(np.asarray(restored.params[n]),
                                      p.detach().numpy())
        np.testing.assert_array_equal(
            np.asarray(restored.opt_state[0].mu[n]),
            ours.optimizer.state[p]["exp_avg"].numpy())


def test_port_restores_a_jax_snapshot(jax_trainer, tmp_path):
    """A JAX trainer's snapshot resumes in the port: params, Adam moments
    and the step."""
    jt = jax_trainer["trainer"]
    path = jckpt.save(str(tmp_path / "j"), "unet", 3, jt.state)
    ours = _port_trainer(jax_trainer["params0"], tmp_path,
                         load_snapshot=True, load_snapshot_from=path)
    assert ours.global_step == 3
    want = jax.device_get(jt.state)
    for n, p in ours.model.params.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(want.params[n]))
        np.testing.assert_array_equal(
            ours.optimizer.state[p]["exp_avg_sq"].numpy(),
            np.asarray(want.opt_state[0].nu[n]))


def test_inference_mode_requires_a_snapshot(jax_trainer, tmp_path):
    with pytest.raises(RuntimeError, match="restore required"):
        _port_trainer(jax_trainer["params0"], tmp_path / "empty",
                      mode="INFERENCE")
    fresh = _port_trainer(jax_trainer["params0"], tmp_path / "empty2",
                          load_snapshot=True)  # resume-if-present
    assert fresh.global_step == 0
    assert fresh.snapshot() is not None
    inf = _port_trainer(jax_trainer["params0"], tmp_path / "empty2",
                        mode="INFERENCE")
    assert inf.snapshot() is None and inf.test() == {}
