"""The port never imports jax, and a CPU tensor never reaches a kernel.

Run in a fresh interpreter: this test process already has jax loaded.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = textwrap.dedent("""
    import sys
    import torch
    import segmentation_tpu_torch
    import segmentation_tpu_torch.serving
    import segmentation_tpu_torch.profile_serving
    import segmentation_tpu_torch.profile_variants
    import segmentation_tpu_torch.nn.kernels.tiles
    import tempfile
    from segmentation_tpu_torch.core.config import TrainConfig
    from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation
    from segmentation_tpu_torch.models.unet_fast import UNetS2D
    from segmentation_tpu_torch.nn.kernels import conv_bwd as cb
    from segmentation_tpu_torch.training.trainer import SegmentationTrainer
    from segmentation_tpu_torch.nn.kernels import _build
    from segmentation_tpu_torch.nn.kernels import conv_flat as cf
    from segmentation_tpu_torch.nn.kernels import conv_int8 as ci
    from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
    from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8
    from segmentation_tpu_torch.core.config import ModelConfig
    from segmentation_tpu_torch.models.unet import init_params
    from segmentation_tpu_torch.core.rng import generator
    import segmentation_tpu_torch.data
    from segmentation_tpu_torch.data import (
        augment, datasets, decode, native, pipeline, synthetic)
    from segmentation_tpu_torch.nn.kernels import augment as aug
    assert "jax" not in sys.modules, sorted(
        m for m in sys.modules if m.startswith("jax"))
    assert "segmentation_tpu" not in sys.modules

    cfg = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=4)
    model = UNetS2DInference(cfg)
    prepared = model.prepare(init_params(cfg, generator(0)))
    mask = model.apply_argmax(prepared, torch.rand(1, 188, 188, 3))
    assert tuple(mask.shape) == (1, 4, 4), mask.shape
    assert all(v == 0 for v in cf.launches.values()), cf.launches

    # the calibrated int8 forward, on the plain versions
    q = UNetS2DInt8(cfg)
    x = torch.rand(1, 188, 188, 3)
    prepared = q.prepare(init_params(cfg, generator(0)), calib_batches=[x])
    assert prepared["conv2_2/wq"].dtype == torch.int8
    keys = set(prepared)
    mask = q.apply_argmax(prepared, x.to(torch.bfloat16))
    assert set(prepared) == keys  # planned at prepare, not in the forward
    assert tuple(mask.shape) == (1, 4, 4), mask.shape
    assert all(v == 0 for v in ci.launches.values()), ci.launches
    # the other two int8 configurations (the inline-quantize modes)
    cfg32 = ModelConfig(n_classes=2, input_dims=(188, 188), n_kernels=32)
    for kw in ({"padflat": False}, {"quant_deconvs": False}):
        q = UNetS2DInt8(cfg32, **kw)
        prepared = q.prepare(init_params(cfg32, generator(0)),
                             calib_batches=[x])
        mask = q.apply_argmax(prepared, x.to(torch.bfloat16))
        assert tuple(mask.shape) == (1, 4, 4), (kw, mask.shape)
    assert all(v == 0 for v in ci.launches.values()), ci.launches

    # one bf16 train step of the trainable model (every packed site on its
    # Function, on the plain versions)
    cfg92 = ModelConfig(n_classes=2, input_dims=(92, 92), n_kernels=32)
    trainer = SegmentationTrainer(
        UNetS2D(cfg92, levels=2), SyntheticSegmentation(1, (92, 92)),
        device="cpu", train_cfg=TrainConfig(save_dir=tempfile.mkdtemp()))
    loss = trainer.train_step()["seg_loss"]
    assert 0.0 < loss < 10.0, loss
    assert all(v == 0 for v in cb.launches.values()), cb.launches
    assert all(v == 0 for v in cf.launches.values()), cf.launches

    # the data path's device tail on the CPU: prefetch, then H7's plain
    # version through fused_augment
    import numpy as np
    src = [{"image": np.full((2, 20, 20, 3), 7, np.uint8),
            "mask": np.ones((2, 20, 20, 1), np.uint8)}]
    pf = pipeline.DevicePrefetcher(iter(src), device="cpu")
    b = next(pf)
    img, m = aug.fused_augment(generator(0), b["image"], b["mask"], 12,
                               out_dtype=torch.bfloat16)
    assert img.dtype == torch.bfloat16 and tuple(m.shape) == (2, 12, 12, 1)
    assert aug.launches["crop_normalize"] == 0, aug.launches
    assert not _build.loaded()
    assert not _build.BUILD_DIR.exists() or not any(
        _build.BUILD_DIR.glob("*.so.tmp"))
    assert "jax" not in sys.modules
    print("ok")
""")


def test_port_imports_no_jax_and_cpu_builds_nothing():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
