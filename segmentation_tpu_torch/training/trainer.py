"""The segmentation trainer (segmentation_tpu.models.base.SegmentationTrainer,
its xentropy objective).

    trainer = SegmentationTrainer(UNetS2D(cfg), dataset)  # on the card
    metrics = trainer.train_step()      # {"seg_xentropy", "seg_loss"}
    trainer.test()                      # {"test_loss", "miou", "pixel_acc"}
    y_sig, argmax_map = trainer.infer(images)
    trainer.snapshot()                  # {save_dir}/unet.ckpt-{step}.npz

The trainer runs on the card unless ``device="cpu"`` is asked for (the
tests). f32 params and Adam state; the batch runs in the compute dtype
(u8 images are normalized on the device; a batch already on the device
is not copied), the loss in f32 on labels center-cropped to the logits
(the VALID U-Net shrinks its output). ``torch.optim.Adam`` with
the JAX package's optax.adam rule (β2 0.999, ε 1e-8 added after the
bias-corrected square root). A snapshot is the JAX package's TrainState
checkpoint, leaf for leaf, so either package restores the other's. The
step runs eagerly: no jit, no scan (``train_steps`` is a loop). The
adversarial, autoencoder and variational modes, remat and the summary
writer are not ported.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from segmentation_tpu_torch.core.config import ModelConfig, TrainConfig
from segmentation_tpu_torch.nn.shapes import center_crop_or_pad
from segmentation_tpu_torch.training import losses
from segmentation_tpu_torch.utils import checkpoint as ckpt
from segmentation_tpu_torch.utils import trace

Batch = Dict[str, torch.Tensor]
_ADAM = ((".opt_state[0].mu", "exp_avg"), (".opt_state[0].nu", "exp_avg_sq"))


class SegmentationTrainer:
    """A step runs in the span ``train:step``, its closing loss read in
    ``train:sync`` (utils/trace.py)."""

    def __init__(self, model, dataset=None, test_dataset=None,
                 model_cfg: Optional[ModelConfig] = None,
                 train_cfg: Optional[TrainConfig] = None, device="cuda"):
        self.tcfg = train_cfg or TrainConfig()
        self.mcfg = model_cfg or model.cfg
        self.mode = self.tcfg.mode
        self.device = torch.device(device)
        self.compute_dtype = getattr(torch, self.tcfg.compute_dtype)
        self.model = model.to(device=self.device,
                              dtype=getattr(torch, self.tcfg.param_dtype))
        self.dataset, self.test_dataset = dataset, test_dataset
        self.model_name = getattr(model, "model_name", "model")
        self.save_dir = self.tcfg.save_dir
        self.optimizer = torch.optim.Adam(
            model.parameters(), lr=self.tcfg.learning_rate,
            betas=(self.tcfg.adam_beta1, 0.999), eps=1e-8)
        self.step = 0
        # INFERENCE mode forces a restore
        self.load_snapshot = bool(self.tcfg.load_snapshot) or (
            self.mode == "INFERENCE")
        self._init_saver()

    @property
    def global_step(self) -> int:
        return self.step

    # ---- batches ----------------------------------------------------------
    def _next_batch(self, ds) -> Batch:
        batch = ds.get_batch()
        if isinstance(batch, tuple):
            batch = dict(zip(("image", "mask"), batch))
        return self._place(batch)

    def _place(self, batch) -> Batch:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if v is not None}

    def _to_compute(self, img: torch.Tensor) -> torch.Tensor:
        if img.dtype == torch.uint8:
            return img.to(self.compute_dtype) * (1.0 / 255.0)
        return img.to(self.compute_dtype)

    def _align_target(self, y: torch.Tensor, logits: torch.Tensor):
        """Labels center-cropped (or padded) to the logits' size, the
        IN_OUT_CROP contract of the VALID U-Net."""
        if y.shape[1:3] == logits.shape[1:3]:
            return y
        if y.ndim == 3:
            y = y[..., None]
        if not getattr(self.model, "IN_OUT_CROP", False):
            raise ValueError(f"labels {tuple(y.shape)} do not match logits "
                             f"{tuple(logits.shape)}")
        return center_crop_or_pad(y, logits.shape[1], logits.shape[2])

    def _loss(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        with trace.span("fwd", "input"):
            x = self._to_compute(batch["image"])
        logits = self.model(x)
        with trace.span("fwd", "loss"):
            target = self._align_target(batch["mask"], logits)
            xent = losses.segmentation_xentropy(logits, target,
                                                self.mcfg.n_classes)
        return xent, logits

    # ---- steps --------------------------------------------------------------
    def loss_and_grads(self, batch: Optional[Batch] = None):
        """(loss, {name: grad}) of one batch, without a step: each param's
        ``.grad`` holds the mean of the ``grad_accum`` microbatches'
        grads, the loss their mean."""
        if batch is None:
            batch = self._next_batch(self.dataset)
        else:
            batch = self._place(batch)
        k = int(self.tcfg.grad_accum or 1)
        n = batch["image"].shape[0]
        if n % k:
            raise ValueError(f"batch {n} not divisible by grad_accum={k}")
        self.optimizer.zero_grad(set_to_none=True)
        total = 0.0
        for i in range(k):
            micro = {key: v[i * n // k : (i + 1) * n // k]
                     for key, v in batch.items()}
            loss, _ = self._loss(micro)
            (loss / k).backward()
            total = total + loss.detach()
        grads = {name: p.grad for name, p in self.model.params.items()}
        return total / k, grads

    def train_step(self, batch: Optional[Batch] = None) -> Dict[str, float]:
        """One Adam step on ``batch`` (default: the dataset's next)."""
        with trace.span("train:step"):
            loss, _ = self.loss_and_grads(batch)
            with trace.span("optimizer"):
                self.optimizer.step()
            self.step += 1
            with trace.span("train:sync"):
                xent = float(loss)
        return {"seg_xentropy": xent, "seg_loss": xent}

    def train_steps(self, n: int) -> Dict[str, float]:
        """``n`` steps on the dataset's batches; the last step's metrics."""
        metrics = {}
        for _ in range(n):
            metrics = self.train_step()
        return metrics

    def test(self) -> Dict[str, float]:
        """Loss, mIoU and pixel accuracy of one test batch."""
        if self.mode == "INFERENCE":
            print("test() with INFERENCE mode invalid")
            return {}
        batch = self._next_batch(self.test_dataset or self.dataset)
        with torch.no_grad():
            xent, logits = self._loss(batch)
            pred = logits.argmax(-1)
            target = self._align_target(batch["mask"], logits)
            if target.ndim == 4:
                target = target[..., 0]
            out = {"test_loss": float(xent),
                   "miou": float(losses.miou(pred, target,
                                             self.mcfg.n_classes)),
                   "pixel_acc": float(losses.pixel_accuracy(pred, target))}
        print(f"TEST step {self.step}: {out}")
        return out

    def infer(self, imgs):
        """[N, H, W, C] images → [sigmoid(logits), argmax map [N, h, w, 1]]
        as f32 numpy arrays. The images are cast to the compute dtype as
        they are (no /255)."""
        x = torch.as_tensor(np.asarray(imgs)).to(self.device,
                                                 self.compute_dtype)
        with torch.no_grad():
            sig = torch.sigmoid(self.model(x).float())
        out = sig.argmax(3)[..., None].float()
        return [sig.cpu().numpy(), out.cpu().numpy()]

    # ---- checkpoints ----------------------------------------------------------
    def state_leaves(self) -> Dict[str, np.ndarray]:
        """The trainer's state as the leaves of the JAX package's TrainState
        (key path → array, in its leaf order): step, rng, params, then
        Adam's count, mu and nu. A step here draws no random numbers, so
        rng is written as zeros."""
        params = dict(sorted(self.model.params.items()))
        states = [self.optimizer.state.get(p, {}) for p in params.values()]
        count = int(states[0]["step"]) if states[0] else 0
        out = {".step": np.int32(self.step), ".rng": np.zeros(2, np.uint32)}
        for name, p in params.items():
            out[f".params['{name}']"] = p.detach().cpu().numpy()
        out[".opt_state[0].count"] = np.int32(count)
        for prefix, slot in _ADAM:
            for (name, p), st in zip(params.items(), states):
                v = st[slot] if st else torch.zeros_like(p)
                out[f"{prefix}['{name}']"] = v.detach().cpu().numpy()
        return out

    def restore(self, path: str) -> None:
        """Params, Adam state and step from a checkpoint of either
        package."""
        leaves, step = ckpt.read(path)
        params = dict(self.model.params.items())
        for name, p in params.items():
            key = f".params['{name}']"
            if key not in leaves or leaves[key].shape != tuple(p.shape):
                raise ValueError(f"checkpoint {path}: no {key} of shape "
                                 f"{tuple(p.shape)}")
        count = int(leaves.get(".opt_state[0].count", 0))
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(torch.as_tensor(leaves[f".params['{name}']"]))
        self.optimizer.state.clear()
        if count:
            for name, p in params.items():
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    **{slot: torch.as_tensor(
                        leaves[f"{prefix}['{name}']"]).to(p)
                       for prefix, slot in _ADAM},
                }
        self.step = step

    def _init_saver(self) -> None:
        os.makedirs(self.save_dir, exist_ok=True)
        if not self.load_snapshot:
            return
        try:
            path = self.tcfg.load_snapshot_from or ckpt.latest_checkpoint(
                self.save_dir, self.model_name)
            if path is None:
                raise FileNotFoundError(f"no checkpoint in {self.save_dir}")
            self.restore(path)
            print(f"Restored snapshot; resuming from global step {self.step}")
        except Exception as e:
            # resume-if-present training goes on from fresh weights; an
            # INFERENCE run or an explicit load_snapshot_from must restore
            if self.mode == "INFERENCE" or self.tcfg.load_snapshot_from:
                raise RuntimeError(
                    f"snapshot restore required (mode={self.mode}, "
                    f"load_snapshot_from={self.tcfg.load_snapshot_from!r}) "
                    f"but failed: {e}") from e
            print(f"Failed to load snapshot ({e}); proceed with training")

    def snapshot(self) -> Optional[str]:
        if self.mode == "INFERENCE":
            print("snapshot() with INFERENCE mode invalid")
            return None
        path = ckpt.save(self.save_dir, self.model_name, self.step,
                         self.state_leaves(), self.tcfg.max_to_keep)
        print(f"Global step {self.step}, snapshotted to {path}")
        return path
