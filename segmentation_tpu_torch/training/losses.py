"""Segmentation losses and metrics (segmentation_tpu.training.losses).
Every reduction runs in float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_xentropy(logits: torch.Tensor,
                     labels_onehot: torch.Tensor) -> torch.Tensor:
    """tf.nn.softmax_cross_entropy_with_logits: per-example CE over the
    last dim."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(labels_onehot.float() * logp).sum(-1)


def segmentation_xentropy(logits: torch.Tensor, masks: torch.Tensor,
                          n_classes: int) -> torch.Tensor:
    """Mean softmax CE of [N,H,W,C] logits against integer [N,H,W,1] or
    [N,H,W] masks."""
    if masks.ndim == 4:
        masks = masks[..., 0]
    onehot = F.one_hot(masks.long(), n_classes)
    return softmax_xentropy(logits, onehot).mean()


def miou(pred: torch.Tensor, target: torch.Tensor,
         n_classes: int) -> torch.Tensor:
    """Mean intersection-over-union of integer class maps; a class absent
    from both counts as 1."""
    pred, target = pred.long(), target.long()
    ious = []
    for c in range(n_classes):
        p, t = pred == c, target == c
        inter = (p & t).sum().float()
        union = (p | t).sum().float()
        ious.append(torch.where(union > 0, inter / union.clamp(min=1),
                                torch.ones_like(union)))
    return torch.stack(ious).mean()


def pixel_accuracy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred == target).float().mean()
