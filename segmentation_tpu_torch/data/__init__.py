"""Datasets (segmentation_tpu.data)."""

from segmentation_tpu_torch.data.synthetic import SyntheticSegmentation

__all__ = ["SyntheticSegmentation"]
