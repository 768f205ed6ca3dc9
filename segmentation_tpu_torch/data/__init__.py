"""Datasets and the input pipeline (segmentation_tpu.data). ``native``
(the C++ loader's binding) is imported on its own; it builds nothing until
a dataset or ``available()`` asks for it."""

from segmentation_tpu_torch.data.augment import (
    device_augment,
    host_joint_random_crop,
    one_hot_mask,
)
from segmentation_tpu_torch.data.datasets import (
    ImageDataSet,
    ImageMaskDataSet,
    load_images,
)
from segmentation_tpu_torch.data.decode import decode_image
from segmentation_tpu_torch.data.pipeline import (
    DevicePrefetcher,
    GeneratorDataSet,
)
from segmentation_tpu_torch.data.synthetic import (
    SyntheticImages,
    SyntheticSegmentation,
)

__all__ = [
    "device_augment",
    "host_joint_random_crop",
    "one_hot_mask",
    "ImageDataSet",
    "ImageMaskDataSet",
    "load_images",
    "decode_image",
    "DevicePrefetcher",
    "GeneratorDataSet",
    "SyntheticImages",
    "SyntheticSegmentation",
]
