"""Models: the plain U-Net and its space-to-depth serving forms (bf16 and
calibrated int8)."""

from segmentation_tpu_torch.models.unet import UNet, init_params
from segmentation_tpu_torch.models.unet_fast import UNetS2DInference
from segmentation_tpu_torch.models.unet_int8 import UNetS2DInt8

__all__ = ["UNet", "UNetS2DInference", "UNetS2DInt8", "init_params"]
