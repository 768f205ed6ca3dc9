"""Models: the plain U-Net and its space-to-depth serving form."""

from segmentation_tpu_torch.models.unet import UNet, init_params
from segmentation_tpu_torch.models.unet_fast import UNetS2DInference

__all__ = ["UNet", "UNetS2DInference", "init_params"]
