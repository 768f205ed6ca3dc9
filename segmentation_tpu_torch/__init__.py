"""segmentation_tpu_torch — the PyTorch / CUDA port of segmentation_tpu.

The U-Net 512² serving forwards (``serving.entry``: bf16, and calibrated
int8 with ``int8=True``) run on an NVIDIA H100 through hand-written CUDA
kernels (``nn/kernels/conv_flat.py``, ``nn/kernels/conv_int8.py``,
sources in ``csrc/``). Module names mirror the JAX package so that each
part of the port sits beside its reference. This package imports torch and
never jax; the kernels are built at their first CUDA call, never at import.
"""

__version__ = "0.1.0"
