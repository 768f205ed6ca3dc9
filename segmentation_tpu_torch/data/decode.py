"""Image decoding (segmentation_tpu.data.decode): cv2 (libjpeg-turbo), then
PIL, else an error. Every path returns HWC uint8 in RGB order, or HW1 when
grayscale."""

from __future__ import annotations

import numpy as np

_CV2 = None
_PIL = None


def _cv2():
    global _CV2
    if _CV2 is None:
        try:
            import cv2

            _CV2 = cv2
        except Exception:
            _CV2 = False
    return _CV2


def _pil():
    global _PIL
    if _PIL is None:
        try:
            from PIL import Image

            _PIL = Image
        except Exception:
            _PIL = False
    return _PIL


def decode_image(path: str, grayscale: bool = False) -> np.ndarray:
    """Decode a PNG/JPEG file → HWC uint8 (RGB, or HW1 when grayscale)."""
    cv2 = _cv2()
    if cv2:
        flag = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
        img = cv2.imread(path, flag)
        if img is not None:
            if grayscale:
                return img[..., None]
            return img[:, :, ::-1]  # BGR → RGB
    Image = _pil()
    if Image:
        with Image.open(path) as im:
            im = im.convert("L" if grayscale else "RGB")
            arr = np.asarray(im)
            return arr[..., None] if grayscale else arr
    raise RuntimeError("no image decoder available (cv2/PIL missing)")
