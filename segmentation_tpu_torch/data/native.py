"""ctypes binding to the repository's native data loader (csrc/dataloader.cc,
shared with the JAX package's segmentation_tpu.data.native).

``NativeImageMaskDataSet`` takes the Python ``ImageMaskDataSet``'s knobs
and gives its get_batch() dict; decode (libjpeg/libpng), joint crop, flip,
/255 and batch assembly run in C++ worker threads, off the GIL. With
``uint8_images=True`` it serves the raw cropped bytes (4× less host→device
traffic; the device normalizes them). One C++ source serves both packages,
so one seed gives both the same stream.

The library is built at first use with g++ into this package's
``csrc/build/`` (gitignored), under a name keyed by a hash of the source
and flags; each build writes a temp file and renames it, so processes that
build at once never load a half-written library. Nothing is built at
import. Without a compiler or the libjpeg/libpng headers ``available()``
is False, ``build_error()`` says why, and a dataset raises with that
message.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "dataloader.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-ljpeg", "-lpng", "-lpthread")
# the C ABI version this binding speaks (dataloader.cc kVersion)
_ABI_VERSION = 3

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsegdl-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the loader unless this exact build exists; its path."""
    if not SOURCE.exists():
        raise FileNotFoundError(f"no loader source at {SOURCE}")
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE),
                               *LIBS], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{proc.stderr[-2000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ver = lib.sdl_version()
    if ver != _ABI_VERSION:
        raise RuntimeError(f"loader ABI version {ver} != {_ABI_VERSION}")
    lib.sdl_create.restype = ctypes.c_void_p
    lib.sdl_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.sdl_next_batch.restype = ctypes.c_int
    lib.sdl_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), u8p]
    lib.sdl_next_batch_u8.restype = ctypes.c_int
    lib.sdl_next_batch_u8.argtypes = [ctypes.c_void_p, u8p, u8p]
    lib.sdl_stop.argtypes = [ctypes.c_void_p]
    lib.sdl_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except Exception as e:
                _build_error = str(e)
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


class NativeImageMaskDataSet:
    """C++-backed paired image/mask streaming dataset (image-only when
    neither ``mask_dir`` nor ``mask_names`` is given)."""

    has_masks = True

    def __init__(
        self,
        image_dir: str,
        mask_dir: Optional[str] = None,
        image_names: Optional[Sequence[str]] = None,
        mask_names: Optional[Sequence[str]] = None,
        n_classes: int = 2,
        batch_size: int = 96,
        crop_size: int = 256,
        capacity: int = 5000,
        image_ext: str = "jpg",
        mask_ext: str = "png",
        seed: int = 5555,
        threads: int = 4,
        augment_flip: bool = False,
        mask_divisor: Optional[int] = 255,
        channels: int = 3,
        uint8_images: bool = False,
    ):
        self._handle = None
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        if image_names is None:
            image_names = sorted(
                glob.glob(os.path.join(image_dir, f"*.{image_ext}"))
            )
        self.has_masks = mask_dir is not None or mask_names is not None
        if self.has_masks and mask_names is None:
            mask_names = sorted(
                glob.glob(os.path.join(mask_dir, f"*.{mask_ext}"))
            )
        image_names = list(image_names)
        mask_names = list(mask_names or [])
        if not image_names:
            raise ValueError(f"no *.{image_ext} files in {image_dir}")
        if self.has_masks and len(mask_names) != len(image_names):
            raise ValueError(
                f"{len(image_names)} images vs {len(mask_names)} masks"
            )
        self.image_names = image_names
        self.mask_names = mask_names
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.n_classes = n_classes
        self.channels = channels
        self.mask_divisor = mask_divisor
        self.uint8_images = uint8_images
        self._lib = lib
        self._handle = lib.sdl_create(
            "\n".join(image_names).encode(),
            "\n".join(mask_names).encode(),
            batch_size, crop_size, threads, seed,
            min(capacity, 4 * batch_size + 64), int(augment_flip), channels,
            int(not uint8_images),  # want_f32: the workers convert /255
        )
        if not self._handle:
            raise RuntimeError("sdl_create failed")
        self._img_buf = np.empty(
            (batch_size, crop_size, crop_size, channels),
            np.uint8 if uint8_images else np.float32,
        )
        self._mask_buf = np.empty(
            (batch_size, crop_size, crop_size, 1), np.uint8
        )

    def _next(self, want_mask: bool) -> None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        mask = (self._mask_buf.ctypes.data_as(u8p) if want_mask
                else ctypes.cast(None, u8p))
        if self.uint8_images:
            rc = self._lib.sdl_next_batch_u8(
                self._handle, self._img_buf.ctypes.data_as(u8p), mask)
        else:
            rc = self._lib.sdl_next_batch(
                self._handle,
                self._img_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                mask)
        if rc != 0:
            detail = (
                " (a full epoch of consecutive decode failures — every "
                "image is undecodable or smaller than crop_size)"
                if rc == -3 else ""
            )
            raise RuntimeError(f"sdl_next_batch failed rc={rc}{detail}")

    def get_batch(self) -> Dict[str, np.ndarray]:
        self._next(want_mask=self.has_masks)
        out = {"image": self._img_buf.copy()}
        if self.has_masks:
            m = self._mask_buf.astype(np.int32)
            if self.mask_divisor:
                m = m // self.mask_divisor
            out["mask"] = np.clip(m, 0, self.n_classes - 1).astype(np.uint8)
        return out

    def stop(self):
        if self._handle:
            self._lib.sdl_stop(self._handle)

    def close(self):
        if self._handle:
            self._lib.sdl_destroy(self._handle)
            self._handle = None

    def __iter__(self):
        while True:
            yield self.get_batch()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeImageDataSet(NativeImageMaskDataSet):
    """C++-backed image-only dataset (``ImageDataSet``'s counterpart)."""

    has_masks = False

    def __init__(self, image_dir: str, **kwargs):
        kwargs.pop("mask_dir", None)
        super().__init__(image_dir, mask_dir=None, **kwargs)
