"""Build and bind the hand-written CUDA kernels (``csrc/`` of this package).

At the first CUDA call, ``nvcc`` compiles every ``csrc/*.cu`` for
``sm_90a`` (one process per source, all started together) and links the
objects into one shared library with a plain C interface, which is
loaded with ``ctypes`` (no PyTorch headers: a build takes seconds, not
minutes). The library lands in ``csrc/build/`` under a name keyed by a
hash of the sources and flags, so an edited source never loads a stale
build. Nothing is built or loaded at import time. The link needs no
``-lcuda``: the one driver-API call, ``cuTensorMapEncodeTiled`` (the TMA
tensor maps of the kernels on ``csrc/sm90_igemm.cuh``), is reached at run
time through the runtime's ``cudaGetDriverEntryPoint``. The helpers at the
end are the wrappers' shared checks and ctypes arguments.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from segmentation_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of csrc/*.cu (every kernel entry returns its cudaError_t)
_SIGNATURES = {
    "seg_packed_conv2x2": [_P] * 9 + [_I] * 7 + [_P],
    "seg_packed_conv2x2_dual": [_P] * 6 + [_I] * 11 + [_P],
    "seg_strided_conv4x4s2": [_P] * 4 + [_I] * 7 + [_P],
    "seg_strided_conv4x4s2_requant": [_P] * 5 + [_I] * 7 + [_P],
    "seg_rows_matmul": [_P] * 4 + [_I] * 8 + [_P],
    "seg_packed_conv2x2_s8": [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P],
    "seg_packed_conv2x2_dual_s8": [_P] * 9 + [_I] * 9 + [_F, _F, _I, _I,
                                                         _P],
    "seg_strided_conv4x4s2_s8": [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P],
    "seg_rows_matmul_s8": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
    "seg_std_conv3x3_s8": [_P] * 5 + [_I] * 8 + [_P],
    "seg_std_conv3x3_dual_s8": [_P] * 8 + [_I] * 9 + [_F] * 3 + [_I] * 2
    + [_P],
    "seg_std_conv3x3": [_P] * 4 + [_I] * 9 + [_P],
    "seg_std_conv3x3_dual": [_P] * 6 + [_I] * 13 + [_P],
    "seg_entry_chain": [_P] * 9 + [_I] * 5 + [_P],
    "seg_packed_conv2x2_dgrad": [_P] * 5 + [_I] * 13 + [_P],
    "seg_packed_tap_grad": [_P] * 5 + [_I] * 8 + [_P] * 2,
    "seg_crop_normalize": [_P] * 7 + [_I] * 7 + [_P],
    "seg_relu_bias_grad": [_P] * 5 + [_I] * 2 + [_P] * 2 + [_I] * 4 + [_P],
    "seg_relu_bias_grad_blocks": [],
    "seg_crop_margin_zero": [_P] + [_I] * 8 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""       # nvcc's output of the build this process ran, if any
build_seconds = 0.0  # 0.0 when an existing build was loaded


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsegkernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; return its path."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj,
                 str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [p.returncode for p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{build_log}")
        lib = os.path.join(tmp, out.name)
        proc = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", lib, *objs], capture_output=True, text=True,
        )
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{build_log}")
        os.replace(lib, out)
    build_seconds = time.perf_counter() - t0
    return out


def loaded() -> bool:
    return _lib is not None


def library() -> ctypes.CDLL:
    """The bound kernel library, built (or loaded) on first use, in the
    span ``setup:kernels``."""
    global _lib
    if _lib is None:
        with trace.span("setup:kernels"):
            lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.seg_error_string.argtypes = [ctypes.c_int]
        lib.seg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().seg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# ------------------------------------------------------------ wrapper helpers
def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return False


def _require(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
