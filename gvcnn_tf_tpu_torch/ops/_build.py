"""Builds the port's CUDA kernels at first use and loads them with ctypes.

`nvcc` compiles every `gvcnn_tf_tpu_torch/csrc/*.cu` into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under `build/gvcnn_tf_tpu_torch/<hash of the sources>/` at the
root of the checkout.  A library whose sources are unchanged is loaded
without a rebuild.  Each entry point launches one kernel on the stream it is
given and returns `cudaGetLastError()` as an int; the wrappers raise when it
is not 0.  A failed build raises with nvcc's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "gvcnn_tf_tpu_torch"
LIB_NAME = "libgvcnn_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures of the entry points; the last argument is the cudaStream_t.
_SIGNATURES = {
    # x, w(147,64), out, n, h, w, ho, wo, pad_top, pad_left, stream
    "stem_conv7x7s2_bf16": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # scores, descs, fused, weights, scheme, b, v, c, m, ceil_sum, stream
    "group_and_fuse_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                           "port's CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> dict:
    """Compile the sources unless a library for them exists.

    Returns {"path", "compiled", "seconds", "log"}; `log` is nvcc's output
    (ptxas register and shared-memory counts) when it compiled.
    """
    path = library_path()
    if path.exists():
        return {"path": str(path), "compiled": False, "seconds": 0.0,
                "log": ""}
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{proc.stderr}"
                f"{proc.stdout}")
        os.replace(tmp, path)  # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    log = proc.stdout + proc.stderr
    (path.parent / "nvcc.log").write_text(log)
    return {"path": str(path), "compiled": True,
            "seconds": time.perf_counter() - t0, "log": log}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes.

    Loaded once per process: a launch must not pay for hashing sources."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build()["path"]
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(code: int, name: str):
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")
