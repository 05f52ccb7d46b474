"""Builds the port's CUDA kernels at first use and loads them with ctypes.

`nvcc` compiles every `gvcnn_tf_tpu_torch/csrc/*.cu` into an object file,
one process per source, all started together, and links them into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under `build/gvcnn_tf_tpu_torch/<hash of the sources>/` at
the root of the checkout.  A library whose sources are unchanged is loaded
without a rebuild.  Each entry point launches one kernel on the stream it is
given and returns `cudaGetLastError()` as an int; `launch` calls one, raises
when that is not 0 and counts it in `launches` under its name.  A failed
build raises with nvcc's output: there is no fallback.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "gvcnn_tf_tpu_torch"
LIB_NAME = "libgvcnn_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points; the last argument is the cudaStream_t.
_SIGNATURES = {
    # x, w(176,64), scale, shift, out, n, h, w, ho, wo, pad_top, pad_left,
    # relu, stream
    "stem_conv7x7s2_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P),
    "stem_conv7x7s2_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P),
    # scores, descs, fused, weights, scheme, b, v, c, m, ceil_sum, stream
    "group_and_fuse_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, y, slot (or None), n, h, w, c, ho, wo, k, s, pad_top, pad_left,
    # stream; the backward's: dy, slot, dx, then the same
    **{f"max_pool_same_{way}_{dtype}": (_P, _P, _P) + (_I,) * 10 + (_P,)
       for way in ("fwd", "bwd") for dtype in ("bf16", "f32")},
    # x, y, n, h, w, c, stream; the backward's: dy, dx, then the same
    **{f"avg_pool_same_{way}_{dtype}": (_P, _P) + (_I,) * 4 + (_P,)
       for way in ("fwd", "bwd") for dtype in ("bf16", "f32")},
    # Train-mode BatchNorm (csrc/batch_norm.cu).  stats: x, part, ticket,
    # mean, invstd, running_mean, running_var, rows, c, lanes, tv,
    # chunk_rows, chunks, tiles, group, eps, momentum, 1 - momentum, update,
    # stream; apply: x, y, mean, invstd, weight, bias, rows, c, lanes, tv,
    # chunk_rows, chunks, tiles, relu, stream; bwd_reduce: dy, x, mean,
    # invstd, weight, bias, part, ticket, dweight, dbias, coef, rows, c, ldg,
    # lanes, tv, chunk_rows, chunks, tiles, group, relu, stream; bwd_elemt:
    # dy, x, mean, invstd, weight, bias, coef, dx, rows, c, ldg, lanes, tv,
    # chunk_rows, chunks, tiles, relu, stream; apply_residual: x, res, out,
    # mean, invstd, weight, bias, rows, c, lanes, tv, chunk_rows, chunks,
    # tiles, stream; bwd_reduce_residual: dy, out, x, g, mean, invstd,
    # weight, bias, part, ticket, dweight, dbias, coef, rows, c, ldg, lanes,
    # tv, chunk_rows, chunks, tiles, group, stream
    **{f"batch_norm_{kernel}_{dtype}": args
       for dtype in ("bf16", "f32")
       for kernel, args in (
           ("stats", (_P,) * 7 + (_I,) * 8 + (_F,) * 3 + (_I, _P)),
           ("apply", (_P,) * 6 + (_I,) * 8 + (_P,)),
           ("bwd_reduce", (_P,) * 11 + (_I,) * 10 + (_P,)),
           ("bwd_elemt", (_P,) * 8 + (_I,) * 9 + (_P,)),
           ("apply_residual", (_P,) * 7 + (_I,) * 7 + (_P,)),
           ("bwd_reduce_residual", (_P,) * 13 + (_I,) * 9 + (_P,)))},
    # The residual join (csrc/residual_join.cu).  fwd: x, u, bias, y, rows,
    # c, lanes, scale, relu, stream; bwd: dy, y, dx, du, part, rows, c,
    # lanes, tv, chunk_rows, chunks, tiles, scale, relu, stream; bias_grad:
    # part, dbias, c, chunks, stream
    **{f"residual_join_fwd_{dtype}": (_P,) * 4 + (_I,) * 3 + (_F, _I, _P)
       for dtype in ("bf16", "f32")},
    **{f"residual_join_bwd_{dtype}": (_P,) * 5 + (_I,) * 7 + (_F, _I, _P)
       for dtype in ("bf16", "f32")},
    "residual_join_bias_grad": (_P, _P, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
# Launches of each entry point by its name in `_SIGNATURES`, in this
# process; a CUDA graph's replay adds what its capture launched
# (`utils/graphs.py`).
launches: collections.Counter = collections.Counter()


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
    tmpdir = tempfile.mkdtemp(dir=path.parent)
    t0 = time.perf_counter()
    try:
        objs = [os.path.join(tmpdir, f"{src.stem}.o") for src in _sources()]
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(_sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        for p, out in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with code {p.returncode}:\n{out}")
        lib = os.path.join(tmpdir, LIB_NAME)
        proc = subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", lib, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to link with code {proc.returncode}:\n"
                f"{proc.stderr}{proc.stdout}")
        os.replace(lib, path)  # atomic: a reader never sees a partial file
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    log = "".join(logs) + proc.stdout + proc.stderr
    (path.parent / "nvcc.log").write_text(log)
    return {"path": str(path), "compiled": True,
            "seconds": time.perf_counter() - t0, "log": log}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes.

    Loaded once per process: a launch must not pay for hashing sources.
    The build or load is a `kernels.build` span (`utils/profiling.py`)."""
    global _lib
    if _lib is not None:
        return _lib
    # Imported here: the utilities import the models, which import the ops.
    from gvcnn_tf_tpu_torch.utils import profiling

    with _lock:
        if _lib is None:
            with profiling.span("kernels.build"):
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


def launch(name: str, device: torch.device, *args) -> None:
    """Launch entry point `name` with `args` on `device`'s current stream,
    raise if it failed and count it."""
    with torch.cuda.device(device):
        code = getattr(library(), name)(
            *args, torch.cuda.current_stream().cuda_stream)
    check(code, name)
    launches[name] += 1


def launched(prefix: str = "") -> int:
    """The launches counted so far of the entry points whose names start
    with `prefix` (`"stem_conv7x7s2"`: both stems)."""
    return sum(n for name, n in launches.items() if name.startswith(prefix))
