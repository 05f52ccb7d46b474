"""ctypes bindings and dataset for the native C++ multi-view loader
(counterpart of `gvcnn_tf_tpu/data/native_loader.py`).

Two shared libraries are built from `data/native/`:

  libgvloader.so   `loader.cc`, a verbatim copy of the JAX package's decode
                   pool (threaded JPEG/PNG decode, bilinear resize, [-1, 1]
                   or raw uint8 output straight into a caller-owned
                   buffer), and `extras.cc`, JPEG encoding for the tools;
                   links libjpeg and libpng.
  libgvrecords.so  `records.cc`: the TFRecord CRC and an image's size from
                   its header; needs nothing beyond the C++ runtime, so the
                   TFRecord framing works where libjpeg or libpng is
                   missing.

Python's job is only IO and batching; a background thread keeps batches
ready.  Each library is built with `g++` and the JAX Makefile's flags at
first use, never at import, into `build/gvcnn_tf_tpu_torch/native/<key>/`
at the root of the checkout.  The key hashes the library's sources, the
flags and what `-march=native` means on this host (`g++ -march=native -Q
--help=target`), so a checkout copied to a machine with another CPU builds
its own.  A build takes a file lock, compiles to a temporary file and
publishes it with an atomic rename, so concurrent processes never load a
partial library.  A missing compiler, header or library raises
`RuntimeError` naming it; nothing here falls back to another decoder.

    from gvcnn_tf_tpu_torch.data import native_loader
    it = native_loader.native_dataset("/data/views", num_views=12,
                                      height=224, width=224, batch_size=8)
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import queue
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent / "native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDLIBS = ("-ljpeg", "-lpng", "-lpthread")
LIB_NAME, RECORDS_LIB = "libgvloader.so", "libgvrecords.so"
# library -> (sources, link libraries)
LIBRARIES = {LIB_NAME: (("loader.cc", "extras.cc"), LDLIBS),
             RECORDS_LIB: (("records.cc",), ())}
BUILD_ROOT = _NATIVE_DIR.parents[2] / "build" / "gvcnn_tf_tpu_torch" / "native"

# What a failed build's output says -> what is missing.
_MISSING = (
    ("jpeglib.h", "libjpeg's header jpeglib.h (the libjpeg development "
                  "package)"),
    ("png.h", "libpng's header png.h (the libpng development package)"),
    ("-ljpeg", "the libjpeg library (libjpeg.so)"),
    ("-lpng", "the libpng library (libpng.so)"),
)

_P = ctypes.c_void_p
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    LIB_NAME: {
        "gvl_create": (_P, [ctypes.c_int]),
        "gvl_destroy": (None, [_P]),
        "gvl_decode_batch": (ctypes.c_int, [
            _P, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _U8P, ctypes.POINTER(ctypes.c_float)]),
        "gvl_decode_batch_u8": (ctypes.c_int, [
            _P, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _U8P, _U8P]),
        "gvx_encode_jpeg": (ctypes.c_long, [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(_U8P)]),
        "gvx_free": (None, [_P]),
    },
    RECORDS_LIB: {
        "gvx_masked_crc32c": (ctypes.c_uint32, [ctypes.c_char_p,
                                                ctypes.c_size_t]),
        "gvx_image_size": (ctypes.c_int, [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_errors: Dict[str, str] = {}
_target: Optional[str] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("native loader unavailable: no C++ compiler (g++ "
                           "not on PATH, CXX unset)")
    return cxx


def library_path(name: str = LIB_NAME) -> Path:
    """Where library `name` for its sources, the flags and this host's CPU
    lives."""
    global _target
    if _target is None:
        _target = subprocess.run(
            [_cxx(), "-march=native", "-Q", "--help=target"],
            capture_output=True, text=True).stdout
    sources, libs = LIBRARIES[name]
    h = hashlib.sha256(" ".join(CXXFLAGS + libs).encode())
    h.update(_target.encode())
    for src in sources:
        h.update(src.encode())
        h.update((_NATIVE_DIR / src).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / name


def _explain(output: str) -> str:
    missing = [what for needle, what in _MISSING if needle in output]
    head = (f"missing {', '.join(missing)}" if missing
            else "the C++ build failed")
    return f"native loader unavailable: {head}\n{output.strip()}"


def build(name: str = LIB_NAME) -> dict:
    """Compile library `name` unless it exists -> {"path", "compiled"}."""
    path = library_path(name)
    if path.exists():
        return {"path": str(path), "compiled": False}
    sources, libs = LIBRARIES[name]
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when closed
        if path.exists():                     # another process built it
            return {"path": str(path), "compiled": False}
        tmp = path.parent / f".{name}.tmp{os.getpid()}"
        try:
            proc = subprocess.run(
                [_cxx(), *CXXFLAGS, "-shared", "-o", str(tmp),
                 *(str(_NATIVE_DIR / s) for s in sources), *libs],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(_explain(proc.stderr + proc.stdout))
            os.replace(tmp, path)             # atomic publish
        finally:
            tmp.unlink(missing_ok=True)
    return {"path": str(path), "compiled": True}


def library(name: str = LIB_NAME) -> ctypes.CDLL:
    """Library `name` loaded (the decode pool by default), built first if
    needed; raises `RuntimeError` with the reason (cached: a failed build
    is not retried in this process) when it cannot be built or loaded."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs and name not in _errors:
            try:
                lib = ctypes.CDLL(build(name)["path"])
                for fn_name, (res, args) in _SIGNATURES[name].items():
                    fn = getattr(lib, fn_name)
                    fn.restype, fn.argtypes = res, args
                _libs[name] = lib
            except (OSError, RuntimeError) as e:
                msg = str(e)
                _errors[name] = (msg if msg.startswith(
                    "native loader unavailable") else
                    f"native loader unavailable: {msg}")
        if name in _errors:
            raise RuntimeError(_errors[name])
    return _libs[name]


def available() -> bool:
    """Whether the decode pool builds and loads here."""
    try:
        library()
    except RuntimeError:
        return False
    return True


def masked_crc32c(data: bytes) -> int:
    """TensorFlow's masked CRC32C of `data` (the TFRecord checksum)."""
    return int(library(RECORDS_LIB).gvx_masked_crc32c(data, len(data)))


def image_size(blob: bytes) -> Tuple[int, int]:
    """(height, width) of an encoded PNG or JPEG, from its header."""
    h, w = ctypes.c_int(), ctypes.c_int()
    if library(RECORDS_LIB).gvx_image_size(blob, len(blob), ctypes.byref(h),
                                           ctypes.byref(w)) != 0:
        raise ValueError("not a PNG or JPEG image (or a cut header)")
    return h.value, w.value


def encode_jpeg(rgb: np.ndarray, quality: int = 90) -> bytes:
    """An (H, W, 3) uint8 image as JPEG bytes through libjpeg."""
    lib = library()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    out = _U8P()
    n = lib.gvx_encode_jpeg(rgb.ctypes.data_as(_U8P), rgb.shape[0],
                            rgb.shape[1], int(quality), ctypes.byref(out))
    if n < 0:
        raise RuntimeError("libjpeg failed to encode the image")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.gvx_free(out)


class NativeDecoder:
    """Threaded decode of a list of encoded blobs -> (N, H, W, 3) float32."""

    def __init__(self, num_threads: int = 0):
        self._lib = library()
        self._h = self._lib.gvl_create(num_threads)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gvl_destroy(self._h)
            self._h = None

    def decode(
        self,
        blobs: Sequence[bytes],
        height: int,
        width: int,
        flips: Optional[np.ndarray] = None,
        out: Optional[np.ndarray] = None,
        dtype=np.float32,
    ) -> np.ndarray:
        """`dtype=np.float32` -> normalized [-1, 1]; `dtype=np.uint8` ->
        raw [0, 255] bytes (post-resize round) for transfer_dtype='uint8'
        runs where the device normalizes (utils/images.py)."""
        n = len(blobs)
        dtype = np.dtype(dtype)
        if out is None:
            out = np.empty((n, height, width, 3), dtype)
        assert out.shape == (n, height, width, 3) and out.dtype == dtype
        arr_blobs = (ctypes.c_char_p * n)(*blobs)
        arr_sizes = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
        if flips is None:
            flips_ptr = None
        else:
            flips = np.ascontiguousarray(flips, np.uint8)
            flips_ptr = flips.ctypes.data_as(_U8P)
        if dtype == np.uint8:
            failures = self._lib.gvl_decode_batch_u8(
                self._h, arr_blobs, arr_sizes, n, height, width, flips_ptr,
                out.ctypes.data_as(_U8P),
            )
        elif dtype == np.float32:
            failures = self._lib.gvl_decode_batch(
                self._h, arr_blobs, arr_sizes, n, height, width, flips_ptr,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        else:
            raise ValueError(f"unsupported decode dtype {dtype}")
        if failures:
            raise ValueError(f"{failures}/{n} images failed to decode")
        return out


def native_dataset(
    image_root: str,
    *,
    num_views: int,
    height: int,
    width: int,
    batch_size: int,
    train: bool = True,
    num_epochs: Optional[int] = None,
    seed: int = 0,
    num_threads: int = 0,
    prefetch: int = 2,
    shard_index: int = 0,
    num_shards: int = 1,
    raw_uint8: bool = False,
) -> Iterator[dict]:
    """Stream (B, V, H, W, 3) batches straight from a rendered-view tree,
    batch for batch the JAX package's `native_dataset`.

    Python reads files, the C++ pool decodes them, and a background thread
    keeps `prefetch` batches ready.  Same layout rules as the TFRecord
    builder (data/tfrecord.discover_shapes).
    """
    from gvcnn_tf_tpu_torch.data.tfrecord import discover_shapes

    shapes, _ = discover_shapes(image_root)
    shapes = [(sid, lbl, v[:num_views]) for sid, lbl, v in shapes
              if len(v) >= num_views]
    if num_shards > 1:  # multi-host: disjoint shape subset per process
        shapes = shapes[shard_index::num_shards]
    if not shapes:
        raise ValueError(f"no shapes with >= {num_views} views in {image_root}")

    decoder = NativeDecoder(num_threads)
    rng = np.random.RandomState(seed)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        epoch = 0
        try:
            while not stop.is_set() and (num_epochs is None or epoch < num_epochs):
                order = rng.permutation(len(shapes)) if train else np.arange(len(shapes))
                # Train drops the ragged tail (stream repeats); eval yields
                # the short tail so the full split is scored.
                last = len(shapes) - batch_size + 1 if train else len(shapes)
                for s in range(0, last, batch_size):
                    if stop.is_set():
                        return
                    idx = order[s:s + batch_size]
                    n = len(idx)
                    blobs: List[bytes] = []
                    labels = np.empty(n, np.int32)
                    for bi, si in enumerate(idx):
                        _, lbl, views = shapes[si]
                        labels[bi] = lbl
                        for v in views:
                            with open(v, "rb") as f:
                                blobs.append(f.read())
                    flips = (
                        rng.randint(0, 2, len(blobs)).astype(np.uint8)
                        if train else None
                    )
                    flat = decoder.decode(
                        blobs, height, width, flips,
                        dtype=np.uint8 if raw_uint8 else np.float32)
                    q.put({
                        "views": flat.reshape(n, num_views, height, width, 3),
                        "label": labels,
                    })
                epoch += 1
        except BaseException as e:  # surface pipeline crashes to the consumer
            q.put(e)                # (a swallowed error looks like clean EOF)
        finally:
            q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # Drain so the producer can exit its q.put.
        while not q.empty():
            q.get_nowait()
