"""Decode-once view cache: image tree -> uint8 memmap, streamed every epoch
(counterpart of `gvcnn_tf_tpu/data/decoded_cache.py`, numpy only).

The first pass decodes and resizes every view ONCE, through the C++ decode
pool (`data/native_loader.py`; PIL only where the pool cannot be built and
PIL imports, said in the log) into a flat uint8 memmap next to the data;
every later epoch, and every later run at the same geometry, streams
batches straight from the memmap with no decode cost.  With
`transfer_dtype="uint8"` the host's input work is a memcpy.

The cache is the JAX package's, file for file: the same key, layout, tmp
sweep and atomic publish, so either package reuses a cache the other
wrote.

    <cache_dir>/decoded_<key>.u8      raw (N, V, H, W, 3) uint8, C-order
    <cache_dir>/decoded_<key>.json    {"labels": [...], "shape_ids": [...],
                                       "classes": [...], "geometry": [...]}

The key hashes the shape list (ids + per-view file paths + mtimes), so
re-rendering or adding shapes rebuilds automatically.

    it = decoded_dataset("/data/views", num_views=12, height=224,
                         width=224, batch_size=32, train=True)
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np


def _decode_one_pil(path: str, height: int, width: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((width, height), Image.BILINEAR)
        return np.asarray(im, np.uint8)


def _decoder(num_threads: int):
    """The native pool's decoder, else None when PIL is to decode; raises
    when neither can."""
    from gvcnn_tf_tpu_torch.data import native_loader
    from gvcnn_tf_tpu_torch.metrics import log

    try:
        return native_loader.NativeDecoder(num_threads)
    except RuntimeError as e:
        try:
            import PIL  # noqa: F401
        except ImportError:
            raise RuntimeError(
                f"the decoded cache needs the native decode pool or PIL, "
                f"and neither is here: {e}; PIL does not import") from e
        log(f"decoded cache: decoding with PIL ({str(e).splitlines()[0]})")
        return None


def cache_paths(
    image_root: str,
    *,
    num_views: int,
    height: int,
    width: int,
    cache_dir: Optional[str] = None,
) -> Tuple[list, list, str, str]:
    """The tree's usable shapes, its classes and where their cache lives
    -> (shapes, classes, data_path, meta_path); makes the cache directory.
    """
    from gvcnn_tf_tpu_torch.data.tfrecord import discover_shapes

    shapes, classes = discover_shapes(image_root)
    shapes = [(sid, lbl, v[:num_views]) for sid, lbl, v in shapes
              if len(v) >= num_views]
    if not shapes:
        raise ValueError(
            f"no shapes with >= {num_views} views in {image_root}")
    cache_dir = cache_dir or os.path.join(image_root, ".gvcnn_decoded")
    os.makedirs(cache_dir, exist_ok=True)
    h = hashlib.sha256()
    h.update(f"{num_views}x{height}x{width}".encode())
    for sid, lbl, views in shapes:
        h.update(sid.encode())
        for v in views:
            h.update(f"{v}:{os.path.getmtime(v):.3f}".encode())
    key = h.hexdigest()[:24]
    return (shapes, classes, os.path.join(cache_dir, f"decoded_{key}.u8"),
            os.path.join(cache_dir, f"decoded_{key}.json"))


def build_decoded_cache(
    image_root: str,
    *,
    num_views: int,
    height: int,
    width: int,
    cache_dir: Optional[str] = None,
    num_threads: int = 0,
) -> Tuple[str, str]:
    """Ensure the decoded memmap exists; -> (data_path, meta_path)."""
    shapes, classes, data_path, meta_path = cache_paths(
        image_root, num_views=num_views, height=height, width=width,
        cache_dir=cache_dir)
    cache_dir = os.path.dirname(data_path)
    if os.path.exists(data_path) and os.path.exists(meta_path):
        return data_path, meta_path

    # Sweep stale tmp leftovers from builders that died mid-decode (each is
    # the FULL dataset size).  An hour is far past any live build's write
    # cadence, and a live builder keeps refreshing its file's mtime.
    for fname in os.listdir(cache_dir):
        if ".tmp" in fname and fname.startswith("decoded_"):
            p = os.path.join(cache_dir, fname)
            try:
                if time.time() - os.path.getmtime(p) > 3600:
                    os.unlink(p)
            except OSError:
                pass

    n = len(shapes)
    # pid-suffixed tmp: concurrent builders each write their own file;
    # whoever publishes first wins and the others' byte-identical result
    # replaces it.
    tmp_data = f"{data_path}.tmp{os.getpid()}"
    tmp_meta = f"{meta_path}.tmp{os.getpid()}"
    try:
        decoder = _decoder(num_threads)
        mm = np.memmap(tmp_data, np.uint8, mode="w+",
                       shape=(n, num_views, height, width, 3))
        for i, (sid, lbl, views) in enumerate(shapes):
            if decoder is not None:
                blobs = []
                for v in views:
                    with open(v, "rb") as f:
                        blobs.append(f.read())
                mm[i] = decoder.decode(blobs, height, width, dtype=np.uint8)
            else:
                for vi, v in enumerate(views):
                    mm[i, vi] = _decode_one_pil(v, height, width)
        mm.flush()
        del mm
        meta = {
            "labels": [int(lbl) for _, lbl, _ in shapes],
            "shape_ids": [sid for sid, _, _ in shapes],
            "classes": classes,
            "geometry": [n, num_views, height, width, 3],
        }
        with open(tmp_meta, "w") as f:
            json.dump(meta, f)
    except BaseException:
        # A failed/killed build must not strand a dataset-sized tmp file.
        for p in (tmp_data, tmp_meta):
            try:
                os.unlink(p)
            except OSError:
                pass
        raise
    os.replace(tmp_data, data_path)                # atomic publish
    os.replace(tmp_meta, meta_path)
    return data_path, meta_path


def decoded_dataset(
    image_root: str,
    *,
    num_views: int,
    height: int,
    width: int,
    batch_size: int,
    train: bool = True,
    num_epochs: Optional[int] = None,
    seed: int = 0,
    cache_dir: Optional[str] = None,
    shard_index: int = 0,
    num_shards: int = 1,
    raw_uint8: bool = False,
    num_threads: int = 0,
    augment: bool = True,
) -> Iterator[dict]:
    """Iterator of {'views', 'label'} batches from the decoded memmap,
    batch for batch the JAX package's.

    Train drops the ragged tail and repeats shuffled; eval yields the short
    tail once.  `raw_uint8=True` yields uint8 views for
    `transfer_dtype="uint8"`; otherwise float32 in [-1, 1].  Training
    batches get a per-view random horizontal flip on the host when
    `augment`; with `device_flip` the pipeline passes `augment=False` and
    the train step flips on the card instead.  The cache stores pre-resized
    pixels, so there is no random-crop jitter here.  Eval batches are
    always deterministic.
    """
    data_path, meta_path = build_decoded_cache(
        image_root, num_views=num_views, height=height, width=width,
        cache_dir=cache_dir, num_threads=num_threads)
    with open(meta_path) as f:
        meta = json.load(f)
    labels = np.asarray(meta["labels"], np.int32)
    n = len(labels)
    mm = np.memmap(data_path, np.uint8, mode="r",
                   shape=tuple(meta["geometry"]))
    shard = np.arange(n)[shard_index::num_shards]
    if train and len(shard) < batch_size:
        # An empty per-epoch loop under num_epochs=None would spin forever
        # without yielding; fail loudly instead.
        raise ValueError(
            f"shard {shard_index}/{num_shards} has {len(shard)} shapes < "
            f"batch_size {batch_size} — reduce batch_size or shards")
    order_rng = np.random.RandomState(seed + 13 + shard_index)
    aug_rng = np.random.RandomState(seed + 517 + shard_index)
    do_aug = train and augment
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = (shard[order_rng.permutation(len(shard))] if train
                 else shard)
        last = len(order) - batch_size + 1 if train else len(order)
        for start in range(0, last, batch_size):
            idx = np.sort(order[start:start + batch_size])  # memmap-friendly
            v = mm[idx]
            if do_aug:
                # Fancy indexing above already copied out of the memmap;
                # flip the W axis of a random half of the (shape, view)
                # slots in place, one strided pass over the flipped half.
                flip = aug_rng.rand(len(idx), v.shape[1]) < 0.5
                for s_i, v_i in zip(*np.nonzero(flip)):
                    v[s_i, v_i] = v[s_i, v_i, :, ::-1]
            if not raw_uint8:
                v = v.astype(np.float32) / 255.0 * 2.0 - 1.0
            else:
                v = np.ascontiguousarray(v)
            yield {"views": v, "label": labels[idx]}
        epoch += 1
