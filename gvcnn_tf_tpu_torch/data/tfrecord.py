"""TFRecord schema, offline builder and reader for multi-view shapes,
without TensorFlow (counterpart of `gvcnn_tf_tpu/data/tfrecord.py`).

The files are the JAX package's, byte compatible both ways: each holds
TFRecord frames (a u64 length, the masked CRC32C of the length, the data,
the masked CRC32C of the data), and each frame one `tf.train.Example`,
serialized and parsed here by hand:

  image/encoded     : bytes_list, V encoded JPEG/PNG views
  image/format      : bytes       ('jpeg' | 'png')
  image/class/label : int64
  shape/id          : bytes       (shape identifier, e.g. 'chair/chair_0001')

The CRCs are computed in C++ (`data/native/records.cc`): a per-byte loop in
Python over a ~600 KB record would cap the reader far below what a train
step needs.  The reader refuses a frame whose CRC is wrong.  Views decode
at the image's own size through the native pool (or PIL where the pool
cannot be built, said in the log: `image_decoder`); the `square` and `slim`
geometries then run as torch ops on the host, at TF's arithmetic
(`tf.image.resize` is `F.interpolate(mode="bilinear",
align_corners=False)`, antialiased where TF is; `central_crop` and
`sample_distorted_bounding_box` are re-derived below).  What cannot be
matched is TF's random number stream: train mode draws its file order,
shuffle, crops and flips from numpy generators seeded by `seed`.

Directory layouts accepted by the builder (ModelNet MVCNN-style renders):
  root/<class>/<shape_id>/<view>.png          (one dir per shape)
  root/<class>/<shape>_v01.png ...            (flat, grouped by stem prefix)
"""

from __future__ import annotations

import glob
import io
import math
import os
import re
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_VIEW_SUFFIX = re.compile(r"[._-]v?(\d+)$")
_IMG_EXTS = (".jpg", ".jpeg", ".png")


def discover_shapes(root: str) -> Tuple[List[Tuple[str, int, List[str]]], List[str]]:
    """Walk a rendered-view tree -> ([(shape_id, label, [view paths])], classes)."""
    # Hidden directories are never classes — the decoded-view cache lives
    # at <root>/.gvcnn_decoded and counting it would shift every label.
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)) and not d.startswith(".")
    )
    shapes: List[Tuple[str, int, List[str]]] = []
    for label, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        subdirs = sorted(
            d for d in os.listdir(cdir)
            if os.path.isdir(os.path.join(cdir, d)) and not d.startswith(".")
        )
        if subdirs:  # layout 1: one dir per shape
            for sid in subdirs:
                views = sorted(
                    os.path.join(cdir, sid, f)
                    for f in os.listdir(os.path.join(cdir, sid))
                    if f.lower().endswith(_IMG_EXTS)
                )
                if views:
                    shapes.append((f"{cls}/{sid}", label, views))
        else:  # layout 2: flat files grouped by stem prefix
            groups: Dict[str, List[str]] = {}
            for f in sorted(os.listdir(cdir)):
                if not f.lower().endswith(_IMG_EXTS):
                    continue
                stem = os.path.splitext(f)[0]
                key = _VIEW_SUFFIX.sub("", stem)
                groups.setdefault(key, []).append(os.path.join(cdir, f))
            for sid, views in sorted(groups.items()):
                shapes.append((f"{cls}/{sid}", label, sorted(views)))
    return shapes, classes


# ---------------------------------------------------------------------------
# tf.train.Example by hand (protobuf wire format)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1                      # int64 two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def encode_example(features: Dict[str, object]) -> bytes:
    """Serialize {key: list of bytes | list of int} as a tf.train.Example
    (bytes -> BytesList, int -> packed Int64List), keys in the given
    order."""
    entries = []
    for key, values in features.items():
        if all(isinstance(v, bytes) for v in values):
            feature = _field(1, b"".join(_field(1, v) for v in values))
        elif all(isinstance(v, (int, np.integer)) for v in values):
            feature = _field(3, _field(1, b"".join(
                _varint(int(v)) for v in values)))
        else:
            raise TypeError(f"feature {key!r}: bytes or ints, got {values!r}")
        entries.append(_field(1, _field(1, key.encode()) + _field(2, feature)))
    return _field(1, b"".join(entries))


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if b < 0x80:
            return n, i
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a message's fields."""
    i, end = 0, len(buf)
    while i < end:
        tag, i = _read_varint(buf, i)
        num, wt = tag >> 3, tag & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
        elif wt == 2:
            n, i = _read_varint(buf, i)
            val, i = buf[i:i + n], i + n
        elif wt == 5:
            val, i = buf[i:i + 4], i + 4
        elif wt == 1:
            val, i = buf[i:i + 8], i + 8
        else:
            raise ValueError(f"malformed Example: wire type {wt}")
        yield num, wt, val
    if i != end:
        raise ValueError("malformed Example: truncated field")


def _int64(n: int) -> int:
    return n - (1 << 64) if n >= 1 << 63 else n


def decode_example(serialized: bytes) -> Dict[str, list]:
    """Parse a tf.train.Example -> {key: list of bytes | ints} (a float
    feature, which this schema has none of, parses as an empty list)."""
    out: Dict[str, list] = {}
    for num, _, features in _fields(serialized):
        if num != 1:
            continue
        for fnum, _, entry in _fields(features):
            if fnum != 1:
                continue
            key, values = None, []
            for enum, _, ev in _fields(entry):
                if enum == 1:
                    key = ev.decode()
                elif enum == 2:
                    for kind, _, lst in _fields(ev):
                        for vnum, vwt, v in _fields(lst):
                            if vnum != 1:
                                continue
                            if kind == 1:                       # BytesList
                                values.append(bytes(v))
                            elif kind == 3 and vwt == 0:        # Int64List
                                values.append(_int64(v))
                            elif kind == 3:                     # packed
                                j = 0
                                while j < len(v):
                                    x, j = _read_varint(v, j)
                                    values.append(_int64(x))
            out[key] = values
    return out


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

def write_record(f, data: bytes) -> None:
    from gvcnn_tf_tpu_torch.data.native_loader import masked_crc32c

    length = struct.pack("<Q", len(data))
    f.write(length)
    f.write(struct.pack("<I", masked_crc32c(length)))
    f.write(data)
    f.write(struct.pack("<I", masked_crc32c(data)))


def read_records(path: str) -> Iterator[bytes]:
    """Every record of one TFRecord file, each frame's CRCs checked."""
    from gvcnn_tf_tpu_torch.data.native_loader import masked_crc32c

    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise ValueError(f"{path}: truncated record header")
            length, = struct.unpack("<Q", head[:8])
            if struct.unpack("<I", head[8:])[0] != masked_crc32c(head[:8]):
                raise ValueError(f"{path}: corrupted record (length CRC)")
            data = f.read(length)
            tail = f.read(4)
            if len(data) < length or len(tail) < 4:
                raise ValueError(f"{path}: truncated record")
            if struct.unpack("<I", tail)[0] != masked_crc32c(data):
                raise ValueError(f"{path}: corrupted record (data CRC)")
            yield data


def count_records(path: str) -> int:
    """Frames in a file, read from the length fields alone."""
    n, size = 0, os.path.getsize(path)
    with open(path, "rb") as f:
        while f.tell() < size:
            length, = struct.unpack("<Q", f.read(8))
            f.seek(4 + length + 4, os.SEEK_CUR)
            n += 1
    return n


def build_tfrecords(
    image_root: str,
    output_dir: str,
    num_views: int,
    *,
    split_name: str = "train",
    num_shards: int = 4,
) -> List[str]:
    """Offline converter (reference C7 parity): image tree -> sharded TFRecords.

    Shapes with fewer than `num_views` views are dropped; extras truncated
    (the reference assumes exactly V renders per shape [MED]).
    """
    shapes, classes = discover_shapes(image_root)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "labels.txt"), "w") as f:
        f.write("\n".join(classes))

    paths = [
        os.path.join(
            output_dir, f"{split_name}-{i:05d}-of-{num_shards:05d}.tfrecord"
        )
        for i in range(num_shards)
    ]
    writers = [open(p, "wb") for p in paths]
    written = 0
    try:
        for i, (sid, label, views) in enumerate(shapes):
            if len(views) < num_views:
                continue
            views = views[:num_views]
            encoded = [open(v, "rb").read() for v in views]
            fmt = b"png" if views[0].lower().endswith(".png") else b"jpeg"
            ex = encode_example({
                "image/encoded": encoded,
                "image/format": [fmt],
                "image/class/label": [label],
                "shape/id": [sid.encode()],
            })
            write_record(writers[i % num_shards], ex)
            written += 1
    finally:
        for w in writers:
            w.close()
    if written == 0:
        raise ValueError(
            f"no shapes with >= {num_views} views found under {image_root}"
        )
    return paths


# ---------------------------------------------------------------------------
# Geometry: TF's arithmetic with torch ops on the host
# ---------------------------------------------------------------------------

def central_crop_box(h: int, w: int, fraction: float) -> Tuple[int, int, int, int]:
    """`tf.image.central_crop`'s box -> (top, left, height, width)."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError("central_fraction must be within (0, 1]")
    if fraction == 1.0:
        return 0, 0, h, w
    top = int((h - h * fraction) / 2)
    left = int((w - w * fraction) / 2)
    return top, left, h - 2 * top, w - 2 * left


def _lrintf(x: float) -> int:
    """C's lrintf: round half to even (the default rounding mode)."""
    return int(np.rint(np.float32(x)))


def sample_distorted_bounding_box(
    h: int, w: int, rng: np.random.RandomState, *,
    min_object_covered: float = 0.1,
    aspect_ratio_range: Tuple[float, float] = (0.75, 1.333),
    area_range: Tuple[float, float] = (0.05, 1.0),
    max_attempts: int = 100,
) -> Tuple[int, int, int, int]:
    """`tf.image.sample_distorted_bounding_box` with the whole image as the
    only box (`use_image_if_no_bounding_boxes`) -> (top, left, height,
    width).  TF's sampler (`sample_distorted_bounding_box_op.cc`,
    `GenerateRandomCrop`) step for step, with numpy's generator in place
    of TF's: each attempt draws an aspect ratio, a height between the
    least and the most area it allows, then the corner; the first crop
    that covers `min_object_covered` of the image wins, else the whole
    image."""
    f32 = np.float32
    min_area = f32(area_range[0]) * f32(w) * f32(h)
    max_area = f32(area_range[1]) * f32(w) * f32(h)
    for _ in range(max_attempts):
        aspect = f32(f32(rng.random_sample()) * f32(
            aspect_ratio_range[1] - aspect_ratio_range[0])
            + f32(aspect_ratio_range[0]))
        height = _lrintf(math.sqrt(min_area / aspect))
        max_height = _lrintf(math.sqrt(max_area / aspect))
        if _lrintf(max_height * aspect) > w:
            max_height = int((w + 0.5 - 1e-7) / aspect)
            if _lrintf(max_height * aspect) > w:
                max_height -= 1
        max_height = min(max_height, h)
        height = min(height, max_height)
        if height < max_height:
            height += rng.randint(0, max_height - height + 1)
        width = _lrintf(height * aspect)
        area = width * height
        if area < min_area:
            height += 1
            width = _lrintf(height * aspect)
            area = width * height
        if area > max_area:
            height -= 1
            width = _lrintf(height * aspect)
            area = width * height
        if (area < min_area or area > max_area or width > w or height > h
                or width <= 0 or height <= 0):
            continue
        # The one box is the whole image: the crop covers area / (h w) of it.
        if area / float(h * w) < min_object_covered:
            continue
        top = rng.randint(0, h - height) if height < h else 0
        left = rng.randint(0, w - width) if width < w else 0
        return top, left, height, width
    return 0, 0, h, w


def _resize(x, size: Tuple[int, int], antialias: bool):
    """`tf.image.resize(..., method="bilinear")` on (N, C, H, W) float."""
    import torch.nn.functional as F

    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=antialias)


def preprocess_views(
    imgs: np.ndarray, *, height: int, width: int, train: bool,
    augment: bool, preprocessing: str, crop_fraction: float,
    rng: Optional[np.random.RandomState], raw_uint8: bool,
) -> np.ndarray:
    """Decoded (N, h, w, 3) uint8 views of one size -> (N, H, W, 3): float32
    in [-1, 1], or with `raw_uint8` uint8 rounded after the float geometry
    (the JAX reader's `decode_one`)."""
    import torch

    x = torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255.0
    h0, w0 = imgs.shape[1:3]
    if preprocessing == "square":
        big = (int(height / crop_fraction), int(width / crop_fraction))
        x = _resize(x, big, antialias=True)
        if train and augment:
            outs = []
            for img in x:
                top = rng.randint(0, big[0] - height + 1)
                left = rng.randint(0, big[1] - width + 1)
                img = img[:, top:top + height, left:left + width]
                outs.append(img.flip(-1) if rng.random_sample() < 0.5
                            else img)
            x = torch.stack(outs)
        else:
            top, left = (big[0] - height) // 2, (big[1] - width) // 2
            x = x[:, :, top:top + height, left:left + width]
    elif train and augment:                         # slim, train
        outs = []
        for img in x:
            top, left, ch, cw = sample_distorted_bounding_box(h0, w0, rng)
            img = _resize(img[None, :, top:top + ch, left:left + cw],
                          (height, width), antialias=False)[0]
            outs.append(img.flip(-1) if rng.random_sample() < 0.5 else img)
        x = torch.stack(outs)
    else:                                           # slim, eval
        top, left, ch, cw = central_crop_box(h0, w0, crop_fraction)
        x = _resize(x[:, :, top:top + ch, left:left + cw], (height, width),
                    antialias=False)
    x = x.permute(0, 2, 3, 1)
    if raw_uint8:
        return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(
            torch.uint8).numpy()
    return (x * 2.0 - 1.0).contiguous().numpy()


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def record_stream(
    files: Sequence[str], *, train: bool, seed: int = 0,
    shuffle_buffer: int = 1024, shard_index: int = 0, num_shards: int = 1,
    shuffle_files: bool = True,
) -> Iterator[bytes]:
    """The serialized records in the JAX reader's order where it is
    deterministic: the files interleaved one record at a time (TF's
    `interleave` with one cycle slot per file; on the builder's files, the
    shapes' own order), then every `num_shards`-th record from
    `shard_index`.  Train: each epoch shuffles the file order (the same on
    every shard, so shards stay disjoint) when `shuffle_files`, passes the
    records through a `shuffle_buffer`-deep shuffle buffer (tf.data's:
    drained at the end of each epoch), and repeats forever."""
    file_rng = np.random.RandomState(seed)
    buf_rng = np.random.RandomState(seed + 1 + shard_index)

    def one_pass(order):
        readers = [read_records(files[i]) for i in order]
        k = 0
        while readers:
            alive = []
            for r in readers:
                rec = next(r, None)
                if rec is None:
                    continue
                alive.append(r)
                if k % num_shards == shard_index:
                    yield rec
                k += 1
            readers = alive

    if not train:
        yield from one_pass(range(len(files)))
        return
    while True:
        order = (file_rng.permutation(len(files)) if shuffle_files
                 else range(len(files)))
        buf: List[bytes] = []
        seen = 0
        for rec in one_pass(order):
            seen += 1
            if len(buf) < shuffle_buffer:
                buf.append(rec)
                continue
            i = buf_rng.randint(len(buf))
            yield buf[i]
            buf[i] = rec
        while buf:
            i = buf_rng.randint(len(buf))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()
        if seen == 0:
            raise ValueError(f"shard {shard_index}/{num_shards} of "
                             f"{len(files)} TFRecord files holds no records")


def image_decoder():
    """-> decode(blobs) = [(indices, (n, h, w, 3) uint8 at the images' own
    size)], one entry per size: the native pool (sizes read from the
    headers), else PIL where the pool cannot be built and PIL imports (said
    in the log; the same pixels: both decode at the image's own size with
    libjpeg's accurate DCT and libpng), else a refusal naming both."""
    from gvcnn_tf_tpu_torch.data import native_loader

    try:
        pool = native_loader.NativeDecoder()
    except RuntimeError as e:
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError(
                f"the TFRecord reader needs the native decode pool or PIL, "
                f"and neither is here: {e}; PIL does not import") from e
        from gvcnn_tf_tpu_torch.metrics import log

        log(f"tfrecord: decoding with PIL ({str(e).splitlines()[0]})")

        def decode_pil(blobs):
            groups: Dict[Tuple[int, int], list] = {}
            for i, b in enumerate(blobs):
                with Image.open(io.BytesIO(b)) as im:
                    img = np.asarray(im.convert("RGB"))
                groups.setdefault(img.shape[:2], []).append((i, img))
            return [([i for i, _ in g], np.stack([a for _, a in g]))
                    for g in groups.values()]

        return decode_pil

    def decode_native(blobs):
        by_size: Dict[Tuple[int, int], List[int]] = {}
        for i, b in enumerate(blobs):
            by_size.setdefault(native_loader.image_size(b), []).append(i)
        return [(idx, pool.decode([blobs[i] for i in idx], h, w,
                                  dtype=np.uint8))
                for (h, w), idx in by_size.items()]

    return decode_native


def tfrecord_dataset(
    file_pattern: Sequence[str] | str,
    *,
    num_views: int,
    height: int,
    width: int,
    batch_size: int,
    train: bool,
    augment: bool = True,
    shuffle_buffer: int = 1024,
    crop_fraction: float = 0.875,
    seed: int = 0,
    drop_remainder: bool = True,
    preprocessing: str = "square",
    shard_index: int = 0,
    num_shards: int = 1,
    raw_uint8: bool = False,
) -> Iterator[dict]:
    """Iterator of {'views': (B,V,H,W,3), 'label': (B,) int32} numpy
    batches, the JAX reader's contract without TF.

    Two preprocessing families (DataConfig.preprocessing):
      * "square" — decode -> resize to H/crop_fraction (antialiased) ->
        (train: random crop + per-view random horizontal flip | eval:
        central crop) -> scale to [-1, 1].
      * "slim"   — TF-Slim inception_preprocessing: eval = central_crop of
        `crop_fraction` THEN bilinear resize to HxW; train = the distorted
        bounding-box crop (area 5-100%, aspect 3/4-4/3, min covered 0.1)
        -> resize -> random flip.

    `raw_uint8=True` emits uint8 [0, 255] views (rounded after the float
    geometry) for `transfer_dtype="uint8"` runs.  A string pattern is
    globbed (sorted); eval keeps the ragged last batch when
    `drop_remainder` is false.  The files, the CRC library and the decoder
    are checked here, before the first batch.
    """
    from gvcnn_tf_tpu_torch.data import native_loader

    if preprocessing not in ("square", "slim"):
        raise ValueError(f"unknown preprocessing {preprocessing!r}")
    files = (sorted(glob.glob(file_pattern)) if isinstance(file_pattern, str)
             else list(file_pattern))
    if not files:
        raise FileNotFoundError(f"no TFRecord files match {file_pattern!r}")
    native_loader.library(native_loader.RECORDS_LIB)
    decode = image_decoder()
    aug_rng = np.random.RandomState(seed + 2 + shard_index)
    records = record_stream(
        files, train=train, seed=seed, shuffle_buffer=shuffle_buffer,
        shard_index=shard_index, num_shards=num_shards,
        # TF lists a pattern shuffled in train mode; an explicit list of
        # files keeps its order.
        shuffle_files=isinstance(file_pattern, str))

    def batch_of(recs):
        blobs, labels = [], np.empty(len(recs), np.int32)
        for i, rec in enumerate(recs):
            ex = decode_example(rec)
            enc = ex.get("image/encoded", [])
            if len(enc) != num_views or len(ex.get("image/class/label",
                                                   [])) != 1:
                raise ValueError(
                    f"record holds {len(enc)} views and labels "
                    f"{ex.get('image/class/label')}; expected {num_views} "
                    "views and one label")
            blobs.extend(enc)
            labels[i] = ex["image/class/label"][0]
        out = np.empty((len(blobs), height, width, 3),
                       np.uint8 if raw_uint8 else np.float32)
        for idx, imgs in decode(blobs):
            out[idx] = preprocess_views(
                imgs, height=height, width=width, train=train,
                augment=augment, preprocessing=preprocessing,
                crop_fraction=crop_fraction, rng=aug_rng,
                raw_uint8=raw_uint8)
        return {"views": out.reshape(len(recs), num_views, height, width, 3),
                "label": labels}

    def batches():
        pending: List[bytes] = []
        for rec in records:
            pending.append(rec)
            if len(pending) == batch_size:
                yield batch_of(pending)
                pending = []
        if pending and not drop_remainder:
            yield batch_of(pending)

    return batches()
