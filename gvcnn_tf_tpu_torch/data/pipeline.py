"""Dataset dispatch: config -> iterator of host batches (counterpart of
`gvcnn_tf_tpu/data/pipeline.py`).

Every loader of the JAX package, dispatched by its rule: the synthetic
stream (no `dataset_dir`), the procedural split (`dataset="procedural"` or
`"procedural_hard"`), and over a rendered-view tree or the TFRecords built
from one the native decode pool (`native`), the decode-once cache
(`decoded`) and the TFRecord reader (`tfrecord`), none of which needs
TensorFlow.  A loader that cannot run here raises with the reason (the
native pool needs a C++ compiler, libjpeg and libpng); nothing falls back
to another loader.  Where the pool cannot be built, the decoded cache and
the TFRecord reader decode with PIL if it imports, and say so in the log.

The procedural train split may instead be staged on the card once
(`data/device_resident.py`, `device_resident`): by the JAX package's rule,
`"on"` stages it and `"auto"` stages it for one process on one card when
the uint8 wire is on and the split is at most 4 GiB.  Staging needs the
device, so `make_dataset` stages only when it is given one (`train()`
passes its card); without a device every split streams.  The batches are
the same either way (the same per-epoch permutation,
`RandomState(seed + 7 + shard_index)`).

The synthetic and procedural streams save their position (`state_dict`),
so a resumed run continues them; the file loaders restart from their seed,
as every loader does in the JAX package.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Optional

from gvcnn_tf_tpu_torch.configs import DataConfig
from gvcnn_tf_tpu_torch.data.procedural import (
    ProceduralStream,
    build_procedural_split,
)
from gvcnn_tf_tpu_torch.data.synthetic import SyntheticStream
from gvcnn_tf_tpu_torch.metrics import log


def _resolve_loader(data_cfg: DataConfig) -> str:
    """The loader `auto` resolves to, by the JAX package's rule."""
    loader = data_cfg.loader
    if loader == "auto":
        if data_cfg.dataset in ("procedural", "procedural_hard"):
            loader = "procedural"
        elif data_cfg.dataset == "synthetic" or not data_cfg.dataset_dir:
            loader = "synthetic"
        elif glob.glob(os.path.join(data_cfg.dataset_dir, "*.tfrecord")):
            loader = "tfrecord"
        else:
            loader = "native"
    return loader


def _split_files(data_cfg: DataConfig, train: bool):
    split = "train" if train else "validation"
    pattern = os.path.join(data_cfg.dataset_dir, f"{split}-*.tfrecord")
    return pattern, glob.glob(pattern)


def dataset_size(data_cfg: DataConfig, *, train: bool = True,
                 cheap_only: bool = False) -> Optional[int]:
    """Number of shapes in the split, or None if unknown (the JAX rule).

    Used for epoch accounting.  Counting TFRecords reads every frame
    header of the split's files, so it is skipped under `cheap_only`
    (synthetic, procedural and image-tree counts are free)."""
    loader = _resolve_loader(data_cfg)
    if loader in ("synthetic", "procedural"):
        return data_cfg.synthetic_num_shapes
    if loader in ("native", "decoded"):
        from gvcnn_tf_tpu_torch.data.tfrecord import discover_shapes

        shapes, _ = discover_shapes(data_cfg.dataset_dir)
        return sum(1 for _, _, v in shapes if len(v) >= data_cfg.num_views)
    if cheap_only:
        return None
    from gvcnn_tf_tpu_torch.data.tfrecord import count_records

    _, files = _split_files(data_cfg, train)
    if not files:
        return None
    return sum(count_records(f) for f in files)


def _use_device_resident(data_cfg: DataConfig, train: bool,
                         world_size: int = 1) -> bool:
    """Whether to stage the split on the device (`device_resident`), by
    the JAX package's rule with one process per card: "off", or a split
    that is not train, streams; "on" stages (one rank only); "auto" stages
    when the wire is uint8, the world is one rank and the split's renders,
    num_shapes x num_views x H x W x 3 bytes, fit in 4 GiB."""
    mode = data_cfg.device_resident
    if mode == "off" or not train:
        return False
    if mode == "on":
        if world_size > 1:
            raise ValueError(
                "device_resident='on' is single-process only (several "
                "ranks shard their input through the streaming prefetcher)")
        return True
    width = data_cfg.width or data_cfg.height
    nbytes = (data_cfg.synthetic_num_shapes * data_cfg.num_views
              * data_cfg.height * width * 3)
    return (data_cfg.transfer_dtype == "uint8" and world_size == 1
            and nbytes <= (4 << 30))


def make_dataset(data_cfg: DataConfig, *, train: bool, seed: int = 0,
                 num_epochs: Optional[int] = None, shard_index: int = 0,
                 num_shards: int = 1, device=None) -> Iterator[dict]:
    """The split's iterator of numpy batches for a config (`num_epochs`
    None: endless; the TFRecord reader repeats in train mode and reads once
    in eval, as the JAX one does).

    `shard_index`/`num_shards`: data-parallel input sharding, as in the JAX
    package: each rank streams a disjoint subset of the split at its local
    batch size (`data_cfg.batch_size` here is the rank's; `train` divides
    the global batch by the world's size before calling), `num_shards`
    being the world's size.

    `device`: where `_use_device_resident` allows it, the procedural train
    split is staged there and the iterator yields its batches as indices
    into it (`DeviceResidentIter`); without a device it streams."""
    loader = _resolve_loader(data_cfg)
    if loader not in ("synthetic", "procedural", "native", "decoded",
                      "tfrecord"):
        raise ValueError(f"unknown loader {loader!r}")
    uint8 = data_cfg.transfer_dtype == "uint8"
    if uint8 and loader == "synthetic":
        raise ValueError(
            f"transfer_dtype='uint8' requires a loader that yields raw "
            f"uint8 views (procedural, native, tfrecord, decoded); got "
            f"loader={loader!r}. Use 'auto'/'bfloat16'/'float32' here.")
    geometry = dict(num_views=data_cfg.num_views, height=data_cfg.height,
                    width=data_cfg.width, batch_size=data_cfg.batch_size)
    shards = dict(shard_index=shard_index, num_shards=num_shards)

    if loader == "decoded":
        from gvcnn_tf_tpu_torch.data.decoded_cache import decoded_dataset

        return decoded_dataset(
            data_cfg.dataset_dir, train=train, num_epochs=num_epochs,
            seed=seed, raw_uint8=uint8,
            # device_flip moves the random flip into the train step
            # (train.py): the host must then stream VERBATIM batches or
            # views would be flipped twice.
            augment=data_cfg.augment and not data_cfg.device_flip,
            **geometry, **shards)

    if loader == "native":
        from gvcnn_tf_tpu_torch.data import native_loader

        native_loader.library()         # raises with what is missing
        return native_loader.native_dataset(
            data_cfg.dataset_dir, train=train, num_epochs=num_epochs,
            seed=seed, raw_uint8=uint8, **geometry, **shards)

    if loader == "tfrecord":
        from gvcnn_tf_tpu_torch.data.tfrecord import tfrecord_dataset

        pattern, files = _split_files(data_cfg, train)
        if not files:
            raise FileNotFoundError(
                f"no TFRecords matching {pattern}; build them with "
                "`python -m gvcnn_tf_tpu_torch.data.build_tfrecords`")
        return tfrecord_dataset(
            pattern, train=train, augment=data_cfg.augment,
            shuffle_buffer=data_cfg.shuffle_buffer,
            crop_fraction=data_cfg.crop_fraction, seed=seed,
            # Eval scores the FULL split: the ragged tail batch is kept and
            # the eval loop pads and masks it.
            drop_remainder=train, preprocessing=data_cfg.preprocessing,
            raw_uint8=uint8, **geometry, **shards)

    kw = dict(num_classes=data_cfg.num_classes,
              num_shapes=data_cfg.synthetic_num_shapes, seed=seed,
              train=train, num_epochs=num_epochs, **geometry, **shards)
    if loader == "procedural":
        hard = data_cfg.dataset == "procedural_hard"
        if device is not None and _use_device_resident(data_cfg, train,
                                                       num_shards):
            from gvcnn_tf_tpu_torch.data.device_resident import (
                device_resident_iter,
            )

            views, labels = build_procedural_split(
                num_views=data_cfg.num_views, height=data_cfg.height,
                width=data_cfg.width,
                num_shapes=data_cfg.synthetic_num_shapes, seed=seed,
                train_split=train, hard=hard,
                num_classes=data_cfg.num_classes)
            it = device_resident_iter(
                views, labels, batch_size=data_cfg.batch_size, device=device,
                seed=seed, train=train, num_epochs=num_epochs, **shards)
            log(f"device_resident: staged the train split on {device}, "
                f"{it.staged_bytes / 1e6:.1f} MB in {it.stage_seconds:.3f} s")
            return it
        return ProceduralStream(hard=hard, raw_uint8=uint8, **kw)
    return SyntheticStream(**kw)
