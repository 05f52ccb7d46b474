"""Dataset dispatch: config -> iterator of host batches (counterpart of
`gvcnn_tf_tpu/data/pipeline.py`).

The port has the synthetic stream only, which is what the JAX package
picks when no `dataset_dir` is given.  Every other loader, and
`device_resident="on"`, is refused with the ROADMAP item that ports it.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

from gvcnn_tf_tpu_torch.configs import DataConfig
from gvcnn_tf_tpu_torch.data.synthetic import SyntheticStream


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


def dataset_size(data_cfg: DataConfig) -> Optional[int]:
    """Number of shapes in the split (the synthetic stream's), or None."""
    if _resolve_loader(data_cfg) == "synthetic":
        return data_cfg.synthetic_num_shapes
    return None


def make_dataset(data_cfg: DataConfig, *, train: bool,
                 seed: int = 0) -> SyntheticStream:
    """The synthetic stream for a config; refuses what is not ported."""
    loader = _resolve_loader(data_cfg)
    if loader != "synthetic":
        raise NotImplementedError(
            f"loader {loader!r} is not ported yet (ROADMAP §1 item 7, the "
            "other loaders: procedural, tfrecord, native, decoded); with no "
            "--dataset_dir the synthetic stream is used")
    if data_cfg.device_resident == "on":
        raise NotImplementedError(
            "device_resident='on' is not ported (ROADMAP §1 item 15, "
            "GPU-resident split)")
    if data_cfg.transfer_dtype == "uint8":
        raise ValueError(
            f"transfer_dtype='uint8' requires a loader that yields raw "
            f"uint8 views (procedural, native, tfrecord, decoded); got "
            f"loader={loader!r}. Use 'auto'/'bfloat16'/'float32' here.")
    return SyntheticStream(
        num_classes=data_cfg.num_classes,
        num_views=data_cfg.num_views,
        height=data_cfg.height,
        width=data_cfg.width,
        batch_size=data_cfg.batch_size,
        num_shapes=data_cfg.synthetic_num_shapes,
        seed=seed,
        train=train,
    )
