"""Dataset dispatch: config -> iterator of host batches (counterpart of
`gvcnn_tf_tpu/data/pipeline.py`).

The port has the synthetic stream (what the JAX package picks when no
`dataset_dir` is given) and the procedural split (`dataset="procedural"` or
`"procedural_hard"`), which can yield raw uint8 views for the uint8 wire.
Every other loader, and `device_resident="on"`, is refused with the ROADMAP
item that ports it.  `device_resident="auto"` streams every split through
the prefetcher: unlike the JAX package, which stages a procedural train
split on the device under `auto` when the uint8 wire is on and shuffles it
there in another order, the port keeps the host stream's order.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Union

from gvcnn_tf_tpu_torch.configs import DataConfig
from gvcnn_tf_tpu_torch.data.procedural import ProceduralStream
from gvcnn_tf_tpu_torch.data.synthetic import SyntheticStream

_PORTED = ("synthetic", "procedural")


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
    """Number of shapes in the split (the synthetic or procedural one), or
    None."""
    if _resolve_loader(data_cfg) in _PORTED:
        return data_cfg.synthetic_num_shapes
    return None


def make_dataset(data_cfg: DataConfig, *, train: bool, seed: int = 0,
                 num_epochs: Optional[int] = None
                 ) -> Union[SyntheticStream, ProceduralStream]:
    """The split's stream for a config (`num_epochs` None: endless);
    refuses what is not ported."""
    loader = _resolve_loader(data_cfg)
    if loader not in _PORTED:
        raise NotImplementedError(
            f"loader {loader!r} is not ported yet (ROADMAP §1 item 7, the "
            "other loaders: tfrecord, native, decoded); with no "
            "--dataset_dir the synthetic stream is used, and "
            "--dataset procedural renders the procedural split")
    if data_cfg.device_resident == "on":
        raise NotImplementedError(
            "device_resident='on' is not ported (ROADMAP §1 item 15, "
            "GPU-resident split)")
    uint8 = data_cfg.transfer_dtype == "uint8"
    if uint8 and loader == "synthetic":
        raise ValueError(
            f"transfer_dtype='uint8' requires a loader that yields raw "
            f"uint8 views (procedural, native, tfrecord, decoded); got "
            f"loader={loader!r}. Use 'auto'/'bfloat16'/'float32' here.")
    kw = dict(num_classes=data_cfg.num_classes,
              num_views=data_cfg.num_views, height=data_cfg.height,
              width=data_cfg.width, batch_size=data_cfg.batch_size,
              num_shapes=data_cfg.synthetic_num_shapes, seed=seed,
              train=train, num_epochs=num_epochs)
    if loader == "procedural":
        return ProceduralStream(hard=data_cfg.dataset == "procedural_hard",
                                raw_uint8=uint8, **kw)
    return SyntheticStream(**kw)
