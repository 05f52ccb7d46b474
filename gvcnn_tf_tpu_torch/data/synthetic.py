"""Synthetic multi-view dataset, so that every config runs with nothing on
disk (counterpart of `gvcnn_tf_tpu/data/synthetic.py`, numpy only).

The same stream as the JAX package's, byte for byte
(`tests/test_torch_data.py` pins it): shapes are class-conditional, each
class has a fixed random "prototype" image per view and train samples add
small noise to it.  Written as an iterator object rather than a generator
so that its position can be saved and restored (`state_dict`,
`load_state_dict`): a resumed run continues the stream where the
checkpoint left it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class SyntheticStream:
    """Yields {'views': (B, V, H, W, 3) float32 in [-1, 1], 'label': (B,)
    int32}, as `synthetic_dataset` does in the JAX package.

    `shard_index`/`num_shards` give each process a disjoint subset of the
    shapes (every num_shards-th index); prototypes and labels are derived
    from `seed` alone so all processes agree on the data.
    """

    def __init__(self, *, num_classes: int, num_views: int, height: int,
                 width: int, batch_size: int, num_shapes: int = 128,
                 seed: int = 0, train: bool = True,
                 num_epochs: Optional[int] = None, noise: float = 0.05,
                 shard_index: int = 0, num_shards: int = 1):
        rng = np.random.RandomState(seed)
        # Per-class per-view prototypes, kept low-res and upsampled to keep
        # memory small.
        proto_lr = rng.uniform(-1, 1, (num_classes, num_views, 8, 8, 3))
        proto_lr = proto_lr.astype(np.float32)
        reps_h, reps_w = -(-height // 8), -(-width // 8)
        protos = np.repeat(np.repeat(proto_lr, reps_h, axis=2), reps_w,
                           axis=3)
        self._protos = protos[:, :, :height, :width, :]
        self._labels = rng.randint(0, num_classes, size=num_shapes)
        self._shard = np.arange(num_shapes)[shard_index::num_shards]
        self._rng = np.random.RandomState(seed + 1 + shard_index)
        self._batch_size, self._train = batch_size, train
        self._num_epochs, self._noise = num_epochs, noise
        self._epoch, self._order, self._start = 0, None, 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        bs = self._batch_size
        while True:
            if self._order is None:
                if (self._num_epochs is not None
                        and self._epoch >= self._num_epochs):
                    raise StopIteration
                self._order = (self._shard[self._rng.permutation(
                    len(self._shard))] if self._train else self._shard)
                self._start = 0
            # Train drops the ragged tail (the stream repeats anyway); eval
            # scores the full split, the tail batch short.
            n_local = len(self._order)
            last = n_local - bs + 1 if self._train else n_local
            if self._start < last:
                idx = self._order[self._start:self._start + bs]
                self._start += bs
                lbl = self._labels[idx]
                views = self._protos[lbl].copy()
                if self._train and self._noise > 0:
                    views += self._noise * self._rng.randn(
                        *views.shape).astype(np.float32)
                return {"views": np.clip(views, -1.0, 1.0),
                        "label": lbl.astype(np.int32)}
            self._order = None
            self._epoch += 1

    def state_dict(self) -> dict:
        """The stream's position: epoch, offset, shuffled order and the
        numpy generator's state, as tensors and numbers (so that
        `torch.load(weights_only=True)` reads it back)."""
        kind, keys, pos, has_gauss, gauss = self._rng.get_state()
        return {
            "epoch": self._epoch, "start": self._start,
            "order": (None if self._order is None
                      else torch.from_numpy(np.array(self._order))),
            "rng": {"kind": kind, "keys": torch.from_numpy(keys.astype(
                np.int64)), "pos": int(pos), "has_gauss": int(has_gauss),
                "gauss": float(gauss)},
        }

    def load_state_dict(self, state: dict):
        r = state["rng"]
        self._rng.set_state((r["kind"], r["keys"].numpy().astype(np.uint32),
                             r["pos"], r["has_gauss"], r["gauss"]))
        self._epoch, self._start = state["epoch"], state["start"]
        order = state["order"]
        self._order = None if order is None else order.numpy()


def synthetic_dataset(**kw) -> SyntheticStream:
    """`gvcnn_tf_tpu.data.synthetic.synthetic_dataset`'s signature and
    stream; see `SyntheticStream`."""
    return SyntheticStream(**kw)
