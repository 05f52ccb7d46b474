"""The train split resident on the card: staged once, gathered inside each
train step (counterpart of `gvcnn_tf_tpu/data/device_resident.py`).

The streaming procedural loader gathers each batch on the host (a B=8
uint8 batch of 12 views of 224x224 is 14.5 MB), pins it and copies it to
the card.  Here the whole uint8 split goes to the card once, and every
batch becomes a (B,) index vector: `train_step` gathers the views and the
labels with `index_select` on the card (train.py), so a step copies B
indices host to device and nothing else.  The mn40_12view split of 128
shapes is 231 MB of uint8.

The order is the streaming `ProceduralStream`'s (`EpochOrder`: one
permutation of the shard an epoch from `RandomState(seed + 7 +
shard_index)`, train drops the ragged tail, eval yields it short), and so
is the saved position (`state_dict`), so a resident run trains on the same
batches as a streaming one, and a checkpoint of either resumes under the
other.  One process on one card: `pipeline.make_dataset` stages only
there, and `train()` turns the transport off under several ranks or
`bn_sync="local"`, as the JAX package does.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from gvcnn_tf_tpu_torch.data.procedural import EpochOrder

# The split is copied in chunks of at most this many bytes along axis 0
# (the JAX package's size), each into its rows of one tensor allocated on
# the device first.  Unlike the JAX package, which puts the chunks on the
# device and concatenates them there (twice the split's memory for a
# moment), the port never holds more than the split.
_STAGE_CHUNK_BYTES = 256 << 20


def _row_chunks(arr: np.ndarray) -> List[Tuple[int, int]]:
    """[lo, hi) row ranges of the staging copies: one for an array of at
    most _STAGE_CHUNK_BYTES, else nbytes // _STAGE_CHUNK_BYTES + 1 parts as
    `np.array_split` cuts them (the JAX package's count)."""
    if arr.nbytes <= _STAGE_CHUNK_BYTES:
        return [(0, len(arr))]
    n = int(arr.nbytes // _STAGE_CHUNK_BYTES) + 1
    parts = np.array_split(np.arange(len(arr)), n)
    return [(int(p[0]), int(p[-1]) + 1) for p in parts if len(p)]


def stage_on_device(arr: np.ndarray, device) -> torch.Tensor:
    """`arr` as one tensor on `device`, copied there in `_row_chunks`
    (the copy is finished when this returns)."""
    device = torch.device(device)
    arr = np.ascontiguousarray(arr)
    src = torch.from_numpy(arr)
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    for lo, hi in _row_chunks(arr):
        out[lo:hi].copy_(src[lo:hi])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


class DeviceResidentIter(EpochOrder):
    """Yields {'views': the staged split (N, V, H, W, 3) uint8 on the
    device, 'label': the staged labels (N,) int64, 'idx': (B,) int32 host
    indices}: the same tensors every batch, and the batch's indices in
    `EpochOrder`'s order.  The split is staged when the object is made, on
    the caller's thread; `stage_seconds` and `staged_bytes` say what that
    took."""

    def __init__(self, views: np.ndarray, labels: np.ndarray, *,
                 batch_size: int, device, seed: int = 0, train: bool = True,
                 num_epochs: Optional[int] = None, shard_index: int = 0,
                 num_shards: int = 1):
        super().__init__(num_shapes=len(labels), batch_size=batch_size,
                         seed=seed, train=train, num_epochs=num_epochs,
                         shard_index=shard_index, num_shards=num_shards)
        t0 = time.perf_counter()
        self.views = stage_on_device(views, device)
        self.labels = stage_on_device(np.asarray(labels, np.int64), device)
        self.stage_seconds = time.perf_counter() - t0
        self.staged_bytes = self.views.nbytes + self.labels.nbytes

    def __next__(self) -> dict:
        idx = self._next_indices()
        return {"views": self.views, "label": self.labels,
                "idx": np.asarray(idx, np.int32)}


def device_resident_iter(views: np.ndarray, labels: np.ndarray, *,
                         batch_size: int, device, seed: int = 0,
                         train: bool = True, num_epochs: Optional[int] = None,
                         shard_index: int = 0,
                         num_shards: int = 1) -> DeviceResidentIter:
    """`gvcnn_tf_tpu.data.device_resident.device_resident_iter`'s
    signature, with the device named; see `DeviceResidentIter`."""
    return DeviceResidentIter(
        views, labels, batch_size=batch_size, device=device, seed=seed,
        train=train, num_epochs=num_epochs, shard_index=shard_index,
        num_shards=num_shards)
