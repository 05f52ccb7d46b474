"""Host-to-device transfer of batches, one batch ahead (counterpart of
`gvcnn_tf_tpu/data/prefetch.py`, written for PyTorch and CUDA).

A producer thread pulls numpy batches from the loader and copies them into
host tensors in the wire dtype: page-locked (pinned) memory when the target
is a card, so that the copy to the device can be asynchronous.  bf16 on the
wire, where `resolve_transfer_dtype` asks for it, is cast on the host
(round to nearest even, the same bits as a cast on the device); only float
views are cast: raw uint8 views (the uint8 wire) go to the device as uint8
and are normalized there (`utils/images.py`).  The thread
does host copies only: every CUDA call is made on the consumer's thread,
since PyTorch keeps cuDNN plans per thread.

The consumer thread issues each batch's host-to-device copy on a side CUDA
stream as soon as the producer has it, so that it overlaps the step in
flight; handing a batch out makes the current stream wait for its copy and
records the tensors on that stream, so the caching allocator keeps them
until the step that reads them is done.  On the CPU the batches pass
through as host tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

_END = object()


class _Failed:
    def __init__(self, exc: BaseException):
        self.exc = exc


class DevicePrefetcher:
    """Iterator of {'views', 'label'} device tensors from an iterator of
    numpy batches.  Float `views` arrive in `transfer_dtype` ("bfloat16",
    or None for the loader's own dtype), uint8 `views` as uint8, `label` as
    int64.  `depth` batches wait on the host; 0 ("prefetch off") is taken
    as 1, so the stream is never empty.

    `data_state` is the loader's `state_dict()` as it stood right after it
    produced the batch last handed out (None for a loader without one): a
    checkpoint that stores it resumes the stream at the next batch.
    Call `close()` when done (or use the object as a context manager).
    """

    def __init__(self, it: Iterator[dict], device: torch.device,
                 transfer_dtype: Optional[str] = None, depth: int = 2):
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._wire = (None if transfer_dtype is None
                      else getattr(torch, transfer_dtype))
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._side = torch.cuda.Stream(self._device) if self._cuda else None
        self._ready = None              # (views, label, state) copied ahead
        self._done = False
        self._error: Optional[BaseException] = None
        self.data_state = None
        self._thread = threading.Thread(target=self._produce, args=(it,),
                                        name="gvcnn-prefetch", daemon=True)
        self._thread.start()

    # -- producer thread: host work only ---------------------------------
    def _host(self, a: np.ndarray, dtype: Optional[torch.dtype]):
        t = torch.from_numpy(np.ascontiguousarray(a))
        dtype = dtype or t.dtype
        if not self._cuda:
            return t.to(dtype)
        out = torch.empty(t.shape, dtype=dtype, pin_memory=True)
        return out.copy_(t)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it):
        try:
            for batch in it:
                state = (it.state_dict() if hasattr(it, "state_dict")
                         else None)
                views = np.asarray(batch["views"])
                wire = self._wire if views.dtype.kind == "f" else None
                item = (self._host(views, wire),
                        self._host(batch["label"], torch.int64), state)
                if not self._put(item):
                    return
            self._put(_END)
        except BaseException as e:  # handed to the consumer, raised there
            self._put(_Failed(e))

    # -- consumer thread ----------------------------------------------------
    def _take(self, block: bool):
        """The next host batch from the producer, its copy to the device
        started; None if none is ready (block=False) or the stream ended."""
        try:
            item = self._queue.get(block=block)
        except queue.Empty:
            return None
        if item is _END:
            self._done = True
            return None
        if isinstance(item, _Failed):
            self._done, self._error = True, item.exc
            return None
        views, label, state = item
        if self._cuda:
            with torch.cuda.stream(self._side):
                views = views.to(self._device, non_blocking=True)
                label = label.to(self._device, non_blocking=True)
        return views, label, state

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._ready is None and not self._done:
            self._ready = self._take(block=True)
        if self._ready is None:
            if self._error is not None:
                raise self._error
            raise StopIteration
        views, label, self.data_state = self._ready
        self._ready = None
        if self._cuda:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_stream(self._side)
            views.record_stream(cur)
            label.record_stream(cur)
        if not self._done:
            # The next copy starts now if its batch is ready, and overlaps
            # the step that is about to be enqueued.
            self._ready = self._take(block=False)
        return {"views": views, "label": label}

    def close(self):
        """Stop the producer and wait for it (at most 30 s)."""
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
