"""Logging and step timing for gvcnn_tf_tpu_torch (counterpart of
`gvcnn_tf_tpu/metrics.py`).

`MetricWriter` prints one JSON line per call, as the JAX package's does,
and, given a logdir, appends the same line to `<logdir>/metrics.jsonl` (the
port has no TensorBoard writer); `NullWriter` is the other ranks'.  `StepTimer` is the JAX package's.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class MetricWriter:
    def __init__(self, logdir: Optional[str] = None):
        self.logdir = logdir
        self._file = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._file = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalars(self, step: int, values: dict):
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in values.items()})
        line = json.dumps(rec)
        print(line, flush=True)
        if self._file is not None:
            self._file.write(line + "\n")

    def flush(self):
        if self._file is not None:
            self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class NullWriter(MetricWriter):
    """The writer of every rank but rank 0: the metrics are the world's,
    so only one rank emits them."""

    def __init__(self):
        super().__init__(None)

    def scalars(self, step: int, values: dict):
        pass


class StepTimer:
    """Wall-clock throughput over a window of steps (call after the device
    has finished the window's work)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1):
        self._steps += n

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else float("inf")


def log(msg: str):
    print(f"[gvcnn_tf_tpu_torch] {msg}", file=sys.stderr, flush=True)
