"""Logging for gvcnn_tf_tpu_torch.

Only the `log` helper of `gvcnn_tf_tpu/metrics.py`, which the server uses;
the training writers come with the training port.
"""

from __future__ import annotations

import sys


def log(msg: str):
    print(f"[gvcnn_tf_tpu_torch] {msg}", file=sys.stderr, flush=True)
