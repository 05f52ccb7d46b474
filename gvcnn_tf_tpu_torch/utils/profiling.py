"""Tracing and timing (counterpart of `gvcnn_tf_tpu/utils/profiling.py`):
a `torch.profiler` capture written as a Chrome trace, and a timing
harness that waits for the card."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def profile_trace(logdir: str, name: str = "trace.json", device=None):
    """Capture the enclosed block with `torch.profiler` and write it to
    `logdir/name` as a Chrome trace (open it in Perfetto or
    chrome://tracing).  CPU activity always; with CUDA activity too when
    `device` is a card (None: whenever a card is present), the card is
    synchronized on entry and on exit, so the trace holds the block's
    device work and no other.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    if cuda:
        torch.cuda.synchronize(device)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, name))


def _on_card(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_card(o) for o in out)
    return False


def timed_steps(fn: Callable, *args, warmup: int = 3, iters: int = 10,
                **kwargs) -> float:
    """Mean seconds per call of fn(*args, **kwargs) over `iters` calls
    after `warmup` calls, with the card synchronized before and after the
    timed calls when fn's output (a tensor, or a dict, list or tuple of
    them) is on a card."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    card = _on_card(out)
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    if card:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters
