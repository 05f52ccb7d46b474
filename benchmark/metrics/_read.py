"""What several readers share: spans and the profiled window."""

from __future__ import annotations

import statistics
from typing import Optional


def span_ms(records: dict, name: str, how: str = "mean") -> Optional[float]:
    """The mean (or median) of the benchmark's host spans `name`, in ms,
    outside the profiled sub-window; None if there are none."""
    d = records.get("spans", {}).get(name)
    if not d:
        return None
    f = statistics.fmean if how == "mean" else statistics.median
    return f(d) * 1e3


def idle_pct(records: dict, kind: str) -> Optional[float]:
    """The share of the profiled sub-window in which no operation ran on
    the device, in %."""
    prof = records.get("profile")
    if records.get("kind") != kind or not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def class_ms_per_step(records: dict, cls: str) -> Optional[float]:
    """Device ms a step of the kernels of class `cls` in the profiled
    sub-window; None where it ran none of them."""
    from benchmark.kernels import class_seconds

    prof = records.get("profile")
    if not prof or not prof.get("steps"):
        return None
    s = class_seconds(prof["kernels"], cls)
    return s / prof["steps"] * 1e3 if s > 0 else None


def span_work_ms(records: dict, name: str) -> Optional[float]:
    """Of the profiled sub-window's spans `name`, the mean ms a span's
    thread spent outside CUDA runtime calls (where the host waits on the
    device or on a full launch queue): its own work; None where there are
    none."""
    prof = records.get("profile") or {}
    span = (prof.get("host") or {}).get(name)
    if not span or not span["n"]:
        return None
    return (span["s"] - sum(span["runtime"].values())) / span["n"] * 1e3
