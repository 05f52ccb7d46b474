"""The benchmark's own host spans and the profiled sub-window of a
`--trace 1` run.

`Spans` times the calls the benchmark makes into the program (the wait on
the input, the step call, an eval pass) on the host clock.  Inside the
profiled sub-window the same spans are `record_function` ranges instead,
so that the device's idle gaps can be labelled by what the host was doing;
their times there are left out of the host-clock readings, which the
profiler would inflate.

`ProfiledWindow` runs `torch.profiler` (CPU and CUDA activity, records
kept in memory, no trace written) over a steady sub-window that starts and
ends with `torch.cuda.synchronize()`, and reduces it to the device's busy
seconds, each kernel's launches and seconds, the longest idle gaps, and
the time each span's thread spent inside CUDA runtime calls."""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional

import torch

WINDOW = "bench.window"
TOP = 10


class Spans:
    """Named host spans; `durations[name]` lists their seconds."""

    def __init__(self):
        self.durations: Dict[str, List[float]] = collections.defaultdict(list)
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.profiling:
            with torch.profiler.record_function("bench." + name):
                yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.durations[name].append(time.perf_counter() - t0)


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class ProfiledWindow:
    def __init__(self, spans: Spans, device):
        self.spans, self.device = spans, torch.device(device)
        self.prof = None
        self._range = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else []))

    def warm_up(self):
        """Start and stop the profiler once (set-up): its first start
        initializes CUPTI, which takes seconds."""
        with self._profile():
            torch.zeros(1, device=self.device).add_(1)
            self._sync()

    def start(self):
        self._sync()
        self.prof = self._profile()
        self.prof.start()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self.spans.profiling = True

    def stop(self):
        self._sync()
        self.spans.profiling = False
        self._range.__exit__(None, None, None)
        self.prof.stop()

    def read(self) -> Optional[dict]:
        """{"window_s", "busy_s", "kernels": {name: (launches, seconds)},
        "gaps": [[label, seconds]] (the TOP longest idle gaps, labelled by
        the benchmark's span the host was in when the gap began)}, or None
        when the profiler saw no device activity."""
        if self.prof is None:
            return None
        window, device, host, runtime = None, [], [], []
        for e in self.prof.events():
            lo, hi = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not e.name.startswith("bench."):
                    device.append((lo, hi, e.name))
            elif e.name == WINDOW:
                window = (lo, hi)
            elif e.name.startswith("bench."):
                host.append((lo, hi, e.name[len("bench."):],
                             getattr(e, "thread", 0)))
            elif e.name.startswith("cuda"):
                runtime.append((lo, hi, e.name, getattr(e, "thread", 0)))
        if window is None or not device:
            return None
        w0, w1 = window
        kernels: Dict[str, list] = {}
        clipped = []
        for lo, hi, name in device:
            lo, hi = max(lo, w0), min(hi, w1)
            if hi <= lo:
                continue
            clipped.append((lo, hi))
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (hi - lo) / 1e6
        busy = _merge(clipped)
        gaps, t = [], w0
        for lo, hi in busy + [[w1, w1]]:
            if lo > t:
                gaps.append((lo - t, t))
            t = max(t, hi)
        gaps.sort(reverse=True)

        def label(at):
            inside = [(lo, name) for lo, hi, name, _ in host if lo <= at < hi]
            return max(inside)[1] if inside else "outside the benchmark's spans"

        return {"window_s": (w1 - w0) / 1e6,
                "busy_s": sum(hi - lo for lo, hi in busy) / 1e6,
                "kernels": {n: tuple(v) for n, v in kernels.items()},
                "gaps": [[label(at), dur / 1e6] for dur, at in gaps[:TOP]],
                "host": _host_spans(host, runtime)}


def _host_spans(host, runtime) -> Dict[str, dict]:
    """{span name: {"n": spans, "s": their seconds, "runtime": {CUDA
    runtime call: seconds spent in it by the span's thread inside the
    spans}}}: how much of a span the host spent waiting in the driver (on
    the device, or on a full launch queue) and not working."""
    out: Dict[str, dict] = {}
    for lo, hi, name, thread in host:
        o = out.setdefault(name, {"n": 0, "s": 0.0, "runtime": {}})
        o["n"] += 1
        o["s"] += (hi - lo) / 1e6
        for rlo, rhi, api, rthread in runtime:
            if rthread == thread and lo <= rlo and rhi <= hi:
                o["runtime"][api] = o["runtime"].get(api, 0.0) + (
                    rhi - rlo) / 1e6
    return out
