"""Tracing and timing (counterpart of `gvcnn_tf_tpu/utils/profiling.py`):
a `torch.profiler` capture written as a Chrome trace, a timing harness
that waits for the card, and the program's own spans and counters.

Spans and counters.  `span(name, parent=None, **attrs)` times a block of
the program: its name, start and end, thread, parent span and attributes.
The parent is the innermost span open on the same thread, or the span
whose id is given (a serving request's spans on the engine's device thread
name the request's span).  A span's self time is its duration less the
part of it that its child spans cover.  `count(name, n)` adds to a
counter.  The store keeps, for each span name, its count, total, self total
and longest span, and its last `RING` records in a ring, so a long run
does not grow it; `snapshot()` returns all of it, `records(name)` the ring
of one name, and `reset()` empties it.  It is thread-safe: the
prefetcher's producer, the engine's device thread and the HTTP threads
record into it.

Every start and end is on the clock that `torch.profiler` stamps its
events with, Unix-epoch nanoseconds (an event of a profile lies at
`kineto_results.trace_start_ns()` plus its `time_range` in us; a Chrome
trace's `ts` plus its `baseTimeNanoseconds`), so a span can be placed on
the device timeline of the same run.  Durations come from
`time.perf_counter_ns`, with one offset to the epoch taken at import.

A span is also a `torch.profiler.record_function` range, but only inside
a session that `profile_trace` opened (the program's own traces: a
`train(profile_steps=...)` window, the tools).  Under any other profiler
session the program adds no events, so the device-time readings of a
session that someone else opened stay as they were.  With no program
trace open a span costs one `perf_counter_ns` pair and one locked ring
append.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, Optional

import torch

# Records kept for each span name.
RING = 4096

_clock = time.perf_counter_ns
_EPOCH_OFFSET_NS = time.time_ns() - _clock()


def now_ns() -> int:
    """Now on the profiler's clock: Unix-epoch nanoseconds."""
    return _clock() + _EPOCH_OFFSET_NS


# The fields of a span's record, as `snapshot()` gives them.
FIELDS = ("id", "name", "start_ns", "end_ns", "self_ns", "thread", "parent",
          "attrs")


class Span:
    """One span of a `SpanStore`, made by its `span(name, parent=None,
    **attrs)`: a context manager, or `open()` and `close()` where the span
    does not end in the block it starts in.  `id`, set when it opens, is
    what a span on another thread names as its parent."""

    __slots__ = ("name", "parent", "attrs", "_id", "start_ns", "_up",
                 "_local", "_range", "_covered", "_until")
    _store: "SpanStore"         # a class attribute of each store's subclass

    def __init__(self, name: str, parent: Optional[int] = None, **attrs):
        self.name, self.parent, self.attrs = name, parent, attrs or None
        self._local = None

    @property
    def id(self) -> int:
        # A span whose id is asked for may be named as a parent on another
        # thread, which finds it open by its id.
        if self._local is not None:
            self._store._open[self._id] = self
        return self._id

    def open(self, start_ns: Optional[int] = None) -> "Span":
        """Open the span now (or at `start_ns`, a `now_ns()` reading: a
        span recorded after the fact, which emits no profiler range)."""
        store = self._store
        try:
            local = store._local.state
        except AttributeError:      # [open spans, native id] of the thread
            local = store._local.state = ([], threading.get_native_id())
        stack = local[0]
        self._id = next(store._ids)
        self._covered = self._until = 0
        if self.parent is not None:
            self._up = store._open.get(self.parent)
        elif stack:
            self._up = up = stack[-1]
            self.parent = up._id
        else:
            self._up = None
        stack.append(self)
        self._local = local
        self._range = None
        if start_ns is not None:
            self.start_ns = start_ns
            return self
        if store.traces:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = _clock() + _EPOCH_OFFSET_NS
        return self

    __enter__ = open

    def close(self, *exc_info, end_ns: Optional[int] = None):
        """Close the span now (or at `end_ns`); a second call does
        nothing.  Also the context manager's exit."""
        end = _clock() + _EPOCH_OFFSET_NS if end_ns is None else end_ns
        local = self._local
        if local is None:
            return
        self._local = None
        if self._range is not None:
            self._range.__exit__(None, None, None)
        stack = local[0]
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        store = self._store
        if store._open:
            store._open.pop(self._id, None)
        start, up = self.start_ns, self._up
        dur = end - start
        with store._lock:
            own = dur - self._covered
            if own < 0:
                own = 0
            if up is not None and up._local is not None:
                # Children close in the order they start (nested on one
                # thread, or one after another across threads), so what
                # they cover is what lies past the last child's end.
                lo = up._until if up._until > start else start
                if up.start_ns > lo:
                    lo = up.start_ns
                if end > lo:
                    up._covered += end - lo
                    up._until = end
            st = store._stats.get(self.name)
            if st is None:
                st = store._stats[self.name] = [
                    collections.deque(maxlen=store.ring), 0, 0, 0, 0]
            st[0].append((self._id, self.name, start, end, own, local[1],
                          self.parent, self.attrs))
            st[1] += 1
            st[2] += dur
            st[3] += own
            if dur > st[4]:
                st[4] = dur

    __exit__ = close


class SpanStore:
    """Spans and counters of one process (the module's `STORE`; tests may
    make their own).  `span(name, parent=None, **attrs)` makes a span of
    this store, to be entered: `parent` is the id of the parent span, which
    may be open on another thread (None: the innermost span open on this
    thread)."""

    def __init__(self, ring: int = RING):
        self.ring = ring
        self.traces = 0                 # program traces open
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._open: Dict[int, Span] = {}
        # Each name's [last records, count, total, self total, max (ns)].
        self._stats: Dict[str, list] = {}
        self._counters: Dict[str, int] = {}
        # A subclass that knows its store, so that making a span is one
        # call.
        self.span = type("Span", (Span,), {"__slots__": (), "_store": self})

    def record(self, name: str, start_ns: int, end_ns: int,
               parent: Optional[int] = None, **attrs):
        """A span that has ended already, from `start_ns` to `end_ns`
        (`now_ns()` readings, perhaps taken on another thread); it has no
        children and emits no profiler range.  `parent` as for `span`."""
        self.span(name, parent, **attrs).open(start_ns).close(end_ns=end_ns)

    def count(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def records(self, name: str) -> list:
        """The last records of the spans named `name`, oldest first: tuples
        of the fields `FIELDS` names."""
        with self._lock:
            st = self._stats.get(name)
            return list(st[0]) if st is not None else []

    def snapshot(self) -> dict:
        """{"clock": "unix_ns", "spans": {name: {"count", "total_ns",
        "self_ns", "max_ns", "records": [{field: value for each of
        `FIELDS`}, oldest first, the last `ring`]}}, "counters": {name:
        value}}."""
        with self._lock:
            spans = {name: {"count": st[1], "total_ns": st[2],
                            "self_ns": st[3], "max_ns": st[4],
                            "records": list(st[0])}
                     for name, st in self._stats.items()}
            counters = dict(self._counters)
        for d in spans.values():
            d["records"] = [dict(zip(FIELDS, r)) for r in d["records"]]
        return {"clock": "unix_ns", "spans": spans, "counters": counters}

    def reset(self):
        """Forget every finished span and every counter."""
        with self._lock:
            self._stats.clear()
            self._counters.clear()

    @contextlib.contextmanager
    def program_trace(self):
        """Within the block, spans are `record_function` ranges too."""
        with self._lock:
            self.traces += 1
        try:
            yield
        finally:
            with self._lock:
                self.traces -= 1


STORE = SpanStore()
span = STORE.span
record = STORE.record
count = STORE.count
records = STORE.records
snapshot = STORE.snapshot
reset = STORE.reset


@contextlib.contextmanager
def profile_trace(logdir: str, name: str = "trace.json", device=None):
    """Capture the enclosed block with `torch.profiler` and write it to
    `logdir/name` as a Chrome trace (open it in Perfetto or
    chrome://tracing).  CPU activity always; with CUDA activity too when
    `device` is a card (None: whenever a card is present), the card is
    synchronized on entry and on exit, so the trace holds the block's
    device work and no other.  The program's spans in the block are ranges
    of the trace, and its counters at the block's start and end are the
    trace's `program_counters` ({"start": {...}, "end": {...}}).  Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    if cuda:
        torch.cuda.synchronize(device)
    prof.start()
    before = STORE.counters()
    try:
        with STORE.program_trace():
            yield prof
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.add_metadata_json("program_counters", json.dumps(
            {"start": before, "end": STORE.counters()}))
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
