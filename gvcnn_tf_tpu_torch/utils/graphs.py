"""CUDA graphs of the port's hot paths (counterpart of the JAX package's
jitted executables and of `gvcnn_tf_tpu/utils/cache.py`).

The JAX package runs every hot path as one compiled executable per shape:
the train step (`jax.jit(..., donate_argnums=0)`, compiled ahead of time
for the batch's shape), the serving engine's forward at each bucket and the
eval step; `utils/cache.py` tunes and caches those executables.  The
port's counterpart is a CUDA graph: the same kernels in the same order,
recorded once and launched as one, so a step pays the host's launch cost
once instead of once a kernel.

`CapturedCall` owns one `torch.cuda.CUDAGraph` of a function of no
arguments that reads its inputs from static buffers the class owns:

  call 1   copies the inputs into the buffers and runs the function
           eagerly on a side stream: the warm-up (the kernels' build and
           their one-time device attributes, cuDNN's plans, cuBLAS's
           workspace, autograd's device threads);
  call 2   returns the allocator's cached blocks to the device (a
           capture that runs short cannot), captures the function on that
           side stream (`capture_error_mode="thread_local"`) with the
           generators it draws from registered, into its owner's memory
           pool (one pool for every graph of an owner: the engine's
           buckets), then replays it;
  later    copy the inputs in and replay.

A replay runs no Python, so the hand-written kernels' wrappers, which count
their launches in `ops.launches`, do not run: a capture measures how far it
moved that counter, puts it back (a capture launches nothing), and every
replay adds that much.  After a replay the version counters of the tensors
the function mutates are bumped, so that the host-side caches keyed on a
version (the stem's packed weight, BatchNorm's scale and shift) see the
change; while a graph is captured those caches compute instead of looking
up (`ops.capturing()`), so a graph reads the weights themselves and a
weight reloaded in place changes what it computes.  A graph is keyed on the
storages of the tensors it watches (a model's parameters and buffers):
when one of them moves, the graph is captured again.  The function and the
keys' functions must not hold the `CapturedCall` or its owner: a graph in a
reference cycle keeps its pool until the garbage collector runs.

Each warm-up, capture and replay's launch is a span (`utils/profiling.py`:
`graph.warmup`, `graph.capture`, `graph.launch`, with the call's name as
`call`); a capture after the first, when a watched storage moved, counts
`graph.recaptures`.

On a CUDA device a capture that fails raises `GraphCaptureError`, naming
the call and the line of the port where it broke; nothing falls back to
the eager call.  On the CPU no graph is made (`capturable` is false) and
the entry points run their eager code.
"""

from __future__ import annotations

import collections
import os
import traceback
from typing import Callable, Dict, List, Sequence

import torch

from gvcnn_tf_tpu_torch.ops import launches
from gvcnn_tf_tpu_torch.utils import profiling

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class GraphCaptureError(RuntimeError):
    """A CUDA graph capture failed; the message names the call and where
    in the port the capture broke."""


def capturable(device) -> bool:
    """Whether the entry points capture their hot path on `device`: on a
    CUDA device, never on the CPU."""
    return torch.device(device).type == "cuda"


def new_pool(device):
    """A memory pool for the graphs of one owner (None off the card)."""
    return (torch.cuda.graph_pool_handle()
            if torch.device(device).type == "cuda" else None)


def _new_graph(call: "CapturedCall"):
    """The graph object a capture records into."""
    return torch.cuda.CUDAGraph()


def _restore(counts: collections.Counter):
    """Set `ops.launches` to `counts`, every name in it."""
    launches.clear()
    launches.update(counts)


def _where(exc: BaseException) -> str:
    """The innermost line of the port in `exc`'s traceback."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if os.path.abspath(f.filename).startswith(_PACKAGE)]
    if not frames:
        return "outside the port"
    f = frames[-1]
    rel = os.path.relpath(f.filename, os.path.dirname(_PACKAGE))
    return f"{rel}:{f.lineno} in {f.name} ({(f.line or '').strip()})"


class CapturedCall:
    """`fn()` as one CUDA graph, called with its inputs as keyword tensors
    that are copied into the static buffers `inputs` (the class's own).

    name        what the graph computes, for errors and logs
    fn          reads its inputs from `self.inputs` only; returns a tensor
                or a tuple or dict of tensors (None allowed); may mutate
                state in place (a train step)
    generators  the generators `fn` draws from; the caller reseeds them
                before each call, and a replay reads their seeds then
    pool        the memory pool to capture into (`new_pool`; None: one of
                its own)
    watch       () -> the tensors the graph is keyed on: when one's storage
                moves, the next call captures again
    mutates     () -> the tensors `fn` changes in place, whose version
                counters each replay bumps

    `__call__` returns the warm-up's own outputs on the first call and the
    graph's static outputs after that: a replay overwrites them, so a
    caller that keeps a result copies it.  `replays` and `captures` count.
    """

    def __init__(self, name: str, fn: Callable,
                 inputs: Dict[str, torch.Tensor], *, device,
                 generators: Sequence[torch.Generator] = (), pool=None,
                 watch: Callable[[], Sequence[torch.Tensor]] = tuple,
                 mutates: Callable[[], Sequence[torch.Tensor]] = tuple):
        self.name = name
        self.fn = fn
        self.inputs = dict(inputs)
        self.device = torch.device(device)
        self.generators = list(generators)
        self.pool = pool
        self.watch = watch
        self.mutates = mutates
        self.outputs = None
        self.replays = 0
        self.captures = 0
        self._graph = None
        self._key = None
        self._delta = collections.Counter()
        self._warm = False
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    def __call__(self, **inputs: torch.Tensor):
        for k, t in inputs.items():
            buf = self.inputs[k]
            if t.shape != buf.shape or t.dtype != buf.dtype:
                raise ValueError(
                    f"{self.name}: input {k!r} is {tuple(t.shape)} {t.dtype}, "
                    f"the graph's {tuple(buf.shape)} {buf.dtype}")
            buf.copy_(t)
        if not self._warm:
            with profiling.span("graph.warmup", call=self.name):
                out = self._on_side(self.fn)
            self._warm = True
            return out
        key = self._storage_key()
        if self._graph is None or key != self._key:
            self._capture()
            self._key = key
        self._replay()
        return self.outputs

    def reset(self):
        """Drop the graph (and with it its hold on the pool); the next call
        captures again."""
        self._graph = self.outputs = self._key = None

    def _storage_key(self):
        return tuple(t.data_ptr() for t in self.watch())

    def _on_side(self, fn):
        if self._side is None:
            return fn()
        cur = torch.cuda.current_stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            out = fn()
        cur.wait_stream(self._side)
        return out

    def _capture(self):
        if self.captures:
            profiling.count("graph.recaptures")
        with profiling.span("graph.capture", call=self.name):
            self._capture_graph()

    def _capture_graph(self):
        self.reset()
        graph = _new_graph(self)
        for g in self.generators:
            graph.register_generator_state(g)
        if self._side is not None:
            # A capture allocates from its graph's pool and, running short,
            # cannot return the allocator's cached blocks to the device
            # (the allocator frees them only while no capture is underway),
            # so they are returned first: blocks earlier steps freed and
            # the pools of graphs that were dropped.
            torch.cuda.synchronize(self.device)
            with torch.cuda.device(self.device):
                torch.cuda.empty_cache()
        before = collections.Counter(launches)
        try:
            self.outputs = self._on_side(lambda: self._record(graph))
        finally:
            self._delta = collections.Counter(launches) - before
            _restore(before)
        self._graph = graph
        self.captures += 1

    def _record(self, graph):
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            out = self.fn()
        except Exception as e:
            try:
                graph.capture_end()
            except RuntimeError:
                pass                    # the capture is broken already
            raise GraphCaptureError(
                f"capturing {self.name} as a CUDA graph failed at "
                f"{_where(e)}: {type(e).__name__}: {e}") from e
        try:
            graph.capture_end()
        except RuntimeError as e:
            raise GraphCaptureError(
                f"capturing {self.name} as a CUDA graph failed at its end: "
                f"{e}") from e
        return out

    def _replay(self):
        before = collections.Counter(launches)
        with profiling.span("graph.launch", call=self.name):
            self._graph.replay()
        _restore(before + self._delta)
        mutated = list(self.mutates())
        if mutated:
            torch.autograd.graph.increment_version(mutated)
        self.replays += 1


def model_tensors(model: torch.nn.Module) -> List[torch.Tensor]:
    """A model's parameters and buffers: what a graph of it watches and,
    for a train step, mutates."""
    return list(model.parameters()) + list(model.buffers())
