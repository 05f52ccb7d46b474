"""Per-layer attribution of the measured train step, forward and backward
apart, on one NVIDIA GPU (counterpart of
`gvcnn_tf_tpu/tools/profile_step.py`).

    python -m gvcnn_tf_tpu_torch.tools.profile_step --mode train \\
        --batch 32 --residual --trace step_trace.json --top 25
    python -m gvcnn_tf_tpu_torch.tools.profile_step --device cpu --batch 2

Measured, not modelled: the JAX tool reads the XLA compiler's cycle
estimates of a scheduled program; this one profiles real steps of
`train.train_step` (or, with `--mode fwd`, serving forwards: BatchNorm
folded, eval mode, no gradients) with torch.profiler and attributes every
device kernel to a layer and a phase.

Attribution (`LayerTracker`, a `TorchDispatchMode`): around every aten op
it dispatches it opens a `record_function` range named like the JAX
`op_name`, e.g.

    train_step/jvp(GVCNN)/InceptionV1/Mixed_4b/Branch_1_Conv2d_0b_3x3/conv/aten::convolution
    train_step/transpose(jvp(GVCNN))/InceptionV1/Mixed_4b/.../aten::convolution_backward
    train_step/recompute(jvp(GVCNN))/InceptionV1/Conv2d_1a_7x7/gvcnn::stem_conv7x7s2
    train_step/aten::_foreach_add_

so that the JAX tool's `_LAYER` regex and `classify` (copied verbatim and
pinned by `tests/test_torch_profile_step.py`) give the same layer keys.
The path is the module's name in the model (its state_dict prefix, `.` read
as `/`); Inception-v1's pools are layers of their own for that reason
(`inception_v1.MaxPool`), as the JAX module runs each step of its plan in a
named scope.

- fwd: the module whose forward is running (a stack kept by global forward
  pre- and post-hooks).  `torch.utils.module_tracker.ModuleTracker` keeps
  a set of open modules instead, in which a block's four branches are all
  open at once during the backward and a remat recompute mixes with the
  backward's modules, so the tool keeps its own stack.
- bwd: the backward runs on the autograd engine's thread, outside every
  forward scope.  Each autograd node is tagged in the forward with the path
  of the module that made it (its post-hook walks the graph back from its
  outputs and tags every node not yet tagged, its pre-hook first tags what
  the caller made), and an op of the backward takes the tag of the node
  that runs it (`torch._C._current_autograd_node`): a conv's dgrad and wgrad
  land under that conv's layer.  Nodes made outside the model (the loss)
  read `transpose(jvp())`.
- recompute: under `remat_until` / `remat_backbone` a region's forward runs
  again inside the backward (`layers.recomputing()`); its ops keep their
  forward path and read `recompute(...)`.
- other: ops outside the model with no gradient (the normalization of the
  views, the optimizer's `_foreach_*` update); `jvp()` marks ops outside
  the model that take a gradient (the loss).

The hand-written kernels are launched through ctypes, which a dispatch mode
cannot see; their wrappers call their `torch.library` ops, which the
tracker sees, and the kernel launched inside the op falls under the op's
range.  On the card a
kernel is tied to the range around its launch (the CUDA runtime event with
the kernel's correlation id, on the launching thread; else the CPU op with
its external id); a kernel tied to no range is `unattributed`, and the
output says what share of the kernel time that is.  On the CPU each range
is one row, timed by the host.

The mode adds host time to every op: kernel durations stay valid, the
step's idle share does not, so `device_idle` comes from a window of
`IDLE_STEPS` steps profiled without it.  Profiler windows can lose records
(PERF.md §7), so, as `bench_layers.device_seconds` does, PROFILE_WINDOWS
windows of one step are taken and the reading is the window whose kernel
time is the median among those with the most device events.

Outputs (one JSON object): per-layer rows with the JAX tool's keys
(`layer`, `fwd_ms`, `bwd_ms`, `pct`, `ops` = kernels, and `est_ms` renamed
`device_ms`) plus `recompute_ms` and `other_ms`; the op counts by layer and
phase (`op_counts`, from the tracker: the same on every device);
`--residual`, `residual_decomposition`'s buckets (`layer_fwd`, `layer_bwd`,
`optimizer_tail` = kernels after the last backward kernel, `data_movement`,
`collectives`, `shared_other_{fwd,bwd,other}`, ...), `device_idle` and
`activation_save`, the tensors autograd saves for the backward (a
`saved_tensors_hooks` pack hook, deduplicated by storage, parameters and
the batch left out); `--trace out.json`, a Chrome trace with fwd, bwd,
other and recompute tracks in the JAX tool's format, at the measured
times.  The default device is the card (`--device cuda`; without one it
raises); `--device cpu` runs the config at 64x64, B = 2, fp32
(`bench_phases.phase_config`) and times host ops.  `--hlo-in` has no
meaning here and is refused.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import re
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

from gvcnn_tf_tpu_torch.models.backbones.layers import recomputing
from gvcnn_tf_tpu_torch.models.gvcnn import (
    build_model,
    init_weights,
    to_device,
)
from gvcnn_tf_tpu_torch.ops import launches as kernel_launches
from gvcnn_tf_tpu_torch.tools.bench_layers import (
    CPU_PEAKS,
    PEAKS,
    PROFILE_WINDOWS,
    _tensors,
)
from gvcnn_tf_tpu_torch.tools.bench_phases import phase_config
from gvcnn_tf_tpu_torch.tools.measure import _union, card_line
from gvcnn_tf_tpu_torch.train import create_train_state, train_step
from gvcnn_tf_tpu_torch.utils import (
    fold_batch_norm,
    normalize_views,
    resolve_device,
)

# The steps' names: the first component of every range the tracker opens.
STEPS = ("train_step", "forward")
RECOMPUTE = "recompute("
UNATTRIBUTED = "unattributed"
IDLE_STEPS = 3
WINDOW = "profile_step window"
_TAG = "gvcnn_layer"
# The device events of a window: kernels, copies and fills.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# Substrings of the hand-written kernels' names (`__global__`), and of
# their ops' (the rows of a CPU run).
HAND_WRITTEN = {"stem": "stem_conv", "grouping": "group_and_fuse"}

# Module-path components that name a layer in any of our backbones/heads.
_LAYER = re.compile(
    r"(Conv2d[\w.]*|MaxPool[\w.]*|AvgPool[\w.]*|Mixed_[\w.]*|"
    r"conv\d+[\w.]*|block\d+[\w.]*|stem|Logits[\w.]*|AuxLogits[\w.]*|"
    r"GroupingModule|grouping|group_fusion|view_pool|Dense_\d+|head)")


def classify(op_name: str) -> tuple[str, str]:
    """op_name -> (layer key, phase in {fwd, bwd, other}).

    jax marks reverse-mode ops with ``transpose(`` in the path; parameter
    updates and optimizer ops have no model-module component at all.
    """
    phase = "bwd" if "transpose(" in op_name else (
        "fwd" if "jvp(" in op_name or "/GVCNN/" in op_name
        or "/GoogLeNet/" in op_name else "other")
    m = _LAYER.search(op_name)
    if m:
        return m.group(1), phase
    # Fall back to the trailing path component family.
    tail = op_name.rsplit("/", 1)[-1]
    fam = re.sub(r"[\d.\[\]].*", "", tail) or "misc"
    return f"({fam})", phase


def layer_and_phase(op_name: str) -> tuple[str, str]:
    """`classify`, with the port's two phases it does not know: a
    recompute's ops (`recompute(`) and a serving forward's ops inside the
    model (`forward/<model>/...`, which `classify` marks fwd for GVCNN
    only)."""
    layer, phase = classify(op_name)
    if RECOMPUTE in op_name:
        phase = "recompute"
    elif op_name.startswith("forward/") and op_name.count("/") > 1:
        phase = "fwd"
    return layer, phase


def _op(op_name: str) -> str:
    return op_name.rsplit("/", 1)[-1]


class LayerTracker(TorchDispatchMode):
    """Names every aten op dispatched under it by module path and phase (see
    the module docstring) and runs it inside a `record_function` range of
    that name.

    `ops`: op_name -> count; `saved`: storage -> (bytes, layer, name) of
    the tensors autograd saved, without those of the model's parameters
    and buffers and of `exclude`; `on_op(op_name, func, args, kwargs,
    out)`, where given, sees every op after it ran.  Each `with` starts
    both afresh."""

    def __init__(self, model: torch.nn.Module, step: str = "train_step",
                 exclude: Sequence = (), on_op: Optional[Callable] = None):
        super().__init__()
        if not hasattr(torch._C, "_current_autograd_node"):
            raise RuntimeError("this PyTorch has no torch._C."
                               "_current_autograd_node; the tracker cannot "
                               "attribute the backward")
        self.root = type(model).__name__
        self.step = step
        self.train = step == "train_step"
        self.on_op = on_op
        self.paths = {m: (name.replace(".", "/") + "/" if name else "")
                      for name, m in model.named_modules()}
        self._fixed = {self._storage(t) for t in list(model.parameters())
                       + list(model.buffers()) + list(_tensors(exclude))}
        self.stack: List[str] = []
        self.ops: collections.Counter = collections.Counter()
        self.saved: Dict[tuple, tuple] = {}
        self._exit = None

    @staticmethod
    def _storage(t: torch.Tensor) -> tuple:
        return (t.device, t.untyped_storage().data_ptr())

    def _tag(self, tree, path: str):
        """Tag the autograd nodes behind `tree`'s tensors that have no tag
        yet with `path` (walking back until a tagged node)."""
        todo = [t.grad_fn for t in _tensors(tree) if t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None or _TAG in node.metadata:
                continue
            node.metadata[_TAG] = path
            todo.extend(f for f, _ in node.next_functions)

    def _pre(self, module, args):
        path = self.paths.get(module)
        if path is None:
            return
        if self.stack and torch.is_grad_enabled():
            self._tag(args, self.stack[-1])
        self.stack.append(path)

    def _post(self, module, args, out):
        """Also called when the forward raised (`always_call`: a remat
        recompute stops early by raising once it has what the backward
        needs), with `out` None."""
        path = self.paths.get(module)
        if path is None:
            return
        if torch.is_grad_enabled():
            self._tag(out, path)
        while self.stack and self.stack.pop() != path:
            pass

    def _pack(self, t: torch.Tensor):
        key = self._storage(t)
        if key not in self._fixed and key not in self.saved:
            where = self.stack[-1] if self.stack else ""
            dtype = str(t.dtype).replace("torch.", "")
            name = f"{where}{dtype}{list(t.shape)}"
            self.saved[key] = (t.untyped_storage().nbytes(),
                               classify(where + "saved")[0], name)
        return t

    def op_name(self, func, args) -> str:
        """The range name of an op dispatched now (see the module
        docstring)."""
        op = func._schema.name
        if recomputing():
            where = self.stack[-1] if self.stack else ""
            return f"{self.step}/{RECOMPUTE}jvp({self.root}))/{where}{op}"
        if torch._C._current_graph_task_id() != -1:
            node = torch._C._current_autograd_node()
            path = None if node is None else node.metadata.get(_TAG)
            if path is None:
                return f"{self.step}/transpose(jvp())/{op}"
            return f"{self.step}/transpose(jvp({self.root}))/{path}{op}"
        if self.stack:
            scope = f"jvp({self.root})" if self.train else self.root
            return f"{self.step}/{scope}/{self.stack[-1]}{op}"
        if self.train and torch.is_grad_enabled() and any(
                t.requires_grad for t in _tensors(args)):
            return f"{self.step}/jvp()/{op}"
        return f"{self.step}/{op}"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = self.op_name(func, args)
        self.ops[name] += 1
        with record_function(name):
            out = func(*args, **kwargs)
        if self.on_op is not None:
            self.on_op(name, func, args, kwargs, out)
        return out

    def __enter__(self):
        self.stack.clear()
        self.ops.clear()
        self.saved.clear()
        hooks = contextlib.ExitStack()
        hooks.callback(torch.nn.modules.module.register_module_forward_pre_hook(
            self._pre).remove)
        hooks.callback(torch.nn.modules.module.register_module_forward_hook(
            self._post, always_call=True).remove)
        hooks.enter_context(torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t))
        self._exit = hooks
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._exit.close()

    def op_counts(self) -> Dict[str, Dict[str, int]]:
        """{layer: {phase: ops}} of the last `with`."""
        out: Dict[str, Dict[str, int]] = {}
        for name, n in self.ops.items():
            layer, phase = layer_and_phase(name)
            row = out.setdefault(layer, {})
            row[phase] = row.get(phase, 0) + n
        return dict(sorted(out.items()))


def trace_events(fn: Callable[[], object], dev: torch.device,
                 tracker: Optional[LayerTracker] = None) -> List[dict]:
    """The Chrome-trace events of one fn() call under torch.profiler (CPU
    and, on a card, CUDA activity), inside a WINDOW range, with `tracker`
    active where given."""
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW), (tracker or contextlib.nullcontext()):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="profile_step_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _ranges(events):
    """{(pid, tid): (starts, [(start, end, name)])} of the tracker's
    ranges, sorted by start (they do not nest)."""
    by_thread = collections.defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"].split("/", 1)[0] in STEPS):
            by_thread[(e["pid"], e["tid"])].append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    out = {}
    for key, spans in by_thread.items():
        spans.sort()
        out[key] = ([s[0] for s in spans], spans)
    return out


def _enclosing(ranges, event) -> Optional[str]:
    """The name of the tracker's range around `event` on its thread."""
    starts, spans = ranges.get((event["pid"], event["tid"]), ((), ()))
    i = bisect.bisect_right(starts, event["ts"]) - 1
    if i >= 0 and spans[i][1] >= event["ts"]:
        return spans[i][2]
    return None


def kernel_rows(events: List[dict], dev: torch.device) -> List[dict]:
    """Rows {op_name, ts, us, kernel} in time order: on the card one per
    device event (kernel, copy, fill), named by the tracker's range around
    its launch (the CUDA runtime event of the same correlation id, else the
    CPU op of the same external id), or UNATTRIBUTED; on the CPU one per
    range, timed by the host."""
    ranges = _ranges(events)
    if dev.type != "cuda":
        return sorted((dict(op_name=name, ts=a, us=b - a, kernel=None)
                       for _, spans in ranges.values()
                       for a, b, name in spans), key=lambda r: r["ts"])
    launches, by_external = {}, {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") in _LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = e
        elif e.get("cat") == "cpu_op" and "External id" in args:
            by_external.setdefault(args["External id"], e)
    rows = []
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        args = e.get("args") or {}
        name = None
        for host in (launches.get(args.get("correlation")),
                     by_external.get(args.get("External id"))):
            if host is not None:
                name = _enclosing(ranges, host)
                if name is not None:
                    break
        rows.append(dict(op_name=name or UNATTRIBUTED, ts=e["ts"],
                         us=e.get("dur", 0), kernel=e["name"]))
    rows.sort(key=lambda r: r["ts"])
    return rows


def choose_window(windows: List[List[dict]]) -> List[dict]:
    """Of several windows' rows, those of the window whose total time is
    the median among the windows with the most rows (a window that lost
    records has fewer; `bench_layers.device_seconds`' rule)."""
    most = max(len(w) for w in windows)
    if not most:
        raise RuntimeError(f"the profiler saw no event in {len(windows)} "
                           "windows")
    full = sorted((w for w in windows if len(w) == most),
                  key=lambda w: sum(r["us"] for r in w))
    return full[(len(full) - 1) // 2]


def device_idle(events: List[dict]) -> Optional[float]:
    """The device's idle share over a window: 1 - the union of its device
    events' intervals over the span from the WINDOW range's start to the
    last event's end; None without device events."""
    device = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
              if e.get("cat") in _DEVICE_CATS]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == WINDOW]
    if not device or not spans:
        return None
    lo = spans[0]["ts"]
    hi = max([b for _, b in device] + [spans[0]["ts"] + spans[0]["dur"]])
    return 1 - sum(b - a for a, b in _union(device, lo, hi)) / (hi - lo)


def aggregate(rows):
    """The JAX tool's per-layer table over measured rows: (rows sorted by
    time, largest first; total us)."""
    per_layer = collections.defaultdict(lambda: {
        "fwd": 0.0, "bwd": 0.0, "recompute": 0.0, "other": 0.0, "n": 0})
    total = 0.0
    for r in rows:
        layer, phase = layer_and_phase(r["op_name"])
        per_layer[layer][phase] += r["us"]
        per_layer[layer]["n"] += 1
        total += r["us"]
    out = []
    for layer, d in per_layer.items():
        us = d["fwd"] + d["bwd"] + d["recompute"] + d["other"]
        out.append({
            "layer": layer,
            "device_ms": round(us / 1e3, 3),
            "fwd_ms": round(d["fwd"] / 1e3, 3),
            "bwd_ms": round(d["bwd"] / 1e3, 3),
            "recompute_ms": round(d["recompute"] / 1e3, 3),
            "other_ms": round(d["other"] / 1e3, 3),
            "pct": round(100 * us / total, 1) if total else 0.0,
            "ops": d["n"],
        })
    out.sort(key=lambda r: -r["device_ms"])
    return out, total


# Ops that move or relayout data and compute nothing.
_DATA_MOVE_OPS = frozenset({
    "aten::copy_", "aten::_to_copy", "aten::clone", "aten::cat",
    "aten::permute", "aten::transpose", "aten::t", "aten::view",
    "aten::_unsafe_view", "aten::reshape", "aten::expand", "aten::slice",
    "aten::select", "aten::constant_pad_nd", "aten::index_select",
    "aten::flip", "aten::as_strided", "aten::squeeze", "aten::unsqueeze"})
_COLLECTIVE = re.compile(r"c10d::|all_?reduce|all_?gather|reduce_scatter|"
                         r"all_to_all|broadcast_")


def residual_decomposition(rows, saved: Optional[Dict] = None,
                           idle: Optional[float] = None,
                           rate: Optional[tuple] = None):
    """The step's measured time in the buckets that the marginal A/B
    attribution (`tools/bench_layers.py`) cannot see, the JAX tool's buckets
    over measured rows (its `residual_decomposition`):

      layer_fwd / layer_bwd / layer_recompute — rows of a nameable layer;
      collectives — all-reduce and the like;
      optimizer_tail — rows after the last backward row (the `_foreach_*`
        update, the step's metrics);
      data_movement — no-layer copies, casts, concatenations, relayouts;
      shared_other_{fwd,bwd,other} — the remaining no-layer rows (the loss,
        the views' normalization, the grouping head's function in the
        model's own scope);
      unattributed — device events tied to no range.

    `saved` (`LayerTracker.saved`) gives `activation_save`: what autograd
    keeps from the forward for the backward, deduplicated by storage, with
    the store + load time at `rate` = (bytes/s, basis); `idle` the
    device's idle share (`device_idle`)."""
    phases = [layer_and_phase(r["op_name"]) for r in rows]
    last_bwd = max((i for i, (_, p) in enumerate(phases) if p == "bwd"),
                   default=-1)
    buckets = collections.defaultdict(float)
    for i, (r, (layer, phase)) in enumerate(zip(rows, phases)):
        owned = not layer.startswith("(")
        op = _op(r["op_name"])
        if r["op_name"] == UNATTRIBUTED:
            buckets["unattributed"] += r["us"]
        elif owned and phase in ("fwd", "bwd", "recompute"):
            buckets[f"layer_{phase}"] += r["us"]
        elif _COLLECTIVE.search(op) or "nccl" in (r["kernel"] or "").lower():
            buckets["collectives"] += r["us"]
        elif i > last_bwd >= 0:
            buckets["optimizer_tail"] += r["us"]
        elif op in _DATA_MOVE_OPS:
            buckets["data_movement"] += r["us"]
        elif owned:
            buckets["layer_other_phase"] += r["us"]
        else:
            buckets[f"shared_other_{phase}"] += r["us"]
    total = sum(r["us"] for r in rows)

    def ms(us):
        return round(us / 1e3, 3)

    out = {
        "total_device_ms": ms(total),
        "buckets_ms": {k: ms(v) for k, v in
                       sorted(buckets.items(), key=lambda kv: -kv[1])},
        "shared_device_ms": ms(total - buckets["layer_fwd"]
                               - buckets["layer_bwd"]
                               - buckets["layer_recompute"]),
        "device_idle": idle,
    }
    if saved is not None:
        tensors = sorted(saved.values(), reverse=True)
        nbytes = sum(b for b, _, _ in tensors)
        bps, basis = rate
        out["activation_save"] = {
            "tensors": len(tensors),
            "bytes": nbytes,
            "mb": round(nbytes / 2**20, 1),
            # store (fwd) + load (bwd) at the memory rate
            "roundtrip_ms": round(2 * nbytes / bps * 1e3, 3),
            "rate_basis": basis,
            "by_layer_mb": _by_layer_mb(tensors),
            "top": [{"mb": round(b / 2**20, 1), "layer": layer, "name": n}
                    for b, layer, n in tensors[:12]],
        }
    return out


def _by_layer_mb(tensors):
    by = collections.defaultdict(int)
    for b, layer, _ in tensors:
        by[layer] += b
    return {k: round(v / 2**20, 1)
            for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:12]}


_TRACKS = {"fwd": 1, "bwd": 2, "other": 3, "recompute": 4}


def chrome_trace(rows):
    """Complete-event ('X') timeline at the measured times, one track per
    phase, µs timebase (the JAX tool's format)."""
    t0 = rows[0]["ts"] if rows else 0.0
    events = []
    for r in rows:
        layer, phase = layer_and_phase(r["op_name"])
        events.append({
            "ph": "X", "pid": 1, "tid": _TRACKS[phase],
            "ts": round(r["ts"] - t0, 3), "dur": round(r["us"], 3),
            "name": f"{layer}:{_op(r['op_name'])}",
            "args": {"op_name": r["op_name"], "kernel": r["kernel"]},
        })
    meta = [{"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
             "args": {"name": nm}} for nm, tid in _TRACKS.items()]
    return {"traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"note": "measured: torch.profiler device events "
                                  "on a card, host op ranges on the CPU; "
                                  "each tied to its op's module path"}}


def make_step(cfg, mode: str, dev: torch.device,
              channels_last: Optional[bool] = None):
    """(fn, model, batch tensors) of one step of `cfg` on `dev`: `train`,
    `train.train_step` on a fixed batch at the config's wire format; `fwd`,
    the serving forward (BatchNorm folded, convs in the compute dtype, eval
    mode, no gradients).  `channels_last` (default: on a card) places the
    model's tensors as `models.gvcnn.to_device` does on a card."""
    from gvcnn_tf_tpu_torch.tools.bench_variants import wire_batch

    if channels_last is None:
        channels_last = dev.type == "cuda"
    batch = wire_batch(cfg, dev)
    if mode == "train":
        state = create_train_state(cfg, dev)
        if channels_last:
            state.model.to(memory_format=torch.channels_last)
        return (lambda: train_step(state, batch, cfg)), state.model, batch
    if mode != "fwd":
        raise ValueError(f"unknown mode {mode!r}")
    model = fold_batch_norm(init_weights(build_model(cfg), cfg.train.seed))
    model = to_device(model.cast_convs_(), dev).eval()
    if channels_last:
        model.to(memory_format=torch.channels_last)

    def fwd():
        with torch.inference_mode():
            return model(normalize_views(batch["views"]))[0]

    return fwd, model, batch


def run(config: str = "mn40_12view", mode: str = "train", batch: int = 32,
        top: int = 25, trace: Optional[str] = None, residual: bool = False,
        device="cuda", cfg=None, channels_last: Optional[bool] = None,
        windows: int = PROFILE_WINDOWS) -> dict:
    """-> the JSON object (see the module docstring); prints it.  `cfg`
    overrides the config `config` and `batch` make."""
    dev = resolve_device(device)
    cfg = cfg or phase_config(config, batch, dev)
    step = STEPS[0] if mode == "train" else STEPS[1]
    fn, model, data = make_step(cfg, mode, dev, channels_last)
    fn()                                   # warm: allocations, plans
    tracker = LayerTracker(model, step, exclude=data)
    before = collections.Counter(kernel_launches)
    with tracker:
        fn()
    launches = dict(kernel_launches - before)
    op_counts, saved = tracker.op_counts(), dict(tracker.saved)
    n_ops = sum(tracker.ops.values())
    taken = [kernel_rows(trace_events(fn, dev, tracker), dev)
             for _ in range(windows)]
    rows = choose_window(taken)
    idle = None
    if dev.type == "cuda":
        idle = device_idle(trace_events(
            lambda: [fn() for _ in range(IDLE_STEPS)], dev))
    layers, total = aggregate(rows)
    lost = sum(r["us"] for r in rows if r["op_name"] == UNATTRIBUTED)
    where = {}
    for part, sub in HAND_WRITTEN.items():
        hits = collections.Counter(
            ":".join(layer_and_phase(r["op_name"])) for r in rows
            if sub in (r["kernel"] or _op(r["op_name"])))
        where[part] = dict(hits)
    if dev.type == "cuda":
        kind, card = torch.cuda.get_device_name(dev), card_line()
        timebase = "device kernels (torch.profiler)"
        rate = (PEAKS[kind]["bytes"], f"{kind}: {PEAKS[kind]['bytes'] / 1e12:g}"
                " TB/s") if kind in PEAKS else None
    else:
        kind, card, timebase = "cpu", None, "host op ranges (cpu)"
        rate = (CPU_PEAKS[1], "nominal CPU rate (bench_layers.CPU_PEAKS)")
    d = cfg.data
    out = {
        "mode": mode,
        "config": cfg.name,
        "batch": d.batch_size,
        "shape": [d.num_views, d.height, d.width],
        "compute_dtype": cfg.compute_dtype,
        "device": kind,
        "card": card,
        "timebase": timebase,
        "kernels": len(rows),
        "window_events": [len(w) for w in taken],
        "dispatched_ops": n_ops,
        "device_ms": round(total / 1e3, 3),
        "attributed_share": round(1 - lost / total, 6) if total else None,
        "launches_per_step": launches,
        "hand_written_kernels": where,
        "layers_top": layers[:top],
        "op_counts": op_counts,
        "trace": trace,
    }
    if residual:
        out["residual"] = residual_decomposition(
            rows, saved, idle,
            rate or (CPU_PEAKS[1], "unknown card: nominal rate"))
    if trace:
        with open(trace, "w") as f:
            json.dump(chrome_trace(rows), f)
    print(json.dumps(out, indent=1), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="mn40_12view")
    p.add_argument("--mode", default="train", choices=["train", "fwd"])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--trace", default=None,
                   help="write a chrome-trace/Perfetto JSON here")
    p.add_argument("--hlo-in", default=None,
                   help="the JAX tool's offline mode; refused here: there is "
                        "no scheduled program to read, the port profiles "
                        "real steps")
    p.add_argument("--residual", action="store_true",
                   help="also print the shared-cost decomposition "
                        "(optimizer/copies/loss buckets, the device's idle "
                        "share, activation-save bytes)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.hlo_in is not None:
        p.error("--hlo-in: the port has no compiled program to read; it "
                "profiles real steps (drop the flag)")
    return run(args.config, args.mode, args.batch, args.top, args.trace,
               args.residual, args.device)


if __name__ == "__main__":
    main()
