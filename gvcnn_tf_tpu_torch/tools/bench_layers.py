"""Per-layer attribution of a backbone's time against its roofline on one
NVIDIA GPU (counterpart of `gvcnn_tf_tpu/tools/bench_layers.py`).

    python -m gvcnn_tf_tpu_torch.tools.bench_layers --backbone inception_v1 \\
        --batch 384 --height 224 --mode train --out docs/PERF_LAYERS.md
    python -m gvcnn_tf_tpu_torch.tools.bench_layers --device cpu \\
        --batch 2 --height 32 --width 32 --dtype float32 --iters 4

`--batch 384` = 32 shapes x 12 views, the flagship's folded batch.  `--mode
train` times forward + backward (the gradient of a sum of the features),
`--mode fwd` the eval-mode forward without gradients.  Prints one JSON line a
row and a summary line; `--out` appends a markdown table.  The default
device is the card (`--device cuda`); without one it raises, and it runs on
the CPU only when asked (`--device cpu`, as the tests do; its times are the
host's and its peaks the JAX tool's nominal ones).

Two methods, as in the JAX tool:

**marginal** (default): for each layer i, two calls that differ only by one
more execution of the segment (prev_i, i]:
  A: sum(seg_i(prefix(x)))
  B: sum(seg_i(prefix(x))) + sum(seg_i'(z2))
seg_i' is a second copy of the segment with its own copy of the parameters
and z2 a separate input of the prefix output's shape, so B runs the
segment twice; delta = t(B) - t(A) is the marginal in-context cost of the
segment.  In train mode A takes the gradients of the prefix's and the
segment's parameters, and B also those of seg_i' and of z2, except for the
first layer (prev = ""), whose input needs no gradient in context (the JAX
tool's reasons, `gvcnn_tf_tpu/tools/bench_layers.py:190-203`).  `sigma_ms`
is the pair's timing spread and `noisy` marks |delta| < 2 sigma.  It needs
`start_endpoint` (Inception-v1); another backbone falls back to:

**truncated**: the delta between towers truncated at consecutive
endpoints.

Time: CUDA events around chunks of 5 calls, the median of the chunks
(`ms`), and `device_ms`, the segment's kernel time from torch.profiler: the
kernels of a call that runs only B's second copy of the segment (its
forward, and in train mode its backward), so that the prefix's kernels,
whose time drifts with the card's clocks between calls, do not enter it
(truncated: the towers' kernel times' difference).  On the card an eager
segment can be bound by its launches on the host, so `ms` and `device_ms`
differ; XLA's jitted programs have no such gap.

Work: `count_work` runs the call once under a `TorchDispatchMode` that
counts each aten op: FLOPs by `torch.utils.flop_counter`'s formulas (convs
and matrix products; elementwise ops, pools and BatchNorm count none), and
bytes as the op's tensor inputs read once and outputs written once (views
and allocations move none).  The hand-written kernels are counted from
their shapes: their wrappers call their `torch.library` ops, which the
counter sees as one op whichever implementation runs under it, the CUDA
kernel on the card or the plain version on the CPU.  K2
(`gvcnn::stem_conv7x7s2`): 2 N Ho Wo 64 147 FLOPs; x, the weight (and the
epilogue's scale and shift) read, the output written.  K1
(`gvcnn::group_and_fuse`): B M V C compares and 2 B M C FLOPs; scores and
descriptors read, the three outputs written.  The count is unfused, where
XLA's "bytes accessed" is fused.

Peaks: `PEAKS`, keyed on the card's name (NVIDIA's data sheet for the H100
SXM part); in float32 the TF32 rate where `torch.backends.cudnn.
allow_tf32` (PyTorch's default: fp32 convs in TF32), else the CUDA cores'.
An unknown card raises.  `frac_of_bound` is the layer's least time on the
card, the larger of its FLOPs over the peak and its bytes over the memory
rate, over its time (the JAX tool's attained / min(peak, intensity x BW)
wherever the layer has FLOPs; for a pool, which has none, the bytes bound
where the JAX formula reads 0); `frac_of_bound_device` the same over
`device_ms`.
"""

from __future__ import annotations

import argparse
import collections
import copy
import inspect
import json
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from gvcnn_tf_tpu_torch.models.backbones import get_backbone
from gvcnn_tf_tpu_torch.tools.measure import (
    card_line,
    cuda_samples,
    kernel_durations_us,
)
from gvcnn_tf_tpu_torch.utils import resolve_device

# Data-sheet rates by the card's name (`torch.cuda.get_device_name`):
# dense FLOP/s by compute type, and device-memory bytes/s.  NVIDIA H100
# SXM (80 GB HBM3): 989 TFLOP/s bf16, 495 TF32, 67 fp32 on the CUDA cores,
# 3.35 TB/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bfloat16=989e12, tf32=495e12,
                                  float32=67e12, bytes=3.35e12),
}
# `--device cpu`: the JAX tool's nominal off-TPU rates.
CPU_PEAKS = (1e12, 1e11)
CHUNK = 5
PROFILE_WINDOWS = 3

# The hand-written kernels' ops, counted from their shapes.
STEM_OP = "gvcnn::stem_conv7x7s2"
GROUPING_OP = "gvcnn::group_and_fuse"
# Ops that allocate and write nothing.
_ALLOCATIONS = {"aten::empty", "aten::empty_like", "aten::empty_strided",
                "aten::new_empty", "aten::new_empty_strided"}
# In-place ops that overwrite their first argument without reading it.
_OVERWRITES = {"aten::copy_", "aten::fill_", "aten::zero_",
               "aten::normal_", "aten::uniform_", "aten::bernoulli_"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def stem_work(x: torch.Tensor, weight: torch.Tensor,
              scale: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """(FLOPs, bytes) of K2 on x (N, H, W, 3): 2 N Ho Wo 64 147, and x, the
    weight, scale and shift read, the (N, Ho, Wo, 64) output written in x's
    dtype."""
    n, h, w, _ = x.shape
    out = n * -(-h // 2) * -(-w // 2) * 64
    flops = 2 * out * weight[0].numel()
    nbytes = _nbytes((x, weight, scale, shift)) + out * x.element_size()
    return flops, nbytes


def grouping_work(scores: torch.Tensor, descs: torch.Tensor,
                  num_group: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of K1: the masked max over each group's views
    (B M V C compares) and the weighted fusion (2 B M C); scores and
    descriptors read, fused (B, C), weights (B, M) and scheme (B, M, V)
    written in fp32."""
    b, v, c = descs.shape
    m = num_group
    flops = b * m * v * c + 2 * b * m * c
    nbytes = _nbytes((scores, descs)) + 4 * b * (c + m + m * v)
    return flops, nbytes


def _asked_for(func, args, kwargs, out):
    """The outputs an op was asked for: of a backward op with an
    `output_mask` (convolution_backward, native_batch_norm_backward) those
    the mask selects, since a backend may write others (CUDA's batch-norm
    backward writes the weight's gradient unasked, the CPU's does not);
    else all."""
    names = [a.name for a in func._schema.arguments]
    if "output_mask" not in names:
        return out
    i = names.index("output_mask")
    mask = kwargs["output_mask"] if i >= len(args) else args[i]
    return [o for o, keep in zip(out, mask) if keep]


class WorkCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of the aten ops run under it (see the module
    docstring); `by_op` holds [calls, FLOPs, bytes] by op name, and
    `k2_launches` the stem kernel's launches in `count_work`'s call."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.k2_launches = 0          # set by `count_work`
        self.by_op: Dict[str, List[int]] = collections.defaultdict(
            lambda: [0, 0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name == STEM_OP:
            flops, nbytes = stem_work(*args[:4])
        elif name == GROUPING_OP:
            flops, nbytes = grouping_work(*args[:3])
        elif func.is_view or name in _ALLOCATIONS:
            flops, nbytes = 0, 0
        else:
            formula = flop_registry.get(func._overloadpacket)
            flops = (0 if formula is None
                     else int(formula(*args, **kwargs, out_val=out)))
            read = args[1:] if name in _OVERWRITES else args
            nbytes = _nbytes((read, kwargs)) + _nbytes(_asked_for(
                func, args, kwargs, out))
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op[name]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out


def count_work(fn: Callable[[], object]) -> WorkCounter:
    """Run fn() once under a `WorkCounter`; the counter (`k2_launches`: 0 on
    the CPU, where the plain version runs)."""
    from gvcnn_tf_tpu_torch.ops import launched

    before = launched("stem_conv7x7s2")
    with WorkCounter() as counter:
        fn()
    counter.k2_launches = launched("stem_conv7x7s2") - before
    return counter


def device_peaks(dev: torch.device, dtype: str) -> dict:
    """{"flops", "bytes", "basis"}: the peak rate for `dtype`'s products
    and the memory rate of the card (`PEAKS`), or the CPU's nominal pair.
    An unknown card raises."""
    if dev.type == "cpu":
        return dict(flops=CPU_PEAKS[0], bytes=CPU_PEAKS[1],
                    basis="nominal CPU rates (the JAX tool's)")
    name = torch.cuda.get_device_name(dev)
    if name not in PEAKS:
        raise ValueError(f"no data-sheet rates for the card {name!r}; "
                         f"known: {sorted(PEAKS)}")
    rates = PEAKS[name]
    if dtype == "bfloat16":
        key = "bfloat16"
    elif dtype == "float32":
        key = "tf32" if torch.backends.cudnn.allow_tf32 else "float32"
    else:
        raise ValueError(f"no peak for dtype {dtype!r}")
    return dict(flops=rates[key], bytes=rates["bytes"],
                basis=f"{name}: {key} products "
                      f"(cudnn.allow_tf32={torch.backends.cudnn.allow_tf32})"
                      f", {rates['bytes'] / 1e12:g} TB/s")


def time_stats(fn: Callable[[], object], iters: int, dev: torch.device,
               chunk: int = CHUNK) -> Tuple[float, float]:
    """(median, std) seconds a call over max(iters // chunk, 4) chunks of
    `chunk` calls, after one warm call: CUDA events around each chunk on
    the card (`measure.cuda_samples`), the host clock on the CPU."""
    runs = max(iters // chunk, 4)
    if dev.type == "cuda":
        samples = [ms / 1e3 for ms in cuda_samples(fn, runs, warmup=1,
                                                    chunk=chunk)]
    else:
        fn()
        samples = []
        for _ in range(runs):
            t0 = time.perf_counter()
            for _ in range(chunk):
                fn()
            samples.append((time.perf_counter() - t0) / chunk)
    return statistics.median(samples), statistics.stdev(samples)


def device_seconds(fn: Callable[[], object], dev: torch.device,
                   calls: int = 3) -> Optional[float]:
    """Kernel time a call on the card (torch.profiler's device events,
    summed, over `calls` calls); None on the CPU (not measured).

    On the card's machine a profiler window can lose device records (one
    lost 101 of 3,322 kernels; another here read 0.026 ms for a max-pool
    whose bytes alone take 0.19 ms), which only lowers the sum.  So the
    window is profiled PROFILE_WINDOWS times and only the windows with the
    most device events count; each call launches the same kernels, so
    while that count is not a multiple of `calls`, up to PROFILE_WINDOWS
    more windows are taken.  Among the windows that count, the median of
    their sums is the reading (a maximum of noisy sums would read high)."""
    if dev.type != "cuda":
        return None
    windows = []
    for i in range(2 * PROFILE_WINDOWS):
        durs = kernel_durations_us(fn, calls)
        windows.append((sum(len(d) for d in durs.values()),
                        sum(sum(d) for d in durs.values())))
        most = max(events for events, _ in windows)
        if i + 1 >= PROFILE_WINDOWS and most % calls == 0 < most:
            break
    if not most:
        raise RuntimeError(f"the profiler saw no kernel in "
                           f"{2 * PROFILE_WINDOWS} windows")
    return statistics.median(
        total for events, total in windows if events == most) / calls / 1e6


def _tower(backbone: str, final: str, start: str, s2d: bool,
           dev: torch.device, seed: int = 0) -> torch.nn.Module:
    """The backbone through `final` (from after `start` where given), with
    seeded weights, on `dev` (channels-last on a card, as
    `models.gvcnn.to_device` places a model)."""
    cls = get_backbone(backbone)
    params = inspect.signature(cls.__init__).parameters
    kw = {}
    if start:
        if "start_endpoint" not in params:
            raise ValueError(f"{backbone} does not support segment towers "
                             "(start_endpoint)")
        kw["start_endpoint"] = start
    elif s2d and "stem_space_to_depth" in params:
        kw["stem_space_to_depth"] = True
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = cls(final_endpoint=final, **kw)
    return model.to(dev, memory_format=(torch.channels_last
                                        if dev.type == "cuda"
                                        else torch.preserve_format))


def _input(batch, height, width, dtype, dev, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (batch, height, width, 3)).astype(np.float32)
    return torch.from_numpy(x).to(dev, getattr(torch, dtype))


def _loss(feats: torch.Tensor) -> torch.Tensor:
    return feats.float().sum()


def _row(endpoint, dt, dflops, dbytes, peak, device_dt=None, *,
         sigma=None, cum_ms=None, k2_launches=None):
    """One row: the JAX tool's keys (with `sigma_ms` and `noisy` where
    `sigma` is given, `cum_ms` where given), then this tool's own."""
    attained = dflops / dt if dt > 0 else 0.0
    intensity = dflops / dbytes if dbytes > 0 else 0.0
    bound = min(peak["flops"], intensity * peak["bytes"])
    t_ops, t_bytes = dflops / peak["flops"], dbytes / peak["bytes"]
    bound_s = max(t_ops, t_bytes)
    row = {"endpoint": endpoint}
    if cum_ms is not None:
        row["cum_ms"] = cum_ms
    row["ms"] = round(dt * 1e3, 3)
    if sigma is not None:
        row["sigma_ms"] = round(sigma * 1e3, 3)
        row["noisy"] = bool(abs(dt) < 2 * sigma)
    row.update({
        "gflops": round(dflops / 1e9, 2),
        "attained_tflops": round(attained / 1e12, 2),
        "frac_peak": round(attained / peak["flops"], 4),
        "intensity": round(intensity, 1),
        "roofline_bound_tflops": round(bound / 1e12, 2),
        "frac_of_bound": round(bound_s / dt, 4) if dt > 0 else 0.0,
        "device_ms": (None if device_dt is None
                      else round(device_dt * 1e3, 3)),
        "frac_of_bound_device": (
            None if device_dt is None
            else round(bound_s / device_dt, 4) if device_dt > 0 else 0.0),
        "gbytes": round(dbytes / 1e9, 4),
        "bound_ms": round(bound_s * 1e3, 4),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "k2_launches": k2_launches,
    })
    return row


def bench_endpoint(backbone: str, endpoint: str, *, batch: int, height: int,
                   width: int, dtype: str, mode: str, iters: int,
                   s2d: bool = False, device="cuda") -> dict:
    """-> dict(t, sigma, device_t, flops, bytes) of the backbone truncated
    at `endpoint`, forward (fwd) or forward + backward (train)."""
    dev = torch.device(device)
    model = _tower(backbone, endpoint, "", s2d, dev)
    x = _input(batch, height, width, dtype, dev)
    train = mode == "train"
    model.train(train)
    params = list(model.parameters())

    def fn():
        if not train:
            with torch.no_grad():
                return model(x)[0]
        return torch.autograd.grad(_loss(model(x)[0]), params)

    work = count_work(fn)
    t, sigma = time_stats(fn, iters, dev)
    return dict(t=t, sigma=sigma, device_t=device_seconds(fn, dev),
                flops=work.flops, bytes=work.bytes,
                k2_launches=work.k2_launches)


def bench_marginal_pair(backbone: str, endpoint: str, prev_endpoint: str, *,
                        batch: int, height: int, width: int, dtype: str,
                        mode: str, iters: int, s2d: bool = False,
                        device="cuda") -> dict:
    """Marginal in-context cost of the (prev_endpoint, endpoint] segment:
    dict(dt, sigma, flops, bytes), each B's minus A's, and device_dt, the
    second copy's kernel time alone (the module docstring; the JAX tool's
    `bench_marginal_pair`)."""
    dev = torch.device(device)
    train = mode == "train"
    x = _input(batch, height, width, dtype, dev)
    if prev_endpoint:
        prefix = _tower(backbone, prev_endpoint, "", s2d, dev)
        seg = _tower(backbone, endpoint, prev_endpoint, False, dev, seed=1)
        prefix.train(train)
        with torch.no_grad():
            z0 = prefix(x)[0]
    else:
        prefix = None
        seg = _tower(backbone, endpoint, "", s2d, dev, seed=1)
        z0 = x
    seg2 = copy.deepcopy(seg)          # its own copy of the parameters
    for m in (seg, seg2):
        m.train(train)
    g = torch.Generator().manual_seed(0)
    z2 = torch.empty_like(z0).copy_(torch.randn(z0.shape, generator=g))
    del z0
    z2.requires_grad_(train and bool(prev_endpoint))
    pp = [] if prefix is None else list(prefix.parameters())
    sp, sp2 = list(seg.parameters()), list(seg2.parameters())

    def tower():
        z = x if prefix is None else prefix(x)[0]
        return _loss(seg(z)[0])

    def fa():
        if not train:
            with torch.no_grad():
                return tower()
        return torch.autograd.grad(tower(), pp + sp)

    extra = sp2 + ([z2] if z2.requires_grad else [])

    def fb():
        if not train:
            with torch.no_grad():
                return tower() + _loss(seg2(z2)[0])
        return torch.autograd.grad(tower() + _loss(seg2(z2)[0]),
                                   pp + sp + extra)

    def second_copy():
        if not train:
            with torch.no_grad():
                return _loss(seg2(z2)[0])
        return torch.autograd.grad(_loss(seg2(z2)[0]), extra)

    wa, wb = count_work(fa), count_work(fb)
    ta, sa = time_stats(fa, iters, dev)
    tb, sb = time_stats(fb, iters, dev)
    return {"dt": tb - ta, "sigma": (sa ** 2 + sb ** 2) ** 0.5,
            "device_dt": device_seconds(second_copy, dev),
            "flops": wb.flops - wa.flops, "bytes": wb.bytes - wa.bytes,
            "k2_launches": [wa.k2_launches, wb.k2_launches]}


def run(backbone: str = "inception_v1", *, batch: int = 384,
        height: int = 224, width: int = 224, dtype: str = "bfloat16",
        mode: str = "train", iters: int = 10,
        endpoints: Optional[List[str]] = None, out: Optional[str] = None,
        merge: str = "none", s2d: bool = False, method: str = "marginal",
        device="cuda"):
    """-> (rows, summary); prints a JSON line each (see the module
    docstring)."""
    dev = resolve_device(device)
    peak = device_peaks(dev, dtype)
    card = card_line() if dev.type == "cuda" else None
    cls = get_backbone(backbone)
    eps = list(endpoints or cls.ENDPOINTS)
    kw = dict(batch=batch, height=height, width=width, dtype=dtype,
              mode=mode, iters=iters, s2d=s2d, device=dev)
    print(json.dumps({"note": f"merge={merge!r}: every merge_branches "
                      "policy is the same math and parameters; the port "
                      "runs the branches unmerged (configs.py "
                      "merge_inception_branches)"}), flush=True)
    if method == "marginal" and "start_endpoint" not in inspect.signature(
            cls.__init__).parameters:
        print(json.dumps({"note": f"{backbone} has no start_endpoint "
                          "segment support; falling back to --method "
                          "truncated"}), flush=True)
        method = "truncated"
    rows = []
    if method == "marginal":
        all_eps = list(cls.ENDPOINTS)
        for ep in eps:
            i = all_eps.index(ep)
            m = bench_marginal_pair(backbone, ep,
                                    all_eps[i - 1] if i > 0 else "", **kw)
            rows.append(_row(ep, m["dt"], m["flops"], m["bytes"], peak,
                             m["device_dt"], sigma=m["sigma"],
                             k2_launches=m["k2_launches"]))
            print(json.dumps(rows[-1]), flush=True)
        # The whole tower through the last endpoint, as one call.
        last = bench_endpoint(backbone, eps[-1], **kw)
    elif method == "truncated":
        prev = {"t": 0.0, "device_t": 0.0, "flops": 0, "bytes": 0}
        for ep in eps:
            cur = bench_endpoint(backbone, ep, **kw)
            dev_dt = (None if cur["device_t"] is None
                      else cur["device_t"] - prev["device_t"])
            rows.append(_row(ep, cur["t"] - prev["t"],
                             cur["flops"] - prev["flops"],
                             cur["bytes"] - prev["bytes"], peak, dev_dt,
                             cum_ms=round(cur["t"] * 1e3, 3),
                             k2_launches=cur["k2_launches"]))
            print(json.dumps(rows[-1]), flush=True)
            prev = cur
        last = prev
    else:
        raise ValueError(f"unknown method {method!r}")
    total = _row(f"{eps[-1]} (whole tower)", last["t"], last["flops"],
                 last["bytes"], peak, last["device_t"])
    summary = {
        "backbone": backbone, "mode": mode, "batch": batch,
        "height": height, "width": width, "dtype": dtype, "method": method,
        "merge": merge,
        "total_ms": round(last["t"] * 1e3, 2),
        "total_device_ms": total["device_ms"],
        "total_gflops": round(last["flops"] / 1e9, 1),
        "total_gbytes": total["gbytes"],
        "mfu": round(last["flops"] / last["t"] / peak["flops"], 4),
        "total_frac_of_bound": total["frac_of_bound"],
        "total_frac_of_bound_device": total["frac_of_bound_device"],
        "total_k2_launches": last["k2_launches"],
        "peak_tflops": peak["flops"] / 1e12,
        "peak_tbps": peak["bytes"] / 1e12,
        "peak_basis": peak["basis"],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": card,
    }
    print(json.dumps({"summary": summary}), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(markdown(rows, summary) + "\n")
    return rows, summary


def markdown(rows: List[dict], summary: dict) -> str:
    """The table `--out` appends."""
    marginal = summary["method"] == "marginal"
    if marginal:
        desc = ("Marginal A/B pairs (prefix+1x vs prefix+2x segment, "
                "identical calls otherwise): `sigma` = per-pair timing std; "
                "rows with |delta| < 2 sigma are marked noisy. ")
        hdr = ("| endpoint | ms | sigma | device ms | GFLOP | GB | TFLOP/s "
               "| frac peak | intensity (FLOP/B) | bound ms | bound "
               "TFLOP/s | frac of bound | frac of bound (device) |")
    else:
        desc = "Delta timing between truncated towers. "
        hdr = ("| endpoint | ms | device ms | GFLOP | GB | TFLOP/s | "
               "frac peak | intensity (FLOP/B) | bound ms | bound TFLOP/s "
               "| frac of bound | frac of bound (device) |")
    where = summary["card"] or summary["device"]
    lines = [
        f"# Per-layer timing: {summary['backbone']} {summary['mode']} "
        f"(batch {summary['batch']}, {summary['height']}x"
        f"{summary['width']}, {summary['dtype']}, {where}, "
        f"method={summary['method']})",
        "",
        desc + "`ms`: CUDA events (host clock on the CPU); `device ms`: "
        "torch.profiler kernel time.  FLOPs and bytes counted per aten op "
        "(`count_work`): unfused, each op's inputs read once and outputs "
        "written once, where XLA's \"bytes accessed\" is fused.  `frac of "
        "bound` = max(FLOPs / peak, bytes / BW) / time: how close each "
        f"layer is to ITS OWN roofline ({summary['peak_basis']}).",
        "",
        hdr,
        "|" + "---|" * (hdr.count("|") - 1),
    ]
    for r in rows:
        cells = [r["endpoint"], r["ms"]]
        if marginal:
            cells.append(f"{r['sigma_ms']}" + (" (noisy)" if r["noisy"]
                                               else ""))
        cells += [r["device_ms"], r["gflops"], r["gbytes"],
                  r["attained_tflops"], r["frac_peak"], r["intensity"],
                  r["bound_ms"], r["roofline_bound_tflops"],
                  r["frac_of_bound"], r["frac_of_bound_device"]]
        lines.append("| " + " | ".join(
            "not measured" if c is None else str(c) for c in cells) + " |")
    device = summary["total_device_ms"]
    lines += ["", f"Total: {summary['total_ms']} ms (device "
              f"{'not measured' if device is None else f'{device} ms'}), "
              f"{summary['total_gflops']} GFLOP, MFU {summary['mfu']}.", ""]
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description="per-layer timing harness")
    p.add_argument("--backbone", default="inception_v1")
    p.add_argument("--batch", type=int, default=384)
    p.add_argument("--height", type=int, default=224)
    p.add_argument("--width", type=int, default=224)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--mode", default="train", choices=["train", "fwd"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--endpoints", default=None,
                   help="comma-separated subset (default: all)")
    p.add_argument("--merge", default="none",
                   choices=["none", "1x1", "full"],
                   help="merge_branches layout variant (accepted and "
                        "logged: the port runs the unmerged math)")
    p.add_argument("--s2d", action="store_true",
                   help="use the space-to-depth stem")
    p.add_argument("--method", default="marginal",
                   choices=["marginal", "truncated"],
                   help="marginal = A/B pairs (default); truncated = "
                        "cumulative deltas of truncated towers")
    p.add_argument("--out", default=None, help="append markdown table here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    return run(args.backbone, batch=args.batch, height=args.height,
               width=args.width, dtype=args.dtype, mode=args.mode,
               iters=args.iters,
               endpoints=args.endpoints.split(",") if args.endpoints
               else None, out=args.out, merge=args.merge, s2d=args.s2d,
               method=args.method, device=args.device)


if __name__ == "__main__":
    main()
