"""Kernel and forward measurements of the port on one NVIDIA GPU.

    python gvcnn_tf_tpu_torch/tools/measure.py wrappers [--root DIR]
    python gvcnn_tf_tpu_torch/tools/measure.py stem-f32 [--root DIR]
    python gvcnn_tf_tpu_torch/tools/measure.py stem-probe
    python gvcnn_tf_tpu_torch/tools/measure.py profile [--train] [--config C]
    python gvcnn_tf_tpu_torch/tools/measure.py trace-windows [--windows N]
    python gvcnn_tf_tpu_torch/tools/measure.py remat [--config C]
    python gvcnn_tf_tpu_torch/tools/measure.py train-drift [--config C] # CPU
    python gvcnn_tf_tpu_torch/tools/measure.py serve-drift [--config C] # CPU
    python gvcnn_tf_tpu_torch/tools/measure.py dp-drift [--config C]    # CPU
    python gvcnn_tf_tpu_torch/tools/measure.py retrieval-drift [--size N] # CPU

`wrappers`: each kernel wrapper at the main path's shapes (the stem at 96
and 12 views of 224x224; the grouping head at B = 8 and 1, 12 views,
C = 1024, M = 8), under torch.inference_mode() as serving calls them:
host time per call (the enqueue, no synchronise, mean of
200 calls), CUDA-event time per call (median of 30) and device time per
launch (torch.profiler kernel durations, and one CUDA graph of K calls
replayed, divided by K).  `--root DIR` measures the `gvcnn_tf_tpu_torch`
of another checkout with this file's code, so that two versions are
compared on one card in one call: parent, change, change, parent.

`stem-f32` (`--root` as for `wrappers`): the fp32 stem kernel at
mn10_single_view's (8, 224, 224, 3), without and with its epilogue: its
max|err| against the plain version (cuDNN's fp32 conv, TF32 off) over
max|ref|, CUDA-event time (median of 30), device time (torch.profiler,
mean of 20 launches), and cuDNN's conv on the pre-padded input in fp32
(TF32 off) and in TF32.

`stem-probe`: where the fp32 stem kernel's time goes.  csrc/stem_conv.cu is
built as it is and in the variants of `STEM_PROBE_EDITS` (textual edits of
the source; one that no longer matches raises), one nvcc a variant, all
started together, each into its own library under build/; each variant's
fp32 kernel is timed on the device (torch.profiler, mean of 20 launches)
at (8, 224, 224, 3) and (96, 224, 224, 3), the list in turns (in order,
then reversed), and held against cuDNN's fp32 conv (TF32 off).

`profile`: the serving model of `--config` (default mn40_12view; seeded
weights, folded BN, the config's compute dtype, channels-last, uint8 views
normalized on the card) at B = 8 and B = 1: forward time (CUDA events),
device busy time and idle share over 3 profiled forwards, and device time
by kernel; then, for an Inception-v1 backbone, every op and kernel that
`Stem.forward` runs on the card.

`profile --train`: one train step of `--config` at B = 8 (seeded weights,
fp32 master parameters, the config's compute dtype, channels-last, momentum
SGD, dropout on; a fixed synthetic batch already on the card, in the
compute dtype as the loader sends it): step time (CUDA events, median of
10), views/s, peak device memory, device busy time and idle share over 3
profiled steps, and device time by kernel class and by kernel.

`trace-windows`: whether `train(profile_steps=(3, 5))` traces its whole
window.  `--windows` (default 20) runs of mn40_12view on the 128-shape
procedural uint8 split (card-resident), 6 steps each, in this process,
each after a CUDA-only profiler session of 5 grouping-kernel calls (as
`kernel_us` makes them): per window, the kernel launches the trace
records (its CUDA API events), the kernels it holds, each hand-written
kernel's events and the device's idle share.  A launch without its kernel
is a record the profiler lost.

`remat`: what rematerialization costs and buys in the train step of
`--config` (default mn40_12view; seeded weights, the config's compute
dtype, momentum SGD, dropout on, a batch made on the card in the compute
dtype, as the synthetic stream sends it), for the variants of
`REMAT_VARIANTS`: no remat, `remat_until` at MaxPool_2a_3x3,
Conv2d_2c_3x3, MaxPool_3a_3x3 and Mixed_3c, `remat_backbone`, and both
(the counterpart of the JAX package's `bench_variants.py` remat rows).  At
B = 8, the variants in turns (in order, then reversed), each in its own
train state: step time (CUDA events, median of 10 after 3 warm steps) and
peak device memory (`max_memory_allocated` after
`reset_peak_memory_stats`).  Then for each variant the largest batch whose
step fits on the card, by doubling from 8 and bisecting to one shape:
`torch.cuda.OutOfMemoryError` is the answer this search looks for, so a
step that raises it counts as "does not fit" (the allocator's cache is
emptied before the next try); another error is not caught.  One row a
variant, with its peak memory at that batch, and the step time (median
of 3 after one warm step; None where a step runs out of memory) and
views/s at REMAT_TIMED_SHARE of it, beside views/s at B = 8.

`train-drift` (runs on the CPU, and is no device measurement): one train
step of `--config` (default mn40_12view), B = 2, in bf16 and in fp32 from
the same weights and batch, dropout off, at 64x64 for seeds 0-2 and at
96x96 for seed 0 (80x80 and 96x96 for Inception-v3, v4 and
Inception-ResNet-v2, which need 75x75 at least): the relative gaps of loss
and grad_norm, the cosine of the flattened gradients (all, `Logits`, and
each layer group), and the worst ratio of one parameter tensor's gradient
norms.  For an fp32 config (the
card runs its convs outside the stem in TF32) it compares fp32 with
TF32-rounded conv inputs (`tf32_convs`) instead.  `--size N` runs seeds
0-2 at NxN instead.  `chip_smoke.py` derives its card-vs-CPU bounds for
the train step from these numbers.

`serve-drift` (on the CPU, no device measurement): the serving forward of
`--config` (seeded weights, folded BN, eval mode; `--calibrate`: BN
statistics calibrated to the views first), B = 2, in the config's
compute dtype against fp32 (for an fp32 config: with TF32-rounded conv
inputs), at 96x96 (`--size`) for seeds 0-2: max|dlogit| over max|logit|,
max|dscore| where the model has scores, and whether the argmaxes agree;
`chip_smoke.py`'s card-vs-CPU serving bounds come from these.

`dp-drift` (on the CPU, no device measurement): one `bn_sync="global"`
train step of `--config` (default mn40_12view, mn40_12view_dp8's model;
its compute dtype, dropout on) over 2 gloo ranks of B = 2, 4 views, 64x64 (`--size`),
against one process's step on the B = 4 batch, seeds 0-2: loss and
grad_norm relative gaps and the `Logits` gradient's cosine, the numbers
`chip_smoke.py` phase 12's global-mode bounds come from.

`retrieval-drift` (on the CPU, no device measurement): `extract_descriptors`
of `--config` (seeded weights, BatchNorm at its init statistics) over the
first 8 procedural validation shapes at 96x96 (`--size`), seeds 0-2, in the
config's compute dtype against fp32: the smallest and the mean per-shape
cosine of the descriptors, the numbers `chip_smoke.py` phase 13's
card-vs-CPU retrieval bound comes from.

Each result is one line of JSON (after the card's name and power limit);
TF32 as PyTorch's defaults, as the port runs.  Except for the four
`-drift` runs, it needs a card: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# (size, seed) of each `train-drift` run, at the config's view count; the
# sizes of the backbones that need 75x75 at least.
DRIFT_RUNS = ((64, 0), (64, 1), (64, 2), (96, 0))
DRIFT_RUNS_75 = ((80, 0), (80, 1), (80, 2), (96, 0))
# A parameter's gradient norm below this share of the global norm, on both
# sides of a drift comparison, is rounding noise (`train_step_drift`).
NOISE_REL = 1e-6
PROFILE_TRIES = 3
# `remat`: (name, config fields) of each variant.
REMAT_VARIANTS = (
    ("none", {}),
    ("until_MaxPool_2a_3x3", dict(remat_until="MaxPool_2a_3x3")),
    ("until_Conv2d_2c_3x3", dict(remat_until="Conv2d_2c_3x3")),
    ("until_MaxPool_3a_3x3", dict(remat_until="MaxPool_3a_3x3")),
    ("until_Mixed_3c", dict(remat_until="Mixed_3c")),
    ("backbone", dict(remat_backbone=True)),
    ("both", dict(remat_backbone=True, remat_until="MaxPool_3a_3x3")),
)
REMAT_MAX_BATCH = 1024
# `remat` times steps at this share of a variant's largest batch: at the
# largest batch itself a step that fit once runs out of memory again in
# the cache the search left fragmented.
REMAT_TIMED_SHARE = 0.9


def cuda_samples(fn, runs=30, warmup=5, chunk=1):
    """ms a fn() call in each of `runs` chunks of `chunk` calls, CUDA
    events around each chunk, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chunk):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / chunk)
    return times


def cuda_ms(fn, runs=30, warmup=5):
    """Median time of fn() in ms, CUDA events around each run."""
    return statistics.median(cuda_samples(fn, runs, warmup))


def host_us(fn, calls=200):
    """Mean host time of one fn() call in us: the enqueue, not the run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def graph_ms(fn, calls, replays=10):
    """Median time of one CUDA-graph replay of `calls` fn() calls, over
    `calls`: device time per call, without the host's launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, runs=replays, warmup=2) / calls


def kernel_durations_us(fn, calls=20):
    """{kernel name: [duration of each launch in us]} of fn() run `calls`
    times under torch.profiler (device activity only)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return out


def kernel_us(fn, name_part, calls=20):
    """Mean device duration in us of the launches of the kernel whose name
    contains `name_part`, and their count per fn() call.  A window in
    which the profiler saw none of them is profiled again, up to
    PROFILE_TRIES windows: on the card's machine the profiler once returned
    no activity for a window of 20 grouping-kernel launches that the same
    script profiled in every other run."""
    for _ in range(PROFILE_TRIES):
        durs = [d for name, ds in kernel_durations_us(fn, calls).items()
                if name_part in name for d in ds]
        if durs:
            return statistics.fmean(durs), len(durs) / calls
    raise RuntimeError(f"the profiler saw no kernel named *{name_part}* in "
                       f"{PROFILE_TRIES} windows")


def card_line():
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip()


def measure_wrappers(dev):
    rs = np.random.RandomState(0)
    w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(np.float32))
    w = w.to(dev, torch.bfloat16)     # made outside inference mode, as a
    with torch.inference_mode():      # model's weight is
        return _measure_wrappers(dev, rs, w)


def _measure_wrappers(dev, rs, w):
    from gvcnn_tf_tpu_torch.ops.grouping_kernel import group_and_fuse
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv

    rows = []
    for n in (96, 12):
        x = torch.from_numpy(rs.uniform(-1, 1, (n, 224, 224, 3))
                             .astype(np.float32)).to(dev, torch.bfloat16)
        fn = lambda: stem_conv(x, w)                       # noqa: E731
        dev_us, per_call = kernel_us(fn, "stem_conv")
        rows.append(dict(kernel="stem", shape=[n, 224, 224, 3],
                         host_us=host_us(fn), event_ms=cuda_ms(fn),
                         device_ms=dev_us / 1e3, launches_per_call=per_call,
                         graph_ms=graph_ms(fn, 10)))
    for b in (8, 1):
        s = torch.from_numpy(rs.dirichlet(np.ones(12), size=b)
                             .astype(np.float32)).to(dev)
        d = torch.from_numpy(rs.randn(b, 12, 1024).astype(np.float32))
        d = d.to(dev)
        fn = lambda: group_and_fuse(s, d, 8)               # noqa: E731
        dev_us, per_call = kernel_us(fn, "group_and_fuse")
        rows.append(dict(kernel="grouping", shape=[b, 12, 1024, 8],
                         host_us=host_us(fn), event_ms=cuda_ms(fn),
                         device_ms=dev_us / 1e3, launches_per_call=per_call,
                         graph_ms=graph_ms(fn, 100)))
    return rows


def measure_stem_f32(dev):
    import torch.nn.functional as F

    from gvcnn_tf_tpu_torch.ops.pool import same_pads
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv, stem_conv_plain

    rs = np.random.RandomState(11)
    w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(
        np.float32)).to(dev)
    affine = tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                   for a in (rs.uniform(0.5, 2.0, 64),
                             rs.uniform(-1.0, 1.0, 64)))
    shape = (8, 224, 224, 3)
    x = torch.from_numpy(rs.uniform(-1, 1, shape).astype(np.float32)).to(dev)
    ph, pw = same_pads(224, 7, 2), same_pads(224, 7, 2)
    cudnn = torch.backends.cudnn

    def tf32(allow):
        return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                           deterministic=cudnn.deterministic,
                           allow_tf32=allow)

    row = dict(kernel="stem_f32", shape=list(shape))
    with torch.inference_mode():
        xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
        for tag, args in (("", ()), ("epilogue_", affine)):
            fn = lambda: stem_conv(x, w, *args, relu=bool(args))  # noqa: E731
            got = fn()
            with tf32(False):
                want = stem_conv_plain(x, w, *args, relu=bool(args))
            row[f"{tag}max_rel_err"] = ((got - want).abs().max()
                                        / want.abs().max()).item()
            row[f"{tag}event_ms"] = cuda_ms(fn)
            row[f"{tag}device_ms"] = kernel_us(fn, "stem_conv_f32")[0] / 1e3
        for tag, allow in (("fp32", False), ("tf32", True)):
            with tf32(allow):
                row[f"cudnn_{tag}_ms"] = cuda_ms(
                    lambda: F.conv2d(xn, w, stride=2))
    return [row]


# Variants of csrc/stem_conv.cu for `stem-probe`: name -> [(old, new)].
_MMA = "mma_tf32(acc[mi][2 * jp{}], {}[mi], {}.{}, {}.{});"
_SMALL_MMAS = [(_MMA.format(j, a, b, x, b, y), "")
               for j, x, y in (("", "x", "y"), (" + 1", "z", "w"))
               for a, b in (("as", "bb"), ("ab", "bs"))]
_BIG_MMAS = [(_MMA.format(j, "ab", "bb", x, "bb", y), "")
             for j, x, y in (("", "x", "y"), (" + 1", "z", "w"))]
_FORCE_BAND = "  if (s.band == 0) return static_cast<int>(cudaErrorInvalidValue);"
STEM_PROBE_EDITS = {
    "kernel": [],
    # big_a big_b alone: a single TF32 product (what the split costs).
    "one_product": _SMALL_MMAS,
    # No MMAs: staging, the weight split and the epilogue's stores.
    "no_mma": _SMALL_MMAS + _BIG_MMAS,
    # The launcher picks 7 rows at N = 8, 224x224 (one tile a block); 4
    # (two tiles a block, the next one's rows staged during this one's
    # MMAs) is the bf16 kernel's band.
    "band_4": [(_FORCE_BAND, "  s.band = 4;\n" + _FORCE_BAND)],
    # The A split by integer rounding (finite inputs only) instead of
    # cvt.rna.
    "int_rna_a": [(
        "split_tf32(arow[abase[mi][r & 1] + 8 * sub + 4 * (r >> 1)],\n"
        "                     ab[mi][r], as[mi][r]);",
        "const float v = arow[abase[mi][r & 1] + 8 * sub + 4 * (r >> 1)];\n"
        "ab[mi][r] = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
        "as[mi][r] = (__float_as_uint(v - __uint_as_float(ab[mi][r])) + "
        "0x1000u) & 0xffffe000u;")],
}


def stem_probe_sources(src: str) -> dict:
    """{variant: source}: `STEM_PROBE_EDITS` applied to the stem source."""
    out = {}
    for name, edits in STEM_PROBE_EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise ValueError(f"stem-probe {name}: the source no longer "
                                 f"holds {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def stem_probe(dev):
    import ctypes
    import shutil
    import tempfile

    import torch.nn.functional as F

    from gvcnn_tf_tpu_torch.ops import _build
    from gvcnn_tf_tpu_torch.ops.pool import same_pads
    from gvcnn_tf_tpu_torch.ops.stem_kernel import (KERNEL_NAME_F32,
                                                    pack_stem_weight_f32)

    sources = stem_probe_sources((_build.CSRC / "stem_conv.cu").read_text())
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="stem_probe_", dir=_build.BUILD_ROOT))
    try:
        for name, text in sources.items():
            (tmp / f"{name}.cu").write_text(text)
        procs = {name: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name in sources}
        logs = {name: proc.communicate()[0] for name, proc in procs.items()}
        fns = {}
        for name, proc in procs.items():
            if proc.returncode != 0:
                raise RuntimeError(
                    f"stem-probe {name}: nvcc failed:\n{logs[name]}")
            fn = getattr(ctypes.CDLL(str(tmp / f"{name}.so")),
                         KERNEL_NAME_F32)
            fn.argtypes = list(_build._SIGNATURES[KERNEL_NAME_F32])
            fn.restype = ctypes.c_int
            fns[name] = fn
    finally:
        shutil.rmtree(tmp, ignore_errors=True)   # loaded libraries stay

    rs = np.random.RandomState(11)
    w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(
        np.float32)).to(dev)
    packed = pack_stem_weight_f32(w).contiguous()
    cudnn = torch.backends.cudnn
    cases = []
    for n in (8, 96):
        x = torch.from_numpy(rs.uniform(-1, 1, (n, 224, 224, 3)).astype(
            np.float32)).to(dev)
        xn = F.pad(x.permute(0, 3, 1, 2), (2, 3, 2, 3))
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            want = F.conv2d(xn, w, stride=2).permute(0, 2, 3, 1)
        cases.append((n, x, x.new_empty(want.shape), want))

    def launch(fn, x, out):
        _build.check(fn(
            x.data_ptr(), packed.data_ptr(), None, None, out.data_ptr(),
            x.shape[0], 224, 224, 112, 112, same_pads(224, 7, 2)[0],
            same_pads(224, 7, 2)[0], 0,
            torch.cuda.current_stream().cuda_stream), KERNEL_NAME_F32)

    rows = {name: dict(kernel="stem_f32_probe", variant=name,
                       edits=len(STEM_PROBE_EDITS[name]))
            for name in fns}
    for name, fn in fns.items():
        for n, x, out, want in cases:
            launch(fn, x, out)
            torch.cuda.synchronize()
            rows[name][f"max_rel_err_{n}"] = ((out - want).abs().max()
                                              / want.abs().max()).item()
    for name in list(fns) + list(fns)[::-1]:
        for n, x, out, _ in cases:
            us = kernel_us(lambda: launch(fns[name], x, out), "stem_conv_f32")
            rows[name].setdefault(f"device_ms_{n}", []).append(us[0] / 1e3)
    return list(rows.values())


def serving_model(dev, config="mn40_12view"):
    """The model of `config` as the inference engine holds it."""
    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.utils import fold_batch_norm

    cfg = get_config(config)
    model = fold_batch_norm(init_weights(build_model(cfg), cfg.train.seed))
    model.cast_convs_()
    return cfg, model.to(dev, memory_format=torch.channels_last).eval()


def profile_forward(dev, config="mn40_12view", top=20):
    cfg, model = serving_model(dev, config)
    with torch.inference_mode():
        return _profile_forward(dev, cfg, model, top)


def _profile_forward(dev, cfg, model, top):
    from torch.profiler import ProfilerActivity, profile

    from gvcnn_tf_tpu_torch.utils.images import normalize_views

    d = cfg.data
    rs = np.random.RandomState(2)
    rows = []
    for b in (8, 1):
        x = torch.from_numpy(rs.randint(0, 256, (b, d.num_views, d.height,
                                                 d.width, 3), np.uint8))
        x = x.to(dev)
        fwd = lambda: model(normalize_views(x))            # noqa: E731
        fwd_ms = cuda_ms(fwd, runs=20)
        per_kernel = kernel_durations_us(fwd, calls=3)
        total = {k: sum(v) / 3 / 1e3 for k, v in per_kernel.items()}
        busy = sum(total.values())
        ranked = sorted(total.items(), key=lambda kv: -kv[1])
        rows.append(dict(profile=f"forward B={b}", forward_ms=fwd_ms,
                         device_busy_ms=busy, idle_share=1 - busy / fwd_ms,
                         kernels=[dict(name=k[:100], ms=v, share=v / busy,
                                       launches=len(per_kernel[k]) // 3)
                                  for k, v in ranked[:top]]))

    stem = getattr(model.backbone, "Conv2d_1a_7x7", None)
    if type(stem).__name__ != "Stem":     # the stem kernel's layer only
        return rows
    n = d.batch_size * d.num_views
    x = torch.from_numpy(rs.uniform(-1, 1, (n, d.height, d.width, 3))
                         .astype(np.float32)).to(dev, model.compute_dtype)
    stem(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stem(x)
        torch.cuda.synchronize()
    ops = [dict(name=e.name[:100], device=str(e.device_type).split(".")[-1],
                us=e.time_range.elapsed_us()) for e in prof.events()
           if e.name.startswith("aten::")
           or e.device_type == torch.autograd.DeviceType.CUDA]
    rows.append(dict(profile=f"Stem.forward {tuple(x.shape)}", events=ops))
    return rows


# Kernel classes of a train step, by substrings of the kernel's name (the
# first that matches).
_CLASSES = (
    ("K2 stem kernel", ("stem_conv",)),
    ("K1 grouping kernel", ("group_and_fuse",)),
    ("max-pool", ("max_pool",)),
    ("avg-pool", ("avg_pool",)),
    ("batch-norm", ("batch_norm", "batchnorm")),
    ("optimizer (foreach)", ("foreach", "multi_tensor")),
    ("conv (cuDNN)", ("conv", "cudnn", "xmma", "dgrad", "wgrad", "fprop",
                      "implicit", "sm90_", "nhwc")),
    ("gemm", ("gemm", "cutlass", "ampere", "sm80")),
    ("concat", ("cat",)),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "memcpy")),
    ("elementwise", ("elementwise", "where", "fill")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, parts in _CLASSES:
        if any(p in low for p in parts):
            return cls
    return "other"


def train_batch(cfg, rs, dev, dtype=torch.bfloat16):
    """A fixed synthetic-looking batch of cfg's shape on `dev`."""
    d = cfg.data
    views = rs.uniform(-1, 1, (d.batch_size, d.num_views, d.height, d.width,
                               3)).astype(np.float32)
    labels = rs.randint(0, d.num_classes, d.batch_size)
    return {"views": torch.from_numpy(views).to(dev, dtype),
            "label": torch.from_numpy(labels).to(dev)}


def device_batch(cfg, b, dev, seed=0):
    """A batch of `b` shapes of cfg's views, uniform in [-1, 1), made on
    `dev` in cfg's compute dtype (no host copy, so large batches are
    cheap), and labels."""
    d = cfg.data
    g = torch.Generator(device=dev).manual_seed(seed)
    views = torch.rand((b, d.num_views, d.height, d.width, 3), generator=g,
                       device=dev, dtype=getattr(torch, cfg.compute_dtype))
    return {"views": views.mul_(2).sub_(1),
            "label": torch.randint(0, d.num_classes, (b,), generator=g,
                                   device=dev)}


def release_memory(dev):
    """Collect garbage and return the allocator's cached blocks, so that
    the next peak-memory reading starts from what is live."""
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()


def _step_fits(state, cfg, b, dev):
    """Peak memory in bytes of one train step at batch `b`, or None when it
    raises `torch.cuda.OutOfMemoryError` (the answer `largest_batch`
    searches for)."""
    from gvcnn_tf_tpu_torch.train import train_step

    release_memory(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fits = True
    try:
        train_step(state, device_batch(cfg, b, dev), cfg)
        torch.cuda.synchronize(dev)
    except torch.cuda.OutOfMemoryError:
        fits = False
    # Outside the handler, so that no traceback holds the step's tensors.
    for p in state.optimizer.params:
        p.grad = None
    release_memory(dev)
    return torch.cuda.max_memory_allocated(dev) if fits else None


def _step_ms_at(state, cfg, b, dev, runs=3):
    """Median CUDA-event time of `runs` train steps at batch `b` after one
    warm step, or None where one raises `torch.cuda.OutOfMemoryError` (a
    batch that fit once can miss again in a fragmented cache)."""
    from gvcnn_tf_tpu_torch.train import train_step

    release_memory(dev)
    batch = device_batch(cfg, b, dev)
    ms = None
    try:
        ms = cuda_ms(lambda: train_step(state, batch, cfg), runs=runs,
                     warmup=1)
    except torch.cuda.OutOfMemoryError:
        pass
    del batch
    for p in state.optimizer.params:
        p.grad = None
    release_memory(dev)
    return ms


def largest_batch(state, cfg, dev, start=8, limit=REMAT_MAX_BATCH):
    """(largest batch that fits, its peak bytes, probes): doubling from
    `start`, then bisecting between the last fit and the first miss, to
    one shape; `limit` caps the doubling."""
    fit, peak, miss, probes = 0, None, None, 0
    b = start
    while b <= limit:
        probes += 1
        got = _step_fits(state, cfg, b, dev)
        if got is None:
            miss = b
            break
        fit, peak, b = b, got, 2 * b
    while miss is not None and miss - fit > 1:
        mid = (fit + miss) // 2
        probes += 1
        got = _step_fits(state, cfg, mid, dev)
        if got is None:
            miss = mid
        else:
            fit, peak = mid, got
    return fit, peak, probes


def remat_variants(dev, config="mn40_12view", batch=8):
    """`remat`: one row a variant (see the docstring)."""
    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    base = get_config(config)
    rows = {name: dict(variant=name, **kw, batch=batch, step_ms=[],
                       peak_gb=[])
            for name, kw in REMAT_VARIANTS}
    for name, kw in REMAT_VARIANTS + REMAT_VARIANTS[::-1]:
        cfg = base.replace(**kw)
        state = create_train_state(cfg, dev)
        b = device_batch(cfg, batch, dev)
        release_memory(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        rows[name]["step_ms"].append(cuda_ms(
            lambda: train_step(state, b, cfg), runs=10, warmup=3))
        rows[name]["peak_gb"].append(torch.cuda.max_memory_allocated(dev)
                                     / 1e9)
        del state, b
    release_memory(dev)
    for name, kw in REMAT_VARIANTS:
        cfg = base.replace(**kw)
        state = create_train_state(cfg, dev)
        t0 = time.perf_counter()
        fit, peak, probes = largest_batch(state, cfg, dev)
        search_s = time.perf_counter() - t0
        timed = max(1, int(REMAT_TIMED_SHARE * fit))
        ms = _step_ms_at(state, cfg, timed, dev) if fit else None
        views = fit * cfg.data.num_views
        rows[name].update(
            timed_batch=timed, timed_batch_step_ms=ms,
            timed_batch_views_per_s=None if ms is None
            else timed * cfg.data.num_views / ms * 1e3,
            views_per_s=[batch * cfg.data.num_views / t * 1e3
                         for t in rows[name]["step_ms"]],
            largest_batch=fit, largest_batch_views=views,
            largest_batch_peak_gb=None if peak is None else peak / 1e9,
            capped=fit >= REMAT_MAX_BATCH, probes=probes, search_s=search_s,
            limit="torch.cuda.OutOfMemoryError at the next shape, the "
                  "answer searched for" if fit < REMAT_MAX_BATCH
                  else f"the search's cap of {REMAT_MAX_BATCH}")
        del state
        release_memory(dev)
    return [dict(run=f"remat of {config}", **row) for row in rows.values()]


def grad_group(name: str) -> str:
    """A parameter's group for the drift readings: its layer or Mixed
    block (a ResNet unit's block), then `kernel`, `bn_bias`, `bn_scale` or
    `bias` ('InceptionV1.Mixed_5c.Branch_1_Conv2d_0b_3x3.BatchNorm.bias' ->
    'Mixed_5c/bn_bias'; 'ResNet50.block4_unit3.conv3.BatchNorm.scale' ->
    'block4/bn_scale')."""
    from gvcnn_tf_tpu_torch.models.backbones import BACKBONES

    parts = name.split(".")
    scopes = {cls.NAME for cls in BACKBONES.values()}
    top = parts[1] if parts[0] in scopes else parts[0]
    top = top.split("_unit")[0]
    kind = ("bn_scale" if name.endswith("BatchNorm.scale") else
            "bn_bias" if "BatchNorm" in parts else
            "kernel" if name.endswith("weight") else "bias")
    return f"{top}/{kind}"


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 t rounded to TF32 (10 mantissa bits, to nearest), with the
    gradient passed straight through."""
    from gvcnn_tf_tpu_torch.ops.stem_kernel import tf32_rna

    return t + (tf32_rna(t.detach()) - t).detach()


@contextlib.contextmanager
def tf32_convs():
    """Within: every `layers.conv2d_tf` (the convs of `ConvBN`, every conv
    of an Inception-v1 model but the stem's) rounds its fp32 input and
    weight to TF32 before the conv, as cuDNN's default TF32 path on the
    card does; the stem's fp32 kernel keeps fp32 accuracy (3xTF32)."""
    from gvcnn_tf_tpu_torch.models.backbones import layers

    real = layers.conv2d_tf

    def conv(x, weight, *args, **kw):
        if x.dtype == torch.float32:
            x, weight = _tf32(x), _tf32(weight.float())
        return real(x, weight, *args, **kw)

    layers.conv2d_tf = conv
    try:
        yield
    finally:
        layers.conv2d_tf = real


def train_step_drift(cfg, dev, ref_dev="cpu", seed=0, first=None):
    """One train step of `cfg` on `dev` (inside the context `first()`, if
    given) and of `cfg` in fp32 on `ref_dev`, from the same seeded weights
    and batch, dropout off -> the two losses,
    grad norms, their relative gaps, and, from the gradients the step
    leaves in `.grad`:

      grad_cosine, logits_grad_cosine  cosine of all gradients flattened,
                                       and of the `Logits` layer's
      layer_logratio, layer_worst      max over parameter tensors of
                                       |ln(||g|| / ||g_ref||)|, and where
      layer_min_rel                    the least ||g_ref|| / grad_norm_ref
                                       among those tensors
      noise, noise_max_rel             the tensors left out, and the
                                       largest ||g|| / grad_norm_ref there
      group_cosines                    cosine per `grad_group`

    A tensor whose gradient norm is below NOISE_REL x grad_norm_ref on
    both sides is left out of `layer_logratio`: its gradient is 0
    analytically and what it holds is rounding noise.  Two such: the
    score-logit bias under a softmax over views (a shift of every view's
    logit leaves the softmax as it is), and, when every view's score falls
    in the first group (12 views at init: softmax scores near 1/12 <
    1/M), the scoring FCN's BatchNorm bias, as the fused descriptor then
    does not depend on the scores."""
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    cfg = cfg.replace(dropout_keep_prob=1.0)
    ref_cfg = cfg.replace(compute_dtype="float32")
    batch = train_batch(cfg, np.random.RandomState(seed), "cpu",
                        torch.float32)
    out = {}
    grads = []
    for name, c, d in (("", cfg, dev), ("_ref", ref_cfg, ref_dev)):
        state = create_train_state(c, d)
        with (first() if first and not name else contextlib.nullcontext()):
            mets = train_step(state, {k: t.to(d) for k, t in batch.items()},
                              c)
        out.update({f"{k}{name}": float(v) for k, v in mets.items()})
        grads.append({n: p.grad.detach().double().flatten().cpu()
                      for n, p in state.model.named_parameters()})
    out["loss_rel"] = abs(out["loss"] - out["loss_ref"]) / abs(
        out["loss_ref"])
    out["grad_norm_rel"] = abs(out["grad_norm"] - out["grad_norm_ref"]) / (
        out["grad_norm_ref"])
    cos = lambda names: float(torch.nn.functional.cosine_similarity(  # noqa
        *(torch.cat([g[n] for n in names]) for g in grads), dim=0))
    names = list(grads[0])
    out["grad_cosine"] = cos(names)
    out["logits_grad_cosine"] = cos([n for n in names
                                     if n.startswith("Logits.")])
    floor = NOISE_REL * out["grad_norm_ref"]
    norms = {n: [float(g[n].norm()) for g in grads] for n in names}
    noise = [n for n, ar in norms.items() if max(ar) < floor]
    ratios = {n: (0.0 if a == r else math.inf if 0 in (a, r)
                  else abs(math.log(a / r)))
              for n, (a, r) in norms.items() if n not in noise}
    out["layer_worst"] = max(ratios, key=ratios.get)
    out["layer_logratio"] = ratios[out["layer_worst"]]
    out["layer_min_rel"] = min(norms[n][1] for n in ratios) / (
        out["grad_norm_ref"])
    out["noise"] = noise
    out["noise_max_rel"] = max((max(norms[n]) for n in noise),
                               default=0.0) / out["grad_norm_ref"]
    groups = {}
    for n in names:
        groups.setdefault(grad_group(n), []).append(n)
    out["group_cosines"] = {k: cos(v) for k, v in groups.items()}
    return out


@torch.no_grad()
def calibrate_bn(model, x):
    """In place: each BatchNorm's running statistics from its input, layer
    after layer, in one eval-mode forward of x (the views, unfolded BN):
    mean 0, var the input's mean square floored at the layer's average, as
    `tests/test_torch_backbones.py::calibrate_bn` sets them (without its
    random weights), so that a seeded network keeps O(1) activations.
    Inception-v1's stem runs its BatchNorm as the conv's epilogue, so its
    statistics come from the plain conv's output."""
    from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import Stem
    from gvcnn_tf_tpu_torch.models.backbones.layers import BatchNorm
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv_plain

    def hook(bn, args):
        sq = args[0].float().square().mean(dim=(0, 2, 3))
        bn.running_mean.zero_()
        bn.running_var.copy_(sq + sq.mean())

    def stem_hook(stem, args):
        y = stem_conv_plain(args[0], stem.conv.weight)
        hook(stem.BatchNorm, (y.permute(0, 3, 1, 2),))

    handles = [m.register_forward_pre_hook(
        stem_hook if isinstance(m, Stem) else hook)
        for m in model.modules() if isinstance(m, (BatchNorm, Stem))]
    try:
        model.eval()(x)
    finally:
        for h in handles:
            h.remove()
    return model


def serve_drift(cfg, seed=0, calibrate=False):
    """The serving forward of `cfg` (seeded, folded, eval) on the CPU, B =
    2, in its compute dtype (fp32 with TF32-rounded conv inputs for an fp32
    config) against fp32 -> {logit_rel, score_abs, argmax_equal}.  With
    `calibrate`, the BatchNorm statistics are first calibrated to the
    views (`calibrate_bn`)."""
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.utils import fold_batch_norm

    d = cfg.data
    x = torch.from_numpy(np.random.RandomState(seed).uniform(
        -1, 1, (2, d.num_views, d.height, d.width, 3)).astype(np.float32))
    ref = init_weights(build_model(cfg.replace(compute_dtype="float32")),
                       cfg.train.seed)
    if calibrate:
        calibrate_bn(ref, x)
    ref = fold_batch_norm(ref).eval()
    model = build_model(cfg).eval()
    model.load_state_dict(ref.state_dict())
    model.cast_convs_()
    fp32 = cfg.compute_dtype == "float32"
    with torch.no_grad():
        want, wep = ref(x)
        with (tf32_convs() if fp32 else contextlib.nullcontext()):
            got, gep = model(x)
    got = got.float()
    out = dict(logit_rel=float((got - want).abs().max() / want.abs().max()),
               max_logit=float(want.abs().max()),
               argmax_equal=bool(torch.equal(got.argmax(-1),
                                             want.argmax(-1))))
    if "view_discrimination_scores" in wep:
        out["score_abs"] = float((gep["view_discrimination_scores"].float()
                                  - wep["view_discrimination_scores"])
                                 .abs().max())
    return out


def retrieval_drift(cfg, seed=0, shapes=8):
    """`extract_descriptors` of `cfg` (seeded weights, BatchNorm at its
    init statistics, as a short run leaves them) on the CPU over the first
    `shapes` shapes of the procedural validation split, in its compute
    dtype against fp32 -> {cos_min, cos_mean}: the per-shape cosine of the
    two L2-normalized descriptors."""
    from gvcnn_tf_tpu_torch.bridge import state_dict_to_jax
    from gvcnn_tf_tpu_torch.data import make_dataset
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.tools.retrieval import extract_descriptors

    ref = init_weights(build_model(cfg.replace(compute_dtype="float32")),
                       seed)
    variables = state_dict_to_jax(ref.state_dict())
    data = dataclasses.replace(cfg.data, dataset="procedural",
                               transfer_dtype="uint8", batch_size=shapes,
                               synthetic_num_shapes=shapes)
    batch = next(make_dataset(data, train=False, seed=seed, num_epochs=1))
    got, want = (extract_descriptors(
        c.replace(data=data), state=variables, dataset_iter=[batch],
        device="cpu")[0] for c in (cfg, cfg.replace(compute_dtype="float32")))
    cos = (got * want).sum(-1)
    return dict(cos_min=float(cos.min()), cos_mean=float(cos.mean()))


def dp_drift_rank(init_method, out_dir, cfg, batch):
    """One rank of `dp_drift`: one global-mode step on its rows of batch."""
    from gvcnn_tf_tpu_torch.parallel import (
        initialize_distributed,
        rank_rows,
        shutdown,
    )
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    import datetime

    world = initialize_distributed("gloo", datetime.timedelta(seconds=120),
                                   device="cpu", init_method=init_method)
    state = create_train_state(cfg, "cpu", world)
    rows = {k: torch.from_numpy(v) for k, v in
            rank_rows(batch, world).items()}
    mets = train_step(state, rows, cfg)
    torch.save({"mets": {k: float(v) for k, v in mets.items()},
                "logits_grad": state.model.Logits.weight.grad.clone()},
               f"{out_dir}/rank{world.rank}.pt")
    shutdown(world)


def dp_drift(cfg, seed=0):
    """`cfg`'s global-mode step over 2 gloo ranks on the CPU (in its
    compute dtype, dropout as configured) against one process's step on the
    whole batch -> {loss_rel, grad_norm_rel, logits_grad_cosine}: what
    the BatchNorm statistics' other rounding (Flax's fast variance over the
    ranks, PyTorch's Welford pass in one process) and the convs' other
    batch size change in one step."""
    import tempfile

    from gvcnn_tf_tpu_torch.parallel import spawn
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    d = cfg.data
    rs = np.random.RandomState(seed)
    batch = {"views": rs.uniform(-1, 1, (d.batch_size, d.num_views,
                                         d.height, d.width, 3))
             .astype(np.float32),
             "label": rs.randint(0, d.num_classes, d.batch_size)}
    with tempfile.TemporaryDirectory() as out:
        spawn(dp_drift_rank, 2, args=(out, cfg, batch), timeout=600)
        ranks = [torch.load(f"{out}/rank{r}.pt") for r in range(2)]
    state = create_train_state(cfg, "cpu")
    want = train_step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, cfg)
    got, g = ranks[0]["mets"], ranks[0]["logits_grad"]
    w = state.model.Logits.weight.grad
    return dict(
        loss_rel=abs(got["loss"] - float(want["loss"]))
        / float(want["loss"]),
        grad_norm_rel=abs(got["grad_norm"] - float(want["grad_norm"]))
        / float(want["grad_norm"]),
        logits_grad_cosine=float((g * w).sum() / (g.norm() * w.norm())),
        replicas_equal=ranks[0]["mets"] == ranks[1]["mets"])


def profile_train(dev, config="mn40_12view", top=25):
    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    cfg = get_config(config)
    state = create_train_state(cfg, dev)
    batch = train_batch(cfg, np.random.RandomState(3), dev,
                        getattr(torch, cfg.compute_dtype))
    step = lambda: train_step(state, batch, cfg)             # noqa: E731
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(step, runs=10, warmup=3)
    per_kernel = kernel_durations_us(step, calls=3)
    total = {k: sum(v) / 3 / 1e3 for k, v in per_kernel.items()}
    busy = sum(total.values())
    classes = {}
    for k, ms in total.items():
        c = classes.setdefault(kernel_class(k), [0.0, 0])
        c[0] += ms
        c[1] += len(per_kernel[k]) // 3
    views = cfg.data.batch_size * cfg.data.num_views
    ranked = sorted(total.items(), key=lambda kv: -kv[1])
    return [dict(
        profile=f"{config} train step B={cfg.data.batch_size}",
        step_ms=step_ms,
        views_per_s=views / step_ms * 1e3, device_busy_ms=busy,
        idle_share=1 - busy / step_ms,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        classes=[dict(name=c, ms=v[0], share=v[0] / busy, launches=v[1])
                 for c, v in sorted(classes.items(),
                                    key=lambda kv: -kv[1][0])],
        kernels=[dict(name=k[:100], ms=v, share=v / busy,
                      launches=len(per_kernel[k]) // 3)
                 for k, v in ranked[:top]])]


def trace_windows(dev, windows):
    """`trace-windows`: one row a profiled window (see the docstring)."""
    import importlib
    import shutil
    import tempfile

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.ops.grouping_kernel import group_and_fuse
    from gvcnn_tf_tpu_torch.parallel import World

    train_mod = importlib.import_module("gvcnn_tf_tpu_torch.train")
    base = get_config("mn40_12view")
    rs = np.random.RandomState(0)
    scores = torch.from_numpy(rs.rand(8, 12).astype(np.float32)).to(dev)
    descs = torch.from_numpy(rs.rand(8, 12, 1024).astype(np.float32)).to(dev)
    rows = []
    for i in range(windows):
        kernel_durations_us(lambda: group_and_fuse(scores, descs, 8), calls=5)
        logdir = tempfile.mkdtemp(prefix="gvcnn_trace_windows_")
        cfg = base.replace(
            data=dataclasses.replace(base.data, dataset="procedural",
                                     transfer_dtype="uint8"),
            train=dataclasses.replace(base.train, train_logdir=logdir,
                                      log_every=6, checkpoint_every=6))
        try:
            train_mod.train(cfg, num_steps=6, profile_steps=(3, 5),
                            device=dev)
            with open(Path(logdir) / train_mod.trace_name((3, 5),
                                                          World())) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(logdir, ignore_errors=True)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        launches = [e for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "LaunchKernel" in e["name"]]
        device = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        spans = [e for e in events if e.get("cat") == "user_annotation"]
        lo = min(e["ts"] for e in spans)
        hi = max([b for _, b in device] + [e["ts"] + e["dur"]
                                           for e in spans])
        busy = sum(b - a for a, b in _union(device, lo, hi))
        rows.append(dict(
            window=i, launches=len(launches),
            kernels=len(kernels),
            stem=sum("stem_conv_mma_kernel" in e["name"] for e in kernels),
            grouping=sum("group_and_fuse_kernel" in e["name"]
                         for e in kernels),
            idle=1 - busy / (hi - lo)))
    return rows


def _union(intervals, lo, hi):
    """The union of [a, b) intervals clipped to [lo, hi), as intervals."""
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("wrappers", "stem-f32", "stem-probe",
                                     "profile", "trace-windows", "remat",
                                     "train-drift",
                                     "serve-drift", "dp-drift",
                                     "retrieval-drift"))
    ap.add_argument("--root", default=None,
                    help="checkout whose gvcnn_tf_tpu_torch to measure "
                    "(default: the one holding this file)")
    ap.add_argument("--train", action="store_true",
                    help="profile: the train step instead of the forward")
    ap.add_argument("--config", default="mn40_12view",
                    help="profile, remat, train-drift, serve-drift: the "
                    "named config")
    ap.add_argument("--backbone", default=None,
                    help="serve-drift: swap the config's backbone")
    ap.add_argument("--size", type=int, default=None,
                    help="train-drift, serve-drift, dp-drift, "
                    "retrieval-drift: the views' size")
    ap.add_argument("--windows", type=int, default=20,
                    help="trace-windows: profiled windows to run")
    ap.add_argument("--calibrate", action="store_true",
                    help="serve-drift: BatchNorm statistics calibrated to "
                    "the views (`calibrate_bn`)")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root or str(Path(__file__).resolve().parents[2]))
    if args.what == "serve-drift":
        from gvcnn_tf_tpu_torch import get_config

        base = get_config(args.config)
        if args.backbone:
            base = base.replace(backbone=args.backbone)
        size = args.size or 96
        cfg = base.replace(data=dataclasses.replace(
            base.data, height=size, width=size, batch_size=2))
        calibrated = ", calibrated BN" if args.calibrate else ""
        for seed in range(3):
            print(json.dumps(dict(
                run=f"serve-drift of {args.config} ({base.backbone}) on the "
                    f"CPU, {size}x{size}, seed {seed}{calibrated}",
                **serve_drift(cfg, seed, args.calibrate))), flush=True)
        return 0
    if args.what == "retrieval-drift":
        from gvcnn_tf_tpu_torch import get_config

        base = get_config(args.config)
        size = args.size or 96
        cfg = base.replace(data=dataclasses.replace(
            base.data, height=size, width=size))
        for seed in range(3):
            print(json.dumps(dict(
                run=f"retrieval-drift of {args.config} on the CPU "
                    f"({cfg.compute_dtype} vs fp32), {size}x{size}, "
                    f"{cfg.data.num_views} views, 8 procedural val shapes, "
                    f"seed {seed}", **retrieval_drift(cfg, seed))),
                flush=True)
        return 0
    if args.what == "dp-drift":
        from gvcnn_tf_tpu_torch import get_config

        base = get_config(args.config)
        size = args.size or 64
        cfg = base.replace(num_devices=2, data=dataclasses.replace(
            base.data, height=size, width=size, num_views=4, batch_size=4))
        for seed in range(3):
            print(json.dumps(dict(
                run=f"dp-drift of {args.config} on the CPU ({cfg.compute_dtype}"
                    f", 2 gloo ranks of B=2 vs one process at B=4), "
                    f"{size}x{size}, 4 views, seed {seed}",
                **dp_drift(cfg, seed))), flush=True)
        return 0
    if args.what == "train-drift":
        from gvcnn_tf_tpu_torch import get_config

        base = get_config(args.config)
        runs = (DRIFT_RUNS_75 if base.backbone in (
            "inception_v3", "inception_v4", "inception_resnet_v2")
                else DRIFT_RUNS)
        if args.size:
            runs = tuple((args.size, seed) for seed in range(3))
        for size, seed in runs:
            cfg = base.replace(data=dataclasses.replace(
                base.data, height=size, width=size, batch_size=2))
            what = ("fp32 vs fp32 with TF32-rounded conv inputs"
                    if cfg.compute_dtype == "float32" else "bf16 vs fp32")
            drift = train_step_drift(
                cfg, "cpu", seed=seed,
                first=tf32_convs if cfg.compute_dtype == "float32" else None)
            print(json.dumps(dict(
                run=f"train-drift of {args.config} on the CPU ({what}), "
                    f"{size}x{size}, seed {seed}", **drift)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("measure: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import gvcnn_tf_tpu_torch

    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print(f"package: {gvcnn_tf_tpu_torch.__file__}", flush=True)
    rows = (measure_wrappers(dev) if args.what == "wrappers"
            else measure_stem_f32(dev) if args.what == "stem-f32"
            else stem_probe(dev) if args.what == "stem-probe"
            else trace_windows(dev, args.windows)
            if args.what == "trace-windows"
            else remat_variants(dev, args.config) if args.what == "remat"
            else profile_train(dev, args.config) if args.train
            else profile_forward(dev, args.config))
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
