"""Kernel and forward measurements of the port on one NVIDIA GPU.

    python gvcnn_tf_tpu_torch/tools/measure.py wrappers [--root DIR]
    python gvcnn_tf_tpu_torch/tools/measure.py profile

`wrappers`: each kernel wrapper at the main path's shapes (the stem at 96
and 12 views of 224x224; the grouping head at B = 8 and 1, 12 views,
C = 1024, M = 8), under torch.inference_mode() as serving calls them:
host time per call (the enqueue, no synchronise, mean of
200 calls), CUDA-event time per call (median of 30) and device time per
launch (torch.profiler kernel durations, and one CUDA graph of K calls
replayed, divided by K).  `--root DIR` measures the `gvcnn_tf_tpu_torch`
of another checkout with this file's code, so that two versions are
compared on one card in one call: parent, change, change, parent.

`profile`: the mn40_12view serving model (seeded weights, folded BN, bf16,
channels-last, uint8 views normalized on the card) at B = 8 and B = 1:
forward time (CUDA events), device busy time and idle share over 3
profiled forwards, and device time by kernel; then every op and kernel
that `Stem.forward` runs on the card.

Each result is one line of JSON (after the card's name and power limit);
TF32 is off.  Needs a card: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def cuda_ms(fn, runs=30, warmup=5):
    """Median time of fn() in ms, CUDA events around each run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    contains `name_part`, and their count per fn() call."""
    durs = [d for name, ds in kernel_durations_us(fn, calls).items()
            if name_part in name for d in ds]
    if not durs:
        raise RuntimeError(f"the profiler saw no kernel named *{name_part}*")
    return statistics.fmean(durs), len(durs) / calls


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


def serving_model(dev):
    """The mn40_12view model as the inference engine holds it."""
    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.utils import fold_batch_norm

    cfg = get_config("mn40_12view")
    model = fold_batch_norm(init_weights(build_model(cfg), cfg.train.seed))
    model.cast_convs_()
    return cfg, model.to(dev, memory_format=torch.channels_last).eval()


def profile_forward(dev, top=20):
    cfg, model = serving_model(dev)
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

    stem = model.InceptionV1.Conv2d_1a_7x7
    x = torch.from_numpy(rs.uniform(-1, 1, (96, 224, 224, 3))
                         .astype(np.float32)).to(dev, torch.bfloat16)
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
    rows.append(dict(profile="Stem.forward (96, 224, 224, 3)", events=ops))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("wrappers", "profile"))
    ap.add_argument("--root", default=None,
                    help="checkout whose gvcnn_tf_tpu_torch to measure "
                    "(default: the one holding this file)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root or str(Path(__file__).resolve().parents[2]))
    import gvcnn_tf_tpu_torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print(f"package: {gvcnn_tf_tpu_torch.__file__}", flush=True)
    rows = (measure_wrappers(dev) if args.what == "wrappers"
            else profile_forward(dev))
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
