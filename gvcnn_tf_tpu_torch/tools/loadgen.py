"""Closed-loop and open-loop multi-client serving load generator
(counterpart of `gvcnn_tf_tpu/tools/loadgen.py`).

The inference engine runs all device work on one thread (`serve.py`), so a
request's latency under load includes the queueing delay behind other
clients' inference, which a single client's p50/p99 cannot see.  This tool
measures it: N clients hammer one `InferenceEngine` in-process, mixing
request sizes across the engine's batch buckets, and report per-size and
aggregate latency percentiles and total throughput.  `rate` > 0 switches to
open-loop (Poisson) arrivals at a fixed offered load, where the achieved
rate against the offered one shows saturation.

`_pct` and `run_load` use only numpy and threads and are the JAX tool's,
line for line (a test holds them equal).  Its requests are float32 views
from `rng.rand`; an engine on the uint8 wire (`--transfer_dtype uint8`)
re-quantizes them on the host inside the timed loop (`serve.py`,
`InferenceEngine.predict`), as the JAX engine does.

Usage (library):
    from gvcnn_tf_tpu_torch.tools.loadgen import run_load
    report = run_load(engine, num_clients=4, duration_s=10.0,
                      request_sizes=(1, 8))

CLI (starts an engine from a checkpoint, runs the load, prints JSON):
    python -m gvcnn_tf_tpu_torch.tools.loadgen --config mn40_12view \
        --checkpoint_dir runs/mn40 --clients 4 --duration 10 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _pct(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile (same convention as serve.latency_stats)."""
    if not sorted_vals:
        return float("nan")
    i = min(max(math.ceil(p / 100.0 * len(sorted_vals)) - 1, 0),
            len(sorted_vals) - 1)
    return sorted_vals[i]


def run_load(
    engine,
    *,
    num_clients: int = 4,
    duration_s: float = 10.0,
    request_sizes: Sequence[int] = (1, 8),
    warmup_s: float = 1.0,
    seed: int = 0,
    rate_rps: float = 0.0,
) -> Dict:
    """Run `num_clients` closed-loop clients against `engine` for
    `duration_s` seconds; return a latency/throughput report.

    Each client cycles deterministically through `request_sizes` with a
    per-client phase offset, so at any instant the engine sees a MIX of
    sizes (small requests queueing behind large ones — the tail-latency
    scenario the single-client bench can't produce).  Requests issued
    during the first `warmup_s` are excluded from the stats.

    `rate_rps > 0` switches to OPEN-LOOP arrivals: each client draws
    exponential inter-arrival gaps targeting an aggregate `rate_rps`
    requests/sec and sends on schedule regardless of completion — the
    standard load model for measuring tail latency at a fixed offered
    load, where closed-loop's self-throttling (a slow reply delays the
    next send) hides queueing collapse.  Since each client thread still
    waits for its own reply, arrivals that fall due while the client is
    blocked are sent back-to-back (coordinated-omission-free up to
    `num_clients` outstanding requests); the report carries the achieved
    rate so saturation is visible as achieved < offered.
    """
    d = engine.config.data
    rng = np.random.RandomState(seed)
    # One pre-built host array per request size: the generator must not pay
    # per-request array construction inside the timed loop.
    inputs = {
        n: rng.rand(n, d.num_views, d.height, d.width, 3).astype(np.float32)
        for n in sorted(set(int(s) for s in request_sizes))
    }

    t_end = time.perf_counter() + warmup_s + duration_s
    t_measure = time.perf_counter() + warmup_s
    # (size, latency_s) per completed request, per client (no shared-list
    # contention inside the loop).
    records: List[List[Tuple[int, float]]] = [[] for _ in range(num_clients)]
    errors: List[str] = []
    sizes = sorted(inputs)

    def client(idx: int) -> None:
        k = idx  # phase offset: clients start on different sizes
        crng = np.random.RandomState(seed * 1009 + idx)
        # Open loop: each of the num_clients threads carries rate/N rps.
        mean_gap = (num_clients / rate_rps) if rate_rps > 0 else 0.0
        next_due = time.perf_counter()
        try:
            while True:
                if rate_rps > 0:
                    next_due += crng.exponential(mean_gap)
                    now = time.perf_counter()
                    if next_due > now:
                        time.sleep(next_due - now)
                now = time.perf_counter()
                if now >= t_end:
                    return
                n = sizes[k % len(sizes)]
                k += 1
                # Open-loop latency is measured from the SCHEDULED send
                # time, so queueing delay behind a late previous reply is
                # charged to this request (no coordinated omission).
                t0 = min(next_due, now) if rate_rps > 0 else now
                engine.predict(inputs[n])
                dt = time.perf_counter() - t0
                if t0 >= t_measure:
                    records[idx].append((n, dt))
        except Exception as e:  # surface, don't hang the join
            errors.append(f"client {idx}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(num_clients)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - max(t_start, t_measure - warmup_s)
    if errors:
        raise RuntimeError("; ".join(errors[:4]))

    flat = [r for recs in records for r in recs]
    report: Dict = {
        "clients": num_clients,
        "duration_s": round(duration_s, 2),
        "request_sizes": sizes,
        "requests": len(flat),
    }
    if rate_rps > 0:
        report["offered_rps"] = round(rate_rps, 2)
    if not flat:
        return report
    measured_wall = min(wall, duration_s) or duration_s
    if rate_rps > 0:
        report["achieved_rps"] = round(len(flat) / measured_wall, 2)
    total_shapes = sum(n for n, _ in flat)
    report["shapes_per_sec"] = round(total_shapes / measured_wall, 2)
    report["views_per_sec"] = round(
        total_shapes * d.num_views / measured_wall, 2)
    all_lat = sorted(dt for _, dt in flat)
    report["p50_ms"] = round(_pct(all_lat, 50) * 1e3, 2)
    report["p99_ms"] = round(_pct(all_lat, 99) * 1e3, 2)
    for n in sizes:
        lat = sorted(dt for sz, dt in flat if sz == n)
        if lat:
            report[f"b{n}_p50_ms"] = round(_pct(lat, 50) * 1e3, 2)
            report[f"b{n}_p99_ms"] = round(_pct(lat, 99) * 1e3, 2)
            report[f"b{n}_requests"] = len(lat)
    return report


def main(argv=None):
    from gvcnn_tf_tpu_torch.configs import add_flags, config_from_flags
    from gvcnn_tf_tpu_torch.serve import InferenceEngine

    p = argparse.ArgumentParser(
        description="closed-loop multi-client serving load generator")
    add_flags(p)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--request_sizes", default="1,8",
                   help="comma-separated request batch sizes to mix")
    p.add_argument("--serve_batch_size", type=int, default=8)
    p.add_argument("--rate", type=float, default=0.0,
                   help="open-loop offered load in requests/sec "
                        "(0 = closed loop)")
    p.add_argument("--no_fold_bn", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine; 'cuda' (default) "
                        "raises when no card is present, it never falls "
                        "back to the CPU")
    args = p.parse_args(argv)
    config = config_from_flags(args)
    sizes = tuple(int(x) for x in args.request_sizes.split(",") if x)
    try:
        engine = InferenceEngine(
            config,
            args.checkpoint_dir or config.train.train_logdir,
            serve_batch_size=args.serve_batch_size,
            fold_bn=not args.no_fold_bn,
            buckets=sorted(set(sizes) | {args.serve_batch_size}),
            device=args.device,
        )
    except (RuntimeError, NotImplementedError, FileNotFoundError,
            ImportError) as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.tools.loadgen: {e}") from e
    try:
        report = run_load(engine, num_clients=args.clients,
                          duration_s=args.duration, request_sizes=sizes,
                          rate_rps=args.rate)
    finally:
        engine.close()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
