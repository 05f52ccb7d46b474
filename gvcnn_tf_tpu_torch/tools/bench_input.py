"""Input-pipeline throughput benchmark, host side (counterpart of
`gvcnn_tf_tpu/tools/bench_input.py`): what the configured loader sustains
through the port's `make_dataset`, so a train step's throughput gap can be
put on the host or the device.

    python -m gvcnn_tf_tpu_torch.tools.bench_input --config mn40_12view \
        --loader tfrecord --dataset_dir /data/tfr [--num_batches 50]

Prints one JSON line with the JAX tool's fields: batches/s, shapes/s,
views/s at the config's batch geometry.
"""

from __future__ import annotations

import argparse
import json
import time

from gvcnn_tf_tpu_torch.configs import add_flags, config_from_flags
from gvcnn_tf_tpu_torch.data import make_dataset


def bench_input(config, num_batches: int = 50, warmup: int = 3) -> dict:
    d = config.data
    it = make_dataset(d, train=True, seed=0)
    for _ in range(warmup):
        next(it)
    t0 = time.perf_counter()
    n = 0
    for _ in range(num_batches):
        batch = next(it, None)
        if batch is None:
            break
        n += 1
    dt = time.perf_counter() - t0
    rate = n / dt if dt > 0 else float("inf")
    return {
        "loader": d.loader,
        "transfer_dtype": d.transfer_dtype,
        "batches_per_sec": round(rate, 3),
        "shapes_per_sec": round(rate * d.batch_size, 2),
        "views_per_sec": round(rate * d.batch_size * d.num_views, 1),
        "batch_geometry": [d.batch_size, d.num_views, d.height, d.width, 3],
        "measured_batches": n,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="input pipeline throughput")
    add_flags(p)
    p.add_argument("--num_batches", type=int, default=50)
    args = p.parse_args(argv)
    try:
        report = bench_input(config_from_flags(args), args.num_batches)
    except (RuntimeError, NotImplementedError, FileNotFoundError,
            ValueError) as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.tools.bench_input: {e}") from e
    print(json.dumps(report))


if __name__ == "__main__":
    main()
