"""One run of one cell of the benchmark of `gvcnn_tf_tpu_torch` on the card.

    python3 -m benchmark.run --workload mn40_12view.train_b32 \
        --seed 1234 --seconds 20 --trace 0

Loads the cell's configuration and traffic mix (`harness.py`), makes the
weights and inputs from `--seed` on the card, warms up, measures for
`--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: `--trace 0`
gives the cell's end-to-end metrics, `--trace 1` its per-layer metrics
from a profiled sub-window, with the device's busy seconds and a
breakdown.  The numbers compared and their limits are the line's last key
and the last lines on standard error.  Without a CUDA card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded, it
prints no result and exits non-zero.
"""

import argparse
import json
import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    # Set-up is counted from the process's start.
    t_start = time.perf_counter() - _process_age()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    try:
        result, checks, _ = harness.execute(
            args.workload, args.seed, args.seconds, bool(args.trace),
            t_start=t_start)
    except harness.Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    banned = harness.banned_modules()
    if banned:
        print(f"benchmark: the process holds {', '.join(banned)}",
              file=sys.stderr)
        return 4
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
