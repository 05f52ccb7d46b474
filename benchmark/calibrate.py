"""The readings the output check's limits are set from (the builder's
tool, not run by the benchmark's own runs).

    python3 -m benchmark.calibrate --workload mn40_12view.train_b32 \
        --seeds 11,12,13 --control-seeds 21,22,23 \
        --faults half_loss,stale_half --fault-seeds 31,32,33 --seconds 2

For each of `--seeds`, one run of the cell as `run.py` makes it (a short
window; its compared numbers are the lower reading's); for each of
`--control-seeds`, the traffic driver's `controls`: the reference put in
the program's place in float8 (the control: the upper reading), in
bfloat16 (a witness of what rounding at the configuration's precision
alone reads); for each of `--faults` (`benchmark/faults.py`) and each of
`--fault-seeds`, one run of the cell with that fault planted in the
program.  One JSON line a reading, all in one process."""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import time

import torch

from benchmark import faults, harness


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    harness.check_card(1)
    runs = [("program", int(s)) for s in args.seeds.split(",") if s]
    runs += [(f, int(s)) for f in args.faults.split(",") if f
             for s in args.fault_seeds.split(",") if s]
    for what, seed in runs:
        t = time.perf_counter()
        with (faults.FAULTS[what]() if what != "program"
              else contextlib.nullcontext()):
            result, _, numbers = harness.execute(
                args.workload, seed, args.seconds, False, t_start=t)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "what": what, "checks": numbers,
                          "correct": result["correct"],
                          "metrics": {k: m["value"] for k, m in
                                      result["metrics"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.reset_peak_memory_stats()     # the next seed's own peak
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"]
                if w["name"] == args.workload)
    config = harness.load_json(harness.HERE / "configs"
                               / f"{cell['config']}.json")
    traffic = harness.load_json(harness.HERE / "traffic"
                                / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"benchmark.traffic.{traffic['kind']}")
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        t = time.perf_counter()
        ctx = harness.Context(cell=cell, config=config, traffic=traffic,
                              seed=seed, seconds=args.seconds, trace=False,
                              device=torch.device("cuda", 0), t_start=t)
        for what, checks in driver.controls(ctx).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "what": what, "checks": checks,
                              "seconds": time.perf_counter() - t}),
                  flush=True)


if __name__ == "__main__":
    main()
