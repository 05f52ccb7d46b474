"""Audit of the data-parallel train step's collectives, weighed in an
NVLink scaling model (counterpart of
`gvcnn_tf_tpu/tools/analyze_collectives.py`).

One card cannot measure data parallelism across cards, but what the step
sends is a fact of the program: every collective of the port goes through
`parallel/collectives.py`, whose `CollectiveRecorder` logs each call's op,
reduce op, dtype, element count, bytes and group.  This tool runs one
`train_step` of mn40_12view on `--devices` gloo ranks on the CPU, in the
chosen `--bn_sync` mode, records what each rank sends, and combines the
bytes with a step time in a ring all-reduce model:

    t_comm(n) = 2 (n-1)/n * bytes / bw + n_ops * 2 (n-1) * hop latency
    efficiency(n) = t_step / (t_step + t_comm(n) * (1 - overlap))

Parameter and gradient bytes depend on neither the image size nor the
batch, and BatchNorm's statistics only on the channels, so the ranks run
at tiny shapes (64x64, 4 views, one shape a rank; fp32, which sends the
same bytes as bf16 compute: parameters, gradients and statistics are fp32
either way), the JAX tool's own argument for compiling over virtual CPU
devices.  `--full-shapes` runs the flagship's (32 shapes of 12 views at
224x224 over the ranks) instead.

Expected: in `bn_sync="local"` one device all-reduce a step, one flat
buffer of the gradients, loss, accuracy and every BatchNorm's running
statistics; in `"global"` that buffer without the statistics, plus one
all-reduce of each train-mode BatchNorm's per-channel sums in the forward
and one in its backward.  The JAX package's program sends the same bytes
(less the count element each of these carries) in fewer ops, 62 at the
tiny shapes: XLA's all-reduce combiner merges independent reductions, such
as an Inception block's parallel branches, which this eager step launches
one by one.  The train loop's host-group calls (`agree_max`
once a step; `barrier` at the loop's start and end) are reported apart
(`loop_host_ops`).

The model: bandwidth over NVLink 4 on the H100 SXM, 450 GB/s each way
(NVIDIA's data sheet: 900 GB/s total), one direction of a ring; hops
2 (n-1), a reduce-scatter and an all-gather around a ring in one NVSwitch
domain (no torus); the hop latency `--hop_us` is an assumption, not a
measurement.  n runs over 2, 4 and 8, the cards of one HGX node; nothing
past 8 is modelled.  The step time weighed against it comes from
`--step-ms`, or is measured on the card: `bench_phases`'s `full` at
`--batch` shapes (`--device cuda`, the default; without a card it raises).

    python -m gvcnn_tf_tpu_torch.tools.analyze_collectives --devices 8
    python -m gvcnn_tf_tpu_torch.tools.analyze_collectives --devices 2 \\
        --bn_sync local --step-ms 40
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gvcnn_tf_tpu_torch.configs import get_config
from gvcnn_tf_tpu_torch.models.backbones.layers import BatchNorm
from gvcnn_tf_tpu_torch.parallel import (
    initialize_distributed,
    rank_rows,
    shutdown,
    spawn,
)
from gvcnn_tf_tpu_torch.parallel import collectives
from gvcnn_tf_tpu_torch.train import bn_statistics, create_train_state
from gvcnn_tf_tpu_torch.train import train_step

# NVLink 4 on the H100 SXM: 900 GB/s to the other cards, 450 GB/s each way
# (NVIDIA's data sheet); the ring model uses one direction.
NVLINK_GBPS = 450.0
# Per-hop latency assumed for the per-op term (not measured).
HOP_US = 1.0
# The cards of one HGX node, all in one NVSwitch domain.
MODEL_DEVICES = (2, 4, 8)
RANK_TIMEOUT = datetime.timedelta(seconds=120)


def audit_config(n_devices: int, bn_sync: str, full_shapes: bool = False):
    """mn40_12view in `bn_sync` mode, fp32, at the audit's shapes: the
    flagship's 32 shapes of 12 views at 224x224 over the ranks with
    `full_shapes`, else 64x64, 4 views, one shape a rank."""
    cfg = get_config("mn40_12view").replace(bn_sync=bn_sync,
                                            compute_dtype="float32")
    if full_shapes:
        return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=32))
    return cfg.replace(data=dataclasses.replace(
        cfg.data, height=64, width=64, num_views=4, batch_size=n_devices))


def _audit_rank(init_method, out_dir, cfgs: Dict[str, object]):
    """One rank: a train_step in each mode under a recorder, then the
    loop's host-group calls under another; rank r writes
    `out_dir/rank{r}.pt`."""
    world = initialize_distributed(timeout=RANK_TIMEOUT, device="cpu",
                                   init_method=init_method)
    try:
        result = {}
        for mode, cfg in cfgs.items():
            d = cfg.data
            rs = np.random.RandomState(0)
            batch = rank_rows({
                "views": rs.rand(d.batch_size, d.num_views, d.height,
                                 d.width, 3).astype(np.float32),
                "label": rs.randint(0, d.num_classes, d.batch_size)},
                world)
            state = create_train_state(cfg, world=world)
            calls = []
            hooks = [m.register_forward_hook(
                lambda m, a, o: calls.append(m.training))
                for m in state.model.modules() if isinstance(m, BatchNorm)]
            with collectives.CollectiveRecorder() as step:
                train_step(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, cfg)
            for h in hooks:
                h.remove()
            with collectives.CollectiveRecorder() as loop:
                collectives.barrier(world)
                collectives.agree_max(0, world)
            params = [p for p in state.model.parameters()]
            result[mode] = dict(
                step=step.ops, loop=loop.ops,
                train_bn_calls=sum(calls),
                param_bytes=sum(p.numel() * p.element_size()
                                for p in params),
                param_dtypes=sorted({str(p.dtype) for p in params}),
                bn_stat_bytes=sum(t.numel() * t.element_size()
                                  for t in bn_statistics(state.model)))
        torch.save(result, os.path.join(out_dir, f"rank{world.rank}.pt"))
    finally:
        shutdown(world)


def audit(n_devices: int, modes: Sequence[str] = ("global",),
          full_shapes: bool = False, timeout: float = 600.0) -> dict:
    """{mode: what rank 0 recorded} over `n_devices` gloo ranks (one spawn
    for every mode); raises if the ranks recorded different calls."""
    cfgs = {m: audit_config(n_devices, m, full_shapes) for m in modes}
    with tempfile.TemporaryDirectory(prefix="gvcnn_collectives_") as out:
        spawn(_audit_rank, n_devices, args=(out, cfgs), timeout=timeout)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"))
                 for r in range(n_devices)]
    for r, got in enumerate(ranks[1:], 1):
        for m in modes:
            if got[m]["step"] != ranks[0][m]["step"]:
                raise AssertionError(f"rank {r} made other collectives than "
                                     f"rank 0 in {m} mode")
    return ranks[0]


def scaling_model(total_bytes: int, step_ms: float,
                  overlap_frac: float = 0.0, n_ops: int = 1,
                  hop_us: float = HOP_US, gbps: float = NVLINK_GBPS):
    """Ring all-reduce over NVLink in one NVSwitch domain -> efficiency
    table for n in MODEL_DEVICES.

    - bandwidth: 2 (n-1)/n * bytes / bw, one direction of a ring;
    - per-op latency: every all-reduce, however small, pays its ring's
      hops, 2 (n-1) (a reduce-scatter and an all-gather), at `hop_us` a
      hop (an assumption): the cost of the small BatchNorm all-reduces of
      `bn_sync="global"` riding beside the gradient buffer."""
    rows = []
    for n in MODEL_DEVICES:
        t_bw_ms = 2 * (n - 1) / n * total_bytes / (gbps * 1e9) * 1e3
        t_lat_ms = n_ops * 2 * (n - 1) * hop_us / 1e3
        exposed = (t_bw_ms + t_lat_ms) * (1 - overlap_frac)
        rows.append({
            "devices": n,
            "allreduce_ms": round(t_bw_ms, 4),
            "latency_ms": round(t_lat_ms, 4),
            "dp_efficiency": round(step_ms / (step_ms + exposed), 4),
        })
    return rows


def report(recorded: dict, devices: int, bn_sync: str, step_ms: float,
           overlap: float = 0.0, hop_us: float = HOP_US,
           gbps: float = NVLINK_GBPS,
           step_source: Optional[str] = None) -> dict:
    """The JAX tool's output keys from one mode's record (NVLink terms in
    place of ICI ones), plus the loop's host-group calls."""
    ops = [o for o in recorded["step"] if o["group"] == "device"]
    total = sum(o["bytes"] for o in ops if o["op"] == "all_reduce")
    n_ar = sum(1 for o in ops if o["op"] == "all_reduce")
    return {
        "devices": devices,
        "bn_sync": bn_sync,
        "collective_ops": len(ops),
        "op_kinds": sorted({o["op"] for o in ops}),
        "allreduce_bytes_total": total,
        "allreduce_mbytes": round(total / 1e6, 2),
        "top_ops": sorted(ops, key=lambda o: -o["bytes"])[:10],
        "step_ms_measured": step_ms,
        "nvlink_gbps_assumed": gbps,
        "scaling_model_worst_case": scaling_model(
            total, step_ms, overlap, n_ops=n_ar, hop_us=hop_us, gbps=gbps),
        "note": "bytes are recorded at each all-reduce the step makes "
                "through parallel/collectives.py, on gloo ranks on the CPU; "
                "efficiency is a ring model over one NVLink direction "
                f"({gbps:g} GB/s) with the all-reduces fully exposed "
                f"(overlap {overlap}), a MODEL, not a measurement; "
                f"latency_ms charges each of the {n_ar} all-reduces 2(n-1) "
                f"hops at an assumed {hop_us:g} us; one NVSwitch domain of "
                "up to 8 cards, nothing past 8 modelled",
        "step_ms_source": step_source,
        "hop_us_assumed": hop_us,
        "step_host_ops": [o for o in recorded["step"]
                          if o["group"] == "host"],
        "loop_host_ops": recorded["loop"],
        "train_bn_calls": recorded["train_bn_calls"],
        "param_bytes": recorded["param_bytes"],
        "bn_stat_bytes": recorded["bn_stat_bytes"],
    }


def measure_step_ms(batch: int, device="cuda") -> float:
    """`bench_phases`'s `full` (the train step) at `batch` shapes on the
    card; a CPU time is no card's, so the CPU raises."""
    from gvcnn_tf_tpu_torch.tools import bench_phases
    from gvcnn_tf_tpu_torch.utils import resolve_device

    if resolve_device(device).type != "cuda":
        raise ValueError("--step-ms is needed off the card: the model weighs "
                         "the card's step time, not the CPU's")
    return bench_phases.run("mn40_12view", batch, device=device)["full_ms"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--step-ms", type=float, default=None,
                   help="the step time to weigh against (ms); default: "
                        "measured on the card by bench_phases' full")
    p.add_argument("--batch", type=int, default=32,
                   help="shapes of the step measured without --step-ms")
    p.add_argument("--device", default="cuda",
                   help="where the step is measured without --step-ms")
    p.add_argument("--overlap", type=float, default=0.0,
                   help="fraction of all-reduce hidden behind compute "
                        "(0 = fully exposed, worst case)")
    p.add_argument("--full-shapes", action="store_true",
                   help="run the flagship's shapes (32 shapes x 12 views, "
                        "224^2, over the ranks) instead of the tiny "
                        "byte-equivalent ones")
    p.add_argument("--bn_sync", default="global",
                   choices=["global", "local"])
    p.add_argument("--hop_us", type=float, default=HOP_US,
                   help="assumed per-hop latency (us)")
    args = p.parse_args(argv)
    if args.devices < 2:
        raise SystemExit("--devices: at least 2 ranks; one rank makes no "
                         "collective and would model a vacuous 100%")
    step_ms, source = args.step_ms, "--step-ms"
    if step_ms is None:
        step_ms = measure_step_ms(args.batch, args.device)
        source = f"bench_phases full, B={args.batch}, {args.device}"
    recorded = audit(args.devices, (args.bn_sync,), args.full_shapes)
    out = report(recorded[args.bn_sync], args.devices, args.bn_sync,
                 step_ms, args.overlap, args.hop_us, step_source=source)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
