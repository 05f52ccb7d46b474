"""Sweep the train step's time across the exact-math variants on one NVIDIA
GPU (counterpart of `gvcnn_tf_tpu/tools/bench_variants.py`).

    python -m gvcnn_tf_tpu_torch.tools.bench_variants --batch 32 \\
        --out docs/PERF_VARIANTS.md
    python -m gvcnn_tf_tpu_torch.tools.bench_variants --device cpu \\
        --batch 2 --iters 2 --variants baseline,wire_uint8

Answers "which exact-math knob moves the step" by timing the port's real
`train.train_step` for each entry of `VARIANTS` (copied from the JAX tool
and pinned to it by `tests/test_torch_variant_tools.py`): the
space-to-depth stem, merged Inception branches, remat, the Pallas grouping
switch, the wire formats and the decoded loader's device flip.  Prints one
JSON line a variant; `--out` appends a markdown table.  The default device
is the card (`--device cuda`; without one it raises); `--device cpu` runs
the config at 64x64, fp32 (as `bench_phases` does off the card), and its
times are the host's.

Views are fed at the variant's wire format, as the loader hands them to
the step: uint8 rows ship raw bytes and `train_step` normalizes them on
the device; `wire_uint8_flip` (`loader="decoded"`) also runs the decoded
loader's on-card flip, `train.flip_mask`, every step.

Time: CUDA events around chunks of 10 steps, the median chunk, after 3 warm
steps (the host clock on the CPU).  FLOPs: `bench_layers.count_work` of one
step (unfused per-op formulas), where the JAX tool reads XLA's
`cost_analysis`.

Same program: the port runs some knobs as the same program, since it has
one layout of the math.  Merged branches (every policy) and the Pallas
grouping switch change nothing (the grouping kernel always runs on a
card), and the space-to-depth stem runs as the stem kernel too.  A row whose
config equals an earlier row's once those fields are reset is marked
`"same_program_as": "<that row>"` and is still timed; the pair's times
differ by noise alone.  Every row prints the loss of its first step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch

from gvcnn_tf_tpu_torch.configs import get_config, resolve_transfer_dtype
from gvcnn_tf_tpu_torch.tools.bench_layers import count_work
from gvcnn_tf_tpu_torch.tools.measure import card_line, cuda_samples
from gvcnn_tf_tpu_torch.train import create_train_state, train_step
from gvcnn_tf_tpu_torch.utils import resolve_device

WARMUP = 3
CHUNK = 10
# The fields whose values the port runs as one program (see the module
# docstring), and the value each is reset to when rows are compared.
SAME_PROGRAM = {"merge_inception_branches": "none",
                "use_pallas_grouping": False, "stem_space_to_depth": False}


def wire_batch(cfg, dev: torch.device, seed: int = 0
               ) -> Dict[str, torch.Tensor]:
    """A fixed batch at the config's wire format: uint8 views in [0, 255]
    for `transfer_dtype="uint8"`, else uniform [0, 1) views in the resolved
    transfer dtype (fp32 where there is none), and labels."""
    d = cfg.data
    rs = np.random.RandomState(seed)
    shape = (d.batch_size, d.num_views, d.height, d.width, 3)
    if d.transfer_dtype == "uint8":
        views = torch.from_numpy(rs.randint(0, 256, shape).astype(np.uint8))
    else:
        wire = getattr(torch, resolve_transfer_dtype(cfg) or "float32")
        views = torch.from_numpy(rs.rand(*shape).astype(np.float32)).to(wire)
    labels = torch.from_numpy(rs.randint(0, d.num_classes, d.batch_size))
    return {"views": views.to(dev), "label": labels.to(dev)}


def step_seconds(step, iters: int, dev: torch.device,
                 chunk: int = CHUNK) -> float:
    """Median seconds a step over max(iters // chunk, 2) chunks of `chunk`
    steps, after WARMUP steps: CUDA events on the card
    (`measure.cuda_samples`), the host clock on the CPU."""
    runs = max(iters // chunk, 2)
    if dev.type == "cuda":
        return statistics.median(cuda_samples(step, runs, warmup=WARMUP,
                                              chunk=chunk)) / 1e3
    for _ in range(WARMUP):
        step()
    samples = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(chunk):
            step()
        samples.append((time.perf_counter() - t0) / chunk)
    return statistics.median(samples)


def time_variant(cfg, batch: int, iters: int = 30,
                 chunk: Optional[int] = None, device="cuda"):
    """-> (median step seconds, counted step FLOPs, first step's loss) of
    `train_step` on a fixed batch of `batch` shapes at the config's wire
    format (`wire_batch`), in chunks of `chunk` steps (default CHUNK)."""
    dev = resolve_device(device)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch))
    state = create_train_state(cfg, dev)
    batch_data = wire_batch(cfg, dev)

    def step():
        return train_step(state, batch_data, cfg)

    first_loss = float(step()["loss"])
    flops = count_work(step).flops
    return step_seconds(step, iters, dev, chunk or CHUNK), flops, first_loss


# (name, config overrides) — all exact-math layout knobs.  Every variant
# pins EVERY knob explicitly (ADVICE r2): the production config default is
# merge_inception_branches="1x1", so an empty-override "baseline" would
# already run merged and each row's speedup would conflate the merge knob
# into whatever its name claims to measure.
_PINNED = {"stem_space_to_depth": False, "merge_inception_branches": "none",
           "remat_backbone": False, "use_pallas_grouping": False,
           "remat_until": "",
           # float32 feed pinned for every legacy variant: r2/r3 rows were
           # measured with an f32 feed, and within-sweep deltas must not
           # conflate a layout knob with the wire format (wire_* rows
           # override this deliberately).
           "transfer_dtype": "float32"}


def _v(**overrides):
    return {**_PINNED, **overrides}


VARIANTS = [
    ("baseline", _v()),
    ("s2d_stem", _v(stem_space_to_depth=True)),
    ("merge_1x1", _v(merge_inception_branches="1x1")),
    ("merge_full", _v(merge_inception_branches="full")),
    ("s2d+merge_1x1", _v(stem_space_to_depth=True,
                         merge_inception_branches="1x1")),
    ("s2d+merge_full", _v(stem_space_to_depth=True,
                          merge_inception_branches="full")),
    ("remat", _v(remat_backbone=True)),
    ("pallas_grouping", _v(use_pallas_grouping=True)),
    # Round-4 levers (VERDICT r3 Next #1/#4) — measured ON TOP of the
    # production merge_1x1 so deltas read against the shipping step:
    # selective remat of only the large-spatial prefix (stem/2c saved
    # activations are the biggest backward-pass HBM tenants)...
    ("remat_until_2a", _v(merge_inception_branches="1x1",
                          remat_until="MaxPool_2a_3x3")),
    ("remat_until_2c", _v(merge_inception_branches="1x1",
                          remat_until="Conv2d_2c_3x3")),
    ("remat_until_3a", _v(merge_inception_branches="1x1",
                          remat_until="MaxPool_3a_3x3")),
    ("remat_until_3c", _v(merge_inception_branches="1x1",
                          remat_until="Mixed_3c")),
    # ...and the block-diagonal 3x3 merge at ONLY the 28x28 blocks, whose
    # 16/32-channel Branch_2 reduces tile the MXU contracting axis worst.
    ("merge_28x28_full", _v(
        merge_inception_branches="1x1,Mixed_3b=full,Mixed_3c=full")),
    ("merge_3c_full", _v(merge_inception_branches="1x1,Mixed_3c=full")),
    # Round-5: wire-format A/B (VERDICT r4 Next #4) on the PRODUCTION
    # layout (merge_1x1) — same device math, only the host->device bytes
    # and the in-step input conversion differ.  uint8 ships 1/4 of
    # float32's bytes and runs utils.normalize_views inside the step;
    # the question this answers is whether that normalize fuses into the
    # stem (uint8 step time == bf16 step time) or materializes a float
    # copy (uint8 slower by a ~58 MB HBM round trip, ~0.07 ms at 819 GB/s).
    ("wire_f32", _v(merge_inception_branches="1x1",
                    transfer_dtype="float32")),
    ("wire_bf16", _v(merge_inception_branches="1x1",
                     transfer_dtype="bfloat16")),
    ("wire_uint8", _v(merge_inception_branches="1x1",
                      transfer_dtype="uint8")),
    # uint8 wire + the decoded loader's DEVICE-SIDE random flip (configs
    # device_flip): same bytes as wire_uint8 plus a lax reverse + select
    # in the step.  Expected fused (step time == wire_uint8); a gap is
    # the flip materializing a views-sized copy.
    ("wire_uint8_flip", _v(merge_inception_branches="1x1",
                           transfer_dtype="uint8", loader="decoded")),
]


def variant_config(base, overrides):
    """Apply a VARIANTS override dict: top-level model knobs go through
    config.replace; `transfer_dtype`/`loader` route to the DataConfig."""
    overrides = dict(overrides)
    data_kw = {k: overrides.pop(k) for k in ("transfer_dtype", "loader")
               if overrides.get(k) is not None}
    cfg = base.replace(**overrides)
    if data_kw:
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, **data_kw)
        )
    return cfg


def same_program(cfg):
    """The config with the `SAME_PROGRAM` fields reset."""
    return cfg.replace(**SAME_PROGRAM)


def base_config(config: str, dev: torch.device):
    """The named config; on the CPU at 64x64 in fp32."""
    cfg = get_config(config)
    if dev.type == "cpu":
        cfg = cfg.replace(compute_dtype="float32", data=dataclasses.replace(
            cfg.data, height=64, width=64))
    return cfg


def run(base, batch: int = 32, iters: int = 30, variants=None,
        out: Optional[str] = None, device="cuda"):
    """-> rows (see the module docstring); prints a JSON line each."""
    dev = resolve_device(device)
    want = set(variants) if variants else None
    if want:
        unknown = want - {name for name, _ in VARIANTS}
        if unknown:
            raise ValueError(f"unknown variants {sorted(unknown)}")
    rows, programs = [], {}
    base_dt = None
    for name, overrides in VARIANTS:
        cfg = variant_config(base, overrides)
        key = same_program(cfg)
        first = programs.setdefault(key, name)
        if want and name not in want:
            continue
        dt, flops, loss = time_variant(cfg, batch, iters=iters, device=dev)
        if base_dt is None and name == "baseline":
            base_dt = dt
        row = {
            "variant": name,
            "step_ms": round(dt * 1e3, 2),
            "views_per_sec": round(batch * base.data.num_views / dt, 1),
            "step_gflops": round(flops / 1e9, 1),
            "speedup_vs_baseline": (
                round(base_dt / dt, 4) if base_dt else None),
            "first_loss": loss,
        }
        if first != name:
            row["same_program_as"] = first
        rows.append(row)
        print(json.dumps(row), flush=True)

    if out and rows:
        where = card_line() if dev.type == "cuda" else "cpu, host clock"
        lines = [
            f"# Train-step variants: {base.name} (batch {batch}, {where})",
            "",
            "| variant | step ms | views/s | step GFLOP | speedup | "
            "same program as | first loss |",
            "|---|---|---|---|---|---|---|",
        ]
        for r in rows:
            lines.append(
                f"| {r['variant']} | {r['step_ms']} | "
                f"{r['views_per_sec']} | {r['step_gflops']} | "
                f"{r['speedup_vs_baseline']} | "
                f"{r.get('same_program_as', '')} | {r['first_loss']:.6g} |")
        with open(out, "a") as f:
            f.write("\n".join(lines) + "\n\n")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="mn40_12view")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--variants", default=None,
                   help="comma-separated subset of variant names")
    p.add_argument("--out", default=None, help="append markdown table here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    return run(base_config(args.config, dev), args.batch, args.iters,
               args.variants.split(",") if args.variants else None,
               args.out, dev)


if __name__ == "__main__":
    main()
