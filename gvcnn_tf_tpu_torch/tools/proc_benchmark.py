"""GVCNN vs MVCNN on the procedural multi-view benchmark, an accuracy run
(counterpart of `gvcnn_tf_tpu/tools/proc_benchmark.py`).

Trains both model families on renders of parametric 3D shapes
(`data/procedural.py`), where some views are deliberately uninformative,
and reports top-1 and retrieval mAP for each.  GVCNN's grouping module
should match or beat the MVCNN max-pool baseline, as the paper's ModelNet40
comparison has it.  The configs, flags, JSON keys and mean +- std
aggregation are the JAX tool's; the port's `train` -> `evaluate` ->
`extract_descriptors` / `retrieval_metrics` run them, on `--device`.

`--out PATH` appends a markdown table to PATH and `--jsonl PATH` appends
every result line (each run, then each model's aggregate) as JSON, each
headed by the device (the card's name and power limit as nvidia-smi gives
them, or "cpu").  Nothing else is written outside the runs' train_logdirs,
which lie under the temp directory (`tempfile.gettempdir()`).

CLI (on the card by default):

    python -m gvcnn_tf_tpu_torch.tools.proc_benchmark --height 64 \
        --num_views 8 --train_shapes 80 --eval_shapes 100 --steps 600 \
        --hard --seeds 0,1,2,3,4 --jsonl docs/proc_study_h100.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from gvcnn_tf_tpu_torch import metrics as metrics_lib
from gvcnn_tf_tpu_torch.configs import GVCNNConfig, get_config


def _config(model: str, a, seed: int = 0) -> GVCNNConfig:
    cfg = get_config("mn40_12view")
    return cfg.replace(
        model=model,
        name=f"proc_{model}",
        bn_momentum=0.9,               # short run: slim's 0.9997 never warms up
        data=dataclasses.replace(
            cfg.data,
            dataset="procedural_hard" if a.hard else "procedural",
            num_classes=a.num_classes,
            num_views=a.num_views,
            height=a.height,
            width=a.width,
            batch_size=a.batch,
            synthetic_num_shapes=a.train_shapes,
            async_prefetch="off",
            # Raw uint8 renders on the wire, normalized on the device.
            transfer_dtype="uint8",
        ),
        train=dataclasses.replace(
            cfg.train,
            num_steps=a.steps,
            log_every=max(a.steps // 10, 1),
            checkpoint_every=0,
            train_logdir=os.path.join(tempfile.gettempdir(), "gvcnn_proc",
                                      f"{model}_s{seed}"),
            optimizer="adam",
            learning_rate=a.learning_rate,
            lr_decay_steps=max(a.steps // 3, 1),
            # Seeds both the parameter init and the procedural data draw,
            # so a multi-seed sweep varies both together.
            seed=seed,
        ),
    )


def run_one(model: str, a, seed: int = 0) -> dict:
    from gvcnn_tf_tpu_torch.eval import evaluate
    from gvcnn_tf_tpu_torch.tools.retrieval import (
        extract_descriptors,
        retrieval_metrics,
    )
    from gvcnn_tf_tpu_torch.train import train

    cfg = _config(model, a, seed)
    t0 = time.perf_counter()
    state, mets = train(cfg, device=a.device)
    train_s = time.perf_counter() - t0

    eval_cfg = cfg.replace(
        data=dataclasses.replace(
            cfg.data, synthetic_num_shapes=a.eval_shapes
        )
    )
    result = evaluate(eval_cfg, state=state)
    descs, labels = extract_descriptors(eval_cfg, state=state)
    retr = retrieval_metrics(descs, labels)
    out = {
        "model": model,
        "seed": seed,
        "top1": round(result["accuracy"], 4),
        "count": result["count"],
        "retrieval_mAP": round(retr["mAP"], 4),
        "precision@5": round(retr["precision@5"], 4),
        "final_train_acc": round(float(mets.get("accuracy", 0.0)), 4),
        "train_seconds": round(train_s, 1),
        "steps": a.steps,
    }
    print(json.dumps(out), flush=True)
    return out


def device_kind(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, for a CUDA
    device; else the device's type."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    from gvcnn_tf_tpu_torch.tools.measure import card_line

    return card_line()


def _parser():
    p = argparse.ArgumentParser(description="GVCNN vs MVCNN accuracy run")
    p.add_argument("--num_views", type=int, default=8)
    p.add_argument("--num_classes", type=int, default=10,
                   help="10 (ModelNet10-like set) or 40 (the full class "
                        "table)")
    p.add_argument("--height", type=int, default=112)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--train_shapes", type=int, default=600)
    p.add_argument("--eval_shapes", type=int, default=200)
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--hard", action="store_true",
                   help="hard variant: half the views near-overhead "
                        "(85 deg), the regime where grouping must beat "
                        "uniform max-pooling")
    p.add_argument("--models", default="gvcnn,mvcnn")
    p.add_argument("--seeds", default="0",
                   help="comma-separated train/data seeds; >1 seed "
                        "reports mean+-std per model")
    p.add_argument("--out", default=None, help="append a markdown table")
    p.add_argument("--jsonl", default=None,
                   help="append the result lines as JSON")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises when no card "
                        "is present, it never falls back to the CPU")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.width is None:
        args.width = args.height
    from gvcnn_tf_tpu_torch.utils import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.tools.proc_benchmark: {e}") \
            from e
    kind = device_kind(args.device)

    seeds = [int(x) for x in args.seeds.split(",") if x != ""]
    models = [m.strip() for m in args.models.split(",") if m]
    results = [run_one(m, args, s) for m in models for s in seeds]

    def _agg(model, key):
        vals = [r[key] for r in results if r["model"] == model]
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / max(len(vals) - 1, 1)
        return mean, var ** 0.5

    aggregates = []
    if len(seeds) > 1:
        for m in models:
            line = {"model": m, "seeds": seeds}
            for key in ("top1", "retrieval_mAP", "precision@5"):
                mean, std = _agg(m, key)
                line[key] = f"{mean:.4f}+-{std:.4f}"
            aggregates.append(line)
            print(json.dumps(line), flush=True)

    if args.jsonl:
        head = {"device": kind, "hard": args.hard,
                "num_views": args.num_views, "height": args.height,
                "width": args.width, "num_classes": args.num_classes,
                "batch": args.batch, "train_shapes": args.train_shapes,
                "eval_shapes": args.eval_shapes, "steps": args.steps,
                "learning_rate": args.learning_rate}
        with open(args.jsonl, "a") as f:
            for line in [head] + results + aggregates:
                f.write(json.dumps(line) + "\n")
        metrics_lib.log(f"appended results to {args.jsonl}")

    if args.out:
        lines = [
            "",
            f"## Procedural benchmark{' (HARD)' if args.hard else ''} "
            f"({args.num_views} views, "
            f"{args.height}x{args.width}, {args.train_shapes} train / "
            f"{args.eval_shapes} eval shapes, {args.steps} steps, "
            f"seeds {seeds}, {kind})",
            "",
            "| model | seed | top-1 | retrieval mAP | p@5 | train acc | train s |",
            "|---|---|---|---|---|---|---|",
        ]
        for r in results:
            lines.append(
                f"| {r['model']} | {r['seed']} | {r['top1']} | "
                f"{r['retrieval_mAP']} | "
                f"{r['precision@5']} | {r['final_train_acc']} | "
                f"{r['train_seconds']} |"
            )
        if len(seeds) > 1:
            lines += ["", "| model | top-1 (mean+-std) | mAP (mean+-std) | p@5 (mean+-std) |",
                      "|---|---|---|---|"]
            for m in models:
                t, tm = _agg(m, "top1")
                r_, rm = _agg(m, "retrieval_mAP")
                p5, pm = _agg(m, "precision@5")
                lines.append(
                    f"| {m} | {t:.3f} +- {tm:.3f} | {r_:.3f} +- {rm:.3f} | "
                    f"{p5:.3f} +- {pm:.3f} |")
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
        metrics_lib.log(f"appended results to {args.out}")


if __name__ == "__main__":
    main()
