"""Tiny sizes at which the tests drive whole runs on the CPU: 2 views of
max(64, the backbone's MIN_SIZE) squared, float32 compute (so that the
program and the reference agree to rounding), a few shapes.  The cells
are those of `BENCHMARK.json`, each driven by its traffic file's kind."""

import time

from benchmark import harness
from benchmark.reference import gvcnn

MODEL = {"num_views": 2, "height": 64, "width": 64, "compute_dtype": "float32"}
SHRINK = {
    "train_stream": {"model": MODEL, "traffic": {
        "batch_size": 4, "pool_batches": 3,
        "trace": {"skip_steps": 1, "steps": 1}}},
    "eval_pass": {"model": MODEL, "traffic": {
        "batch_size": 2, "pass_shapes": 5, "pool_shapes": 4,
        "checked_passes": 2, "trace": {"pass": 0}}},
}


def _bench():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def _config(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def size(model: dict) -> int:
    """The tiny square size of a configuration's `model` section."""
    return max(64, gvcnn.backbone(model["backbone"]).MIN_SIZE)


# {cell: its traffic file's kind}
CELLS = {w["name"]: harness.load_json(
    harness.HERE / "traffic" / f"{w['traffic']}.json")["kind"]
    for w in _bench()["workloads"]}


def shrink(cell):
    """The tiny overrides of `cell`: its kind's, at its backbone's size."""
    w = next(x for x in _bench()["workloads"] if x["name"] == cell)
    base = SHRINK[CELLS[cell]]
    side = size(_config(w["config"])["model"])
    return dict(base, model=dict(base["model"], height=side, width=side))


def run(cell, seed=123456789012, seconds=1.0, trace=False):
    """One run of `cell` on the CPU at the tiny size: (result, checks,
    every number)."""
    return harness.execute(cell, seed, seconds, trace,
                           t_start=time.perf_counter(), device="cpu",
                           shrink=shrink(cell))


def context(cell, seed=5):
    """The `harness.Context` of `cell` at the tiny size."""
    import torch

    w = next(x for x in _bench()["workloads"] if x["name"] == cell)
    return harness.Context(
        cell=w, config=_config(w["config"]),
        traffic=harness.load_json(
            harness.HERE / "traffic" / f"{w['traffic']}.json"),
        seed=seed, seconds=1.0, trace=False, device=torch.device("cpu"),
        t_start=time.perf_counter(), shrink=shrink(cell))
