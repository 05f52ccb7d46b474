"""Tiny sizes at which the tests drive whole runs on the CPU: 2 views of
64x64, float32 compute (so that the program and the reference agree to
rounding), a few shapes."""

import time

from benchmark import harness

MODEL = {"num_views": 2, "height": 64, "width": 64, "compute_dtype": "float32"}
SHRINK = {
    "train_stream": {"model": MODEL, "traffic": {
        "batch_size": 4, "pool_batches": 3,
        "trace": {"skip_steps": 1, "steps": 1}}},
    "eval_pass": {"model": MODEL, "traffic": {
        "batch_size": 2, "pass_shapes": 5, "pool_shapes": 4,
        "checked_passes": 2, "trace": {"pass": 0}}},
}
CELLS = {"mn40_12view.train_b32": "train_stream",
         "mn40_12view_resnet50.train_b32": "train_stream",
         "mn40_12view.eval_b32": "eval_pass"}


def run(cell, seed=123456789012, seconds=1.0, trace=False, root=None):
    """One run of `cell` on the CPU at the tiny size: (result, checks,
    every number)."""
    kw = {} if root is None else {"root": root}
    return harness.execute(cell, seed, seconds, trace,
                           t_start=time.perf_counter(), device="cpu",
                           shrink=SHRINK[CELLS[cell]], **kw)


def context(cell, seed=5):
    """The `harness.Context` of `cell` at the tiny size."""
    import torch

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    w = next(x for x in bench["workloads"]
             if x["name"] == cell)
    return harness.Context(
        cell=w, config=harness.load_json(
            harness.HERE / "configs" / f"{w['config']}.json"),
        traffic=harness.load_json(
            harness.HERE / "traffic" / f"{w['traffic']}.json"),
        seed=seed, seconds=1.0, trace=False, device=torch.device("cpu"),
        t_start=time.perf_counter(), shrink=SHRINK[CELLS[cell]])
