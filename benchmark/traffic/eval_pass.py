"""Kind `eval_pass`: the program's `eval.evaluate` over passes of a split,
back to back, as the batch scorer and the trainer's periodic eval run it
(every batch padded to `batch_size` and masked; the forward a CUDA graph).

Mix keys: batch_size, pass_shapes (shapes a pass: the split's size),
pool_shapes (a seeded host pool the passes read in order; a multiple of
batch_size, so a batch is a slice of it), checked_passes (the pass
compared is the seed's remainder by it: one of the first passes, so that
it lies in the window), trace {pass} (which pass of a `--trace 1` run is
profiled, whole; not the one compared).

Set-up runs one short pass (two full batches) so that the graph of the
padded shape is captured.  The window runs whole passes until `--seconds`
have passed; the pass that crosses the end is finished and counted.
The compared pass's logits are recorded (`eval.recorded_logits`, which
copies each batch's to the host and so waits on the device at every
batch; the other passes run as the program pipelines them) and compared,
row by row, padding rows included, with the reference's eval-mode float32
forward of the same views (`logit_checks`); every pass's count is
compared."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import compare, program
from benchmark.inputs import host_views, labels as make_labels
from benchmark.reference import gvcnn as ref_gvcnn, layers
from benchmark.tracing import ProfiledWindow


def batches(views, labels, batch: int, shapes: int):
    """One pass of `shapes` shapes read in order from the pool, in batches
    of `batch` (the last one short)."""
    n = len(views)
    for lo in range(0, shapes, batch):
        i = lo % n
        k = min(batch, shapes - lo)
        yield {"views": views[i:i + k], "label": labels[i:i + k]}


def pass_rows(n_pool: int, batch: int, shapes: int):
    """The pool index of every row of a pass's padded batches (-1: a
    padding row)."""
    rows = []
    for lo in range(0, shapes, batch):
        k = min(batch, shapes - lo)
        rows += [(lo + j) % n_pool for j in range(k)] + [-1] * (batch - k)
    return np.asarray(rows)


def inputs(ctx):
    """(weights on the device, the pool's views (pool_shapes, V, H, W, 3)
    uint8 and labels on the host)."""
    mix, m = ctx.mix, ctx.model
    n, b = mix["pool_shapes"], mix["batch_size"]
    views = host_views(ctx.seed, "eval_views", (n, m["num_views"],
                       m["height"], m["width"], 3), max(n // b, 1),
                       ctx.device)
    labels = make_labels(ctx.seed, "eval_labels", n, m["num_classes"])
    return program.weights(ctx), views, labels


def run(ctx) -> dict:
    from gvcnn_tf_tpu_torch.eval import evaluate, recorded_logits

    mix, m, dev = ctx.mix, ctx.model, ctx.device
    b, shapes, n_pool = (mix["batch_size"], mix["pass_shapes"],
                         mix["pool_shapes"])
    if n_pool % b:
        raise ValueError("pool_shapes must be a multiple of batch_size")
    cfg = ctx.port_config(batch_size=b)
    w0, views, labels = inputs(ctx)
    state = program.train_state(cfg, dev, w0)
    w0 = {k: v.cpu() for k, v in w0.items()}
    evaluate(cfg, state=state, dataset_iter=batches(views, labels, b, 2 * b))
    spans = ctx.spans
    profiled = ProfiledWindow(spans, dev) if ctx.trace else None
    if profiled:
        profiled.warm_up()
    ctx.setup_done()

    checked = ctx.seed % mix["checked_passes"]   # the pass compared
    results, logits = [], []
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline or len(results) <= checked:
        prof_this = profiled is not None and len(results) == mix["trace"][
            "pass"]
        if prof_this:
            profiled.start()
        with (recorded_logits() if len(results) == checked
              else contextlib.nullcontext([])) as seen, spans("pass"):
            results.append(evaluate(cfg, state=state, dataset_iter=batches(
                views, labels, b, shapes)))
        if prof_this:
            profiled.stop()
        if len(results) - 1 == checked:
            logits.append(seen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window = time.perf_counter() - t0
    peak = program.memory_peak(dev)
    profile = profiled.read() if profiled else None
    if profile is not None:
        profile["steps"] = -(-shapes // b)
    del state
    program.free(dev)

    scored = sum(r["count"] for r in results)
    expected = shapes * len(results)
    ref = reference_logits(ctx, w0, views, dev)
    rows = pass_rows(n_pool, b, shapes)
    return {
        "e2e": {"eval_views_per_s": scored * m["num_views"] / window},
        "attempted": expected, "failed": max(expected - scored, 0),
        "checks": logit_checks(logits, ref, rows, results, b, shapes),
        "memory_peak_bytes": peak, "profile": profile,
        "records": {"kind": "eval_pass", "passes": len(results),
                    "window_s": window, "spans": dict(spans.durations)},
    }


def reference_logits(ctx, w0, views, dev, num=layers.Exact) -> np.ndarray:
    """(pool_shapes + 1, K): the reference's eval-mode logits of every
    pooled shape, then of a padding row (all-zero views), a batch of the
    mix's size at a time."""
    params = {k: v.to(dev) for k, v in w0.items()}
    zero = np.zeros((1,) + views.shape[1:], np.uint8)
    allv = np.concatenate([views, zero])
    b = ctx.mix["batch_size"]
    out = []
    with torch.no_grad(), layers.exact_float32():
        for i in range(0, len(allv), b):
            lg, _ = ref_gvcnn.forward(
                params, torch.from_numpy(allv[i:i + b]).to(dev), ctx.model,
                "eval", num)
            out.append(lg.cpu().numpy())
    return np.concatenate(out)


def last_batch_excess(gaps, rows, batch: int, shapes: int) -> float:
    """The worst of: how much farther from the reference a real row of
    the last, padded batch reads than the same pooled shape does in the
    pass's full batches.  A shape's grouping, and so its gap, is the same
    wherever it sits in an eval-mode batch; 0 where no batch is padded."""
    lo = (shapes - 1) // batch * batch
    if shapes - lo == batch:
        return 0.0
    worst = 0.0
    for p in range(lo, shapes):
        same = np.flatnonzero(rows[:lo] == rows[p])
        base = gaps[same].min() if len(same) else 0.0
        worst = max(worst, float(gaps[p] - base))
    return worst


def logit_checks(logits, ref, rows, results, batch, shapes) -> dict:
    """Over every row of every recorded pass: logit_gap, a row's largest
    logit error over its reference logits' range (`compare.high` of them,
    and the worst, printed); last_batch_excess (`last_batch_excess`, the worst
    pass); count_gap: the most shapes a pass counted other than the
    split's; row_gap: the most rows a pass's recorded logits held other
    than its padded batches'.  A pass whose rows do not line up with its
    batches reads as all wrong (gap 1)."""
    gaps = []
    want = ref[rows]
    row_gap, excess = 0, 0.0
    for seen in logits:
        prog = torch.cat(seen).numpy() if seen else np.zeros((0,) +
                                                             want.shape[1:])
        row_gap = max(row_gap, abs(len(prog) - len(want)))
        g = (compare.logit_gaps(prog, want) if prog.shape == want.shape
             else np.ones(len(want)))
        gaps.append(g)
        excess = max(excess, last_batch_excess(g, rows, batch, shapes))
    gaps = np.concatenate(gaps)
    return {"logit_gap_p80": compare.high(gaps),
            "logit_gap": float(gaps.max()),
            "last_batch_excess": excess,
            "count_gap": float(max(abs(r["count"] - shapes)
                                   for r in results)),
            "row_gap": float(row_gap)}


def controls(ctx) -> dict:
    """The compared numbers of the reference put in the program's place,
    in float8 (the control) and in bfloat16 (a witness), over one pass,
    against the float32 reference."""
    w0, views, _ = inputs(ctx)
    w0 = {k: v.cpu() for k, v in w0.items()}
    mix, dev = ctx.mix, ctx.device
    exact = reference_logits(ctx, w0, views, dev)
    rows = pass_rows(mix["pool_shapes"], mix["batch_size"],
                     mix["pass_shapes"])
    out = {}
    for name, num in (("fp8", layers.FP8), ("bf16", layers.BF16)):
        other = reference_logits(ctx, w0, views, dev, num)
        out[name] = logit_checks(
            [[torch.from_numpy(other[rows])]], exact, rows,
            [{"count": mix["pass_shapes"]}], mix["batch_size"],
            mix["pass_shapes"])
    return out
