"""Kind `train_stream`: the program's compiled train step
(`train.compile_train_step`, a CUDA graph replayed every step) fed by its
`DevicePrefetcher` from a seeded host pool of uint8 batches, as `train()`
runs it, reading the metrics back every `log_every` steps.

Mix keys: batch_size, pool_batches (host batches cycled in order),
transfer_dtype, trace {skip_steps, steps} (the profiled sub-window of a
`--trace 1` run).

Set-up makes the weights and the pool, builds the step and runs its first
three steps through the window's own call and feed: the first eager, the
second captured and replayed, the third replayed; `Watch` keeps each
step's rows, and the parameters each step starts from are copied to the
host.  The reference follows those three steps from the same weights on
the same batches, with the dropout masks worked out from the
configuration's seed rule (`reference/train.py`): its own gradients and
parameter changes are compared with the program's, and each step's rows
with its float32 rows from the parameters the program's step started from
(a max-pool's tie or a view's group can route one update differently, and
later steps would compare that, not the step).  Then the window: steps
for `--seconds`, synchronized at both ends."""

from __future__ import annotations

import sys
import time

import torch

from benchmark import compare, program
from benchmark.inputs import host_views, labels as make_labels
from benchmark.reference import gvcnn as ref_gvcnn, layers, train as ref_train
from benchmark.tracing import ProfiledWindow

SETUP_STEPS = 3


def _stream(views, labels, batch):
    n = len(views) // batch
    k = 0
    while True:
        i = k % n
        yield {"views": views[i * batch:(i + 1) * batch],
               "label": labels[i * batch:(i + 1) * batch]}
        k += 1


def inputs(ctx):
    """(weights on the device, the pool's views (N, V, H, W, 3) uint8 and
    labels (N,) on the host)."""
    mix, m = ctx.mix, ctx.model
    n = mix["pool_batches"] * mix["batch_size"]
    views = host_views(ctx.seed, "train_views", (n, m["num_views"],
                       m["height"], m["width"], 3), mix["pool_batches"],
                       ctx.device)
    labels = make_labels(ctx.seed, "train_labels", n, m["num_classes"])
    return program.weights(ctx), views, labels


class Watch:
    """Device buffers that hooks on the model fill with each step's raw FCN
    scores, logits and the loss's gradient at the logits.  The hooks run
    in the eager first step and while the second is captured, so the graph
    itself writes the buffers at every replay (three copies of a few KB a
    step, which stay in the window's graph); `take()` reads them to the
    host after a step."""

    def __init__(self, model):
        self.bufs = {}
        model.GroupingModule.register_forward_hook(
            lambda mod, args, out: self._keep("raw", out))
        model.Logits.register_forward_hook(self._logits)

    def _keep(self, name, t):
        if name not in self.bufs:        # in the eager step, before capture
            self.bufs[name] = torch.empty(t.shape, dtype=torch.float32,
                                          device=t.device)
        self.bufs[name].copy_(t.detach())

    def _logits(self, mod, args, out):
        self._keep("logits", out)
        if out.requires_grad:
            out.register_hook(lambda g: self._keep("dlogits", g))

    def take(self) -> dict:
        return {k: v.to("cpu", copy=True).numpy()
                for k, v in self.bufs.items()}


def run(ctx) -> dict:
    from gvcnn_tf_tpu_torch.configs import resolve_transfer_dtype
    from gvcnn_tf_tpu_torch.data import DevicePrefetcher
    from gvcnn_tf_tpu_torch.train import compile_train_step

    mix, m, dev = ctx.mix, ctx.model, ctx.device
    b = mix["batch_size"]
    cfg = ctx.port_config(batch_size=b, transfer_dtype=mix["transfer_dtype"])
    w0, views, labels = inputs(ctx)
    state = program.train_state(cfg, dev, w0)
    w0 = {k: v.cpu() for k, v in w0.items()}
    params = dict(state.model.named_parameters())

    prefetch = DevicePrefetcher(_stream(views, labels, b), dev,
                                resolve_transfer_dtype(cfg),
                                depth=cfg.data.prefetch_to_device)
    try:
        batch = next(prefetch)
        step = compile_train_step(state, cfg, batch)
        losses, seen, states = [], [], [w0]
        watch = Watch(state.model)
        for i in range(SETUP_STEPS):     # eager, captured and replayed
            if i:
                batch = next(prefetch)
            losses.append(step(state, batch, cfg)["loss"].clone())
            seen.append(watch.take())
            if i + 1 < SETUP_STEPS:      # where the next step starts
                states.append({k: v.detach().to("cpu", copy=True)
                               for k, v in state.model.state_dict().items()})
            if i == 0:       # the momentum trace after one step is g1
                grads = compare.leaf_norms(dict(zip(
                    params, state.optimizer.slots["trace"])))
        changes = compare.leaf_norms(
            {k: p.detach() - w0[k].to(dev) for k, p in params.items()})
        prog = {"losses": [float(x) for x in losses], "grads": grads,
                "changes": changes, "steps": seen}
        profiled = ProfiledWindow(ctx.spans, dev) if ctx.trace else None
        if profiled:
            profiled.warm_up()
        ctx.setup_done()

        tr = mix["trace"]
        spans, log_every = ctx.spans, cfg.train.log_every
        steps, steady, logged = 0, None, None
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while time.perf_counter() < deadline or spans.profiling:
            if profiled and steps == tr["skip_steps"]:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                steady = (steps, time.perf_counter() - t0)
                profiled.start()
            with spans("input_wait"):
                batch = next(prefetch)
            with spans("step_call"):
                mets = step(state, batch, cfg)
            steps += 1
            if steps % log_every == 0:       # as train() logs them
                logged = {k: float(v) for k, v in mets.items()}
            if profiled and steps == tr["skip_steps"] + tr["steps"]:
                profiled.stop()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window = time.perf_counter() - t0
    finally:
        prefetch.close()
    peak = program.memory_peak(dev)
    profile = profiled.read() if profiled else None
    if profile is not None:
        profile["steps"] = tr["steps"]
        for name, span in profile["host"].items():
            print(f"train_stream: {span['n']} {name} spans {span['s']!r} s, "
                  f"in CUDA runtime calls {span['runtime']!r}",
                  file=sys.stderr)
    del state, step, params, batch, mets, prefetch, logged
    program.free(dev)

    views_a_step = b * m["num_views"]
    ref = reference_steps(ctx, w0, views, labels, b, dev)
    ref["steps"] = exact_rows(ctx, states, views, labels, b, dev)
    compare.print_worst(prog, ref, "train_stream")
    return {
        "e2e": {"train_views_per_s": steps * views_a_step / window,
                "train_peak_gib": peak / 2 ** 30},
        "attempted": steps, "failed": 0,
        "checks": compare.train_checks(prog, ref),
        "memory_peak_bytes": peak, "profile": profile,
        "records": {"kind": "train_stream", "steps": steps,
                    "window_s": window, "steady": steady,
                    "views_a_step": views_a_step, "model": m,
                    "shapes_a_step": b,
                    "spans": dict(ctx.spans.durations)},
    }


def _batches(views, labels, b, dev):
    return [{"views": torch.from_numpy(views[i * b:(i + 1) * b]).to(dev),
             "label": torch.from_numpy(labels[i * b:(i + 1) * b]).to(dev)}
            for i in range(SETUP_STEPS)]


def reference_steps(ctx, w0, views, labels, b, dev, num=layers.Exact):
    """The reference's own first SETUP_STEPS steps, in `num`, from `w0` on
    the pool's first batches: {"losses", "grads", "changes", "steps": its
    rows, "states": the parameters each step started from, "views"}."""
    spec = ref_gvcnn.param_spec(ctx.model)
    params = {k: w0[k].to(dev) for k in spec}
    trainable = [k for k, (_, role) in spec.items()
                 if not role.startswith("bn_") or role in ("bn_scale",
                                                           "bn_bias")]
    with layers.exact_float32():
        out = ref_train.train(params, trainable,
                              _batches(views, labels, b, dev), ctx.model,
                              ctx.config["optimizer"], ctx.train_seed, num)
    return {"losses": out["losses"], "views": ctx.model["num_views"],
            "steps": [{k: v.float().cpu().numpy() for k, v in st.items()}
                      for st in out["steps"]],
            "states": out["states"],
            "grads": compare.leaf_norms(out["grads"]),
            "changes": compare.leaf_norms(
                {k: out["params"][k] - params[k] for k in trainable})}


def exact_rows(ctx, states, views, labels, b, dev) -> list:
    """The float32 reference's rows of each of the first steps, each from
    the parameters that step started from in `states` (the program's, or a
    control's): a row is judged on the step it was produced in."""
    spec = ref_gvcnn.param_spec(ctx.model)
    out = []
    with layers.exact_float32():
        for t, (st, batch) in enumerate(zip(
                states, _batches(views, labels, b, dev))):
            rows = ref_train.step_rows(
                {k: st[k].to(dev) for k in spec}, batch, ctx.model,
                ctx.config["optimizer"], ctx.train_seed, t, layers.Exact)
            out.append({k: v.float().cpu().numpy() for k, v in rows.items()})
    return out


def controls(ctx) -> dict:
    """The compared numbers of the reference put in the program's place,
    in float8 (the control) and in bfloat16 (a witness of rounding at the
    configuration's precision), each against the float32 reference."""
    w0, views, labels = inputs(ctx)
    w0 = {k: v.cpu() for k, v in w0.items()}
    b, dev = ctx.mix["batch_size"], ctx.device
    exact = reference_steps(ctx, w0, views, labels, b, dev)
    out = {}
    for name, num in (("fp8", layers.FP8), ("bf16", layers.BF16)):
        other = reference_steps(ctx, w0, views, labels, b, dev, num)
        at = dict(exact, steps=exact_rows(ctx, other.pop("states"), views,
                                          labels, b, dev))
        out[name] = compare.train_checks(other, at)
        program.free(dev)
    return out
