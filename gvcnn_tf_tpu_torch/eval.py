"""Evaluation on PyTorch and CUDA (counterpart of `gvcnn_tf_tpu/eval.py`).

`evaluate(config)` scores the validation split once and returns top-1
accuracy, the correct and total counts and, with `per_class`, the accuracy
of each class.  The weights come from the newest checkpoint under
`checkpoint_dir` (default: the config's `train_logdir`; the model alone,
whatever optimizer wrote it; one of the port's checkpoints or one of the
JAX package's Orbax checkpoints, `checkpoint.model_state`), from an
in-memory `TrainState` (the training loop's `--eval_every`), or from JAX
variables through the bridge (parity tests).

Every batch is padded on the host to one size, `batch_size`, so the convs
and both kernels see one shape and each kernel launches once a batch; the
padding rows are dropped before counting.  Batches stream through the
prefetcher in the config's wire dtype (uint8 views are normalized on the
device), the argmax is taken on fp32 logits, and each batch's correct flags
are copied back asynchronously and read while the next batch computes.
The forward runs under `torch.no_grad()`, not `inference_mode`: the
kernels' caches (the stem's packed weight, BatchNorm's scale and shift)
are kept on parameters that a training run goes on updating.  On a card
the forward is a CUDA graph (`eval_graph`, `utils/graphs.py`), one a
(model, padded shape, wire dtype), as the JAX package caches its jitted
eval step: the first batch runs eagerly (the warm-up), the second
captures, every later one replays; `recorded_logits` collects the logits
of the scored batches, which no module hook sees under a replay.

Spans and counters (`utils/profiling.py`): `eval.setup` from the
scoring model's set-up to the first forward's launch (the model, the
dataset, the prefetcher's start and its first batch), `eval.drain`
around the last batch's wait and the count; `eval.rows` and
`eval.padded_rows` count the rows this process scored and the padding
rows it dropped, once a pass.

Over several data-parallel ranks (`world`, as the JAX package's
multi-process evaluation does): each rank scores its own shard of the
split (every world-size-th shape) at the global batch over the world's
size, padded to that one shape, and the correct, total and per-class counts
are summed over the ranks by one all-reduce at the end, so shards of
unequal length cannot deadlock (no collective runs per batch); every rank
returns the global result.  `num_devices` must be the world's size (None:
any).  The CLI joins a launcher's world (torchrun's environment), or
with `--num_devices k` and no launcher spawns k ranks on this host.

CLI:
    python -m gvcnn_tf_tpu_torch.eval --config mn40_12view \
        --dataset procedural --checkpoint_dir runs/mn40      # on the card
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import sys
import threading
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gvcnn_tf_tpu_torch.bridge import jax_to_state_dict
from gvcnn_tf_tpu_torch.checkpoint import model_state, to_eval
from gvcnn_tf_tpu_torch.configs import (
    GVCNNConfig,
    add_flags,
    config_from_flags,
    resolve_transfer_dtype,
)
from gvcnn_tf_tpu_torch.data import DevicePrefetcher, make_dataset
from gvcnn_tf_tpu_torch.metrics import log
from gvcnn_tf_tpu_torch.models.gvcnn import ViewModel, build_model
from gvcnn_tf_tpu_torch.parallel import (
    World,
    check_num_devices,
    initialize_distributed,
    launch_env,
    shutdown,
    spawn,
)
from gvcnn_tf_tpu_torch.parallel.collectives import sum_counts
from gvcnn_tf_tpu_torch.utils import (
    graphs,
    normalize_views,
    profiling,
    resolve_device,
)

# The model that checkpoints and JAX variables are loaded into, one per
# (config, device), as the JAX package caches its jitted eval step: repeated
# evaluations build and place it once.
_MODELS: Dict[Tuple[GVCNNConfig, torch.device], ViewModel] = {}


# The eval graphs of each model scored on a card, one a (padded shape, wire
# dtype) (`eval_graph`): as the JAX package caches its jitted eval step, a
# model (one of `_MODELS`, or a training run's) captures once.
_GRAPHS: "weakref.WeakKeyDictionary[ViewModel, Dict]" = (
    weakref.WeakKeyDictionary())


def _cached_model(config: GVCNNConfig,
                  device: torch.device) -> ViewModel:
    model = _MODELS.get((config, device))
    if model is None:
        model = _MODELS[(config, device)] = build_model(config)
    return model


@contextlib.contextmanager
def scoring_model(config: GVCNNConfig, checkpoint_dir: Optional[str] = None,
                  state=None, fold_bn: bool = False, device="cuda"):
    """The model to score with, in eval mode, with grad mode off:

      state None        the newest checkpoint under `checkpoint_dir`
                        (default: the config's `train_logdir`), on `device`
      state TrainState  its own model, on its device; it goes back to the
                        mode it was in on exit (with `fold_bn`: a folded
                        copy of its weights instead)
      state dict        JAX variables {params, batch_stats} with numpy
                        leaves, through the bridge, on `device`
    """
    if state is not None and not isinstance(state, dict):
        model = state.model
        if not fold_bn:
            mode = model.training
            try:
                with torch.no_grad():
                    yield model.eval()
            finally:
                model.train(mode)
            return
        dev = next(model.parameters()).device
        weights = model.state_dict()
    else:
        dev = resolve_device(device)
        weights = (jax_to_state_dict(state) if state is not None
                   else model_state(checkpoint_dir
                                    or config.train.train_logdir))
    with torch.no_grad():
        yield to_eval(_cached_model(config, dev), weights, dev, fold_bn)


def _scores(model: ViewModel, views: torch.Tensor, labels: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hits (B,) bool: the argmax of the fp32 logits equals the label,
    the fp32 logits (B, K))."""
    logits, _ = model(normalize_views(views))
    logits = logits.float()
    return logits.argmax(-1) == labels, logits


# The lists `recorded_logits` contexts collect into, innermost last.
_RECORDING = threading.local()


@contextlib.contextmanager
def recorded_logits():
    """Within the context, every batch that `evaluate` scores on this
    thread appends its fp32 logits (on the host, padding rows included) to
    the list it yields: the logits the graph computed where one replays (a
    module hook sees no replayed forward)."""
    stack = _RECORDING.__dict__.setdefault("stack", [])
    seen = []
    stack.append(seen)
    try:
        yield seen
    finally:
        stack.remove(seen)


def eval_graph(model: ViewModel, batch: Dict[str, torch.Tensor]
               ) -> graphs.CapturedCall:
    """The CUDA graph of `_scores` for `model` at the batch's padded shape
    and wire dtype (`_GRAPHS`), keyed on the model's parameters' and
    buffers' storages: `to_eval` loads weights into them in place, so a
    graph outlives a reload, and the capture reads the weights themselves
    (`utils/graphs.py`).  The graph's functions hold neither the graph
    nor the model, so the graphs are freed with the model, at once."""
    views, labels = batch["views"], batch["label"]
    cache = _GRAPHS.setdefault(model, {})
    key = (tuple(views.shape), views.dtype)
    g = cache.get(key)
    if g is None:
        ref = weakref.ref(model)        # the graphs go with the model
        static = {"views": torch.empty_like(views),
                  "label": torch.empty_like(labels)}
        g = cache[key] = graphs.CapturedCall(
            f"the eval forward of {type(model).__name__} at "
            f"{tuple(views.shape)} {views.dtype}",
            lambda: _scores(ref(), static["views"], static["label"]),
            static, device=views.device,
            watch=lambda: graphs.model_tensors(ref()))
    return g


def _to_host(t: torch.Tensor):
    """(host copy of t, event or None): on a card the copy goes to pinned
    memory asynchronously and the event marks its end."""
    if t.device.type != "cuda":
        return t.clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def evaluate(config: GVCNNConfig, checkpoint_dir: Optional[str] = None, *,
             dataset_iter=None, state=None, per_class: bool = False,
             fold_bn: bool = False, device="cuda",
             world: Optional[World] = None) -> dict:
    """{'accuracy', 'correct', 'count'} (and 'per_class_accuracy', a list
    over classes, with `per_class`) over one pass of the validation split,
    or of `dataset_iter` (host batches; with several ranks, this rank's).
    For `state` and `device` see `scoring_model` (`world`'s device, where
    one is given, wins over `device`); `world`: this rank of the
    data-parallel world (None: one process)."""
    world = world or World()
    check_num_devices(config.num_devices, world)
    if world.distributed:
        device = world.device
    d = config.data
    # The JAX package's rule for its processes' batch.
    pad_to = max(d.batch_size // world.size, 1)
    meta = collections.deque()   # (n, labels[:n]) per batch produced

    def padded(batches):
        for batch in batches:
            views, labels = np.asarray(batch["views"]), np.asarray(
                batch["label"])
            n = len(labels)
            meta.append((n, labels.copy()))
            if n != pad_to:
                views = np.concatenate([views, np.zeros(
                    (pad_to - n,) + views.shape[1:], views.dtype)])
                labels = np.concatenate([labels, np.zeros(pad_to - n,
                                                          labels.dtype)])
            yield {"views": views, "label": labels}

    n_correct = n_total = n_padded = 0
    cls_correct = np.zeros(d.num_classes, np.int64)
    cls_total = np.zeros(d.num_classes, np.int64)

    def drain(item):
        nonlocal n_correct, n_total, n_padded
        (host, done), (n, labels) = item
        if done is not None:
            done.synchronize()
        correct = host.numpy()[:n].astype(np.int64)
        n_correct += int(correct.sum())
        n_total += n
        n_padded += len(host) - n
        if per_class:
            np.add.at(cls_correct, labels, correct)
            np.add.at(cls_total, labels, 1)

    with profiling.span("eval.setup") as setup, scoring_model(
            config, checkpoint_dir, state, fold_bn, device) as model:
        dev = next(model.parameters()).device
        if dataset_iter is None:
            dataset_iter = make_dataset(
                dataclasses.replace(d, batch_size=pad_to), train=False,
                seed=config.train.seed, num_epochs=1,
                shard_index=world.rank, num_shards=world.size)
        pending = None
        # Depth 0 means "prefetch off": one batch ahead is the unpipelined
        # loop.
        with DevicePrefetcher(padded(dataset_iter), dev,
                              resolve_transfer_dtype(config),
                              depth=max(d.prefetch_to_device, 1)) as batches:
            for batch in batches:
                setup.close()           # the first forward is launched next
                if graphs.capturable(dev):
                    hits, logits = eval_graph(model, batch)(
                        views=batch["views"], label=batch["label"])
                else:
                    hits, logits = _scores(model, batch["views"],
                                           batch["label"])
                for seen in getattr(_RECORDING, "stack", ()):
                    seen.append(logits.to("cpu", copy=True))
                item = (_to_host(hits), meta.popleft())
                if pending is not None:
                    drain(pending)
                pending = item
        with profiling.span("eval.drain"):
            if pending is not None:
                drain(pending)
            profiling.count("eval.rows", n_total)
            profiling.count("eval.padded_rows", n_padded)
            # One all-reduce of every count, after the last batch.
            totals = sum_counts(np.concatenate(
                [[n_correct, n_total], cls_correct, cls_total]), world)
    n_correct, n_total = int(totals[0]), int(totals[1])
    cls_correct, cls_total = np.split(totals[2:], 2)
    result = {"accuracy": n_correct / max(n_total, 1), "correct": n_correct,
              "count": n_total}
    if per_class:
        result["per_class_accuracy"] = (
            cls_correct / np.maximum(cls_total, 1)).tolist()
    return result


def _parse(argv):
    p = argparse.ArgumentParser(description="gvcnn_tf_tpu_torch evaluator "
                                            "(PyTorch + CUDA)")
    add_flags(p)
    p.add_argument("--checkpoint_dir", default=None,
                   help="directory of the port's or the JAX package's "
                        "Orbax checkpoints (default: --train_logdir)")
    p.add_argument("--per_class", action="store_true")
    p.add_argument("--fold_bn", action="store_true",
                   help="fold BatchNorm into conv kernels (exact)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises when no card "
                        "is present, it never falls back to the CPU; with "
                        "several ranks 'cuda' is each rank's own card")
    p.add_argument("--num_devices", type=int, default=None,
                   help="ranks that score the split, one per card (default: "
                        "the config's); k > 1 without a launcher spawns k "
                        "ranks on this host")
    args = p.parse_args(argv)
    config = config_from_flags(args)
    if args.num_devices is not None:
        config = config.replace(num_devices=args.num_devices)
    return args, config


def _run(args, config, init_method=None):
    """One rank of the CLI's evaluation; rank 0 prints the result."""
    try:
        world = initialize_distributed(device=args.device,
                                       init_method=init_method)
    except RuntimeError as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.eval: {e}") from e
    try:
        result = evaluate(config, checkpoint_dir=args.checkpoint_dir,
                          per_class=args.per_class, fold_bn=args.fold_bn,
                          device=args.device, world=world)
    except (NotImplementedError, FileNotFoundError, ImportError,
            ValueError) as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.eval: {e}") from e
    finally:
        shutdown(world)
    if world.is_main:
        log(f"top-1 accuracy {result['accuracy']:.4f} "
            f"({result['correct']}/{result['count']})")
        print(result, flush=True)


def _spawned_rank(init_method, argv):
    _run(*_parse(argv), init_method)


def main(argv=None):
    args, config = _parse(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.eval: {e}") from e
    k = config.num_devices or 1
    if k > 1 and launch_env() is None:
        spawn(_spawned_rank, k,
              args=(list(sys.argv[1:] if argv is None else argv),))
        return
    _run(args, config)


if __name__ == "__main__":
    main()
