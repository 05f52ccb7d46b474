"""Evaluation on PyTorch and CUDA (counterpart of `gvcnn_tf_tpu/eval.py`).

`evaluate(config)` scores the validation split once and returns top-1
accuracy, the correct and total counts and, with `per_class`, the accuracy
of each class.  The weights come from the newest checkpoint under
`checkpoint_dir` (default: the config's `train_logdir`; the model alone,
whatever optimizer wrote it), from an in-memory `TrainState` (the training
loop's `--eval_every`), or from JAX variables through the bridge (parity
tests).

Every batch is padded on the host to one size, `batch_size`, so the convs
and both kernels see one shape and each kernel launches once a batch; the
padding rows are dropped before counting.  Batches stream through the
prefetcher in the config's wire dtype (uint8 views are normalized on the
device), the argmax is taken on fp32 logits, and each batch's correct flags
are copied back asynchronously and read while the next batch computes.
The forward runs under `torch.no_grad()`, not `inference_mode`: the
kernels' caches (the stem's packed weight, BatchNorm's scale and shift)
are kept on parameters that a training run goes on updating.

The JAX package's multi-process evaluation waits for multi-GPU support
(ROADMAP §1 item 10); `num_devices > 1` is refused.

CLI:
    python -m gvcnn_tf_tpu_torch.eval --config mn40_12view \
        --dataset procedural --checkpoint_dir runs/mn40      # on the card
"""

from __future__ import annotations

import argparse
import collections
import contextlib
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
from gvcnn_tf_tpu_torch.models.gvcnn import GVCNN, build_model
from gvcnn_tf_tpu_torch.utils import normalize_views, resolve_device

# The model that checkpoints and JAX variables are loaded into, one per
# (config, device), as the JAX package caches its jitted eval step: repeated
# evaluations build and place it once.
_MODELS: Dict[Tuple[GVCNNConfig, torch.device], GVCNN] = {}


def _cached_model(config: GVCNNConfig, device: torch.device) -> GVCNN:
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


def _to_host(t: torch.Tensor):
    """(host copy of t, event or None): on a card the copy goes to pinned
    memory asynchronously and the event marks its end."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def evaluate(config: GVCNNConfig, checkpoint_dir: Optional[str] = None, *,
             dataset_iter=None, state=None, per_class: bool = False,
             fold_bn: bool = False, device="cuda") -> dict:
    """{'accuracy', 'correct', 'count'} (and 'per_class_accuracy', a list
    over classes, with `per_class`) over one pass of the validation split,
    or of `dataset_iter` (host batches).  For `state` and `device` see
    `scoring_model`."""
    if (config.num_devices or 1) > 1:
        raise NotImplementedError(
            f"evaluation over {config.num_devices} devices is not ported yet "
            "(ROADMAP §1 item 10, multi-GPU data parallelism)")
    d = config.data
    pad_to = d.batch_size
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

    n_correct = n_total = 0
    cls_correct = np.zeros(d.num_classes, np.int64)
    cls_total = np.zeros(d.num_classes, np.int64)

    def drain(item):
        nonlocal n_correct, n_total
        (host, done), (n, labels) = item
        if done is not None:
            done.synchronize()
        correct = host.numpy()[:n].astype(np.int64)
        n_correct += int(correct.sum())
        n_total += n
        if per_class:
            np.add.at(cls_correct, labels, correct)
            np.add.at(cls_total, labels, 1)

    with scoring_model(config, checkpoint_dir, state, fold_bn,
                       device) as model:
        dev = next(model.parameters()).device
        if dataset_iter is None:
            dataset_iter = make_dataset(d, train=False,
                                        seed=config.train.seed, num_epochs=1)
        pending = None
        # Depth 0 means "prefetch off": one batch ahead is the unpipelined
        # loop.
        with DevicePrefetcher(padded(dataset_iter), dev,
                              resolve_transfer_dtype(config),
                              depth=max(d.prefetch_to_device, 1)) as batches:
            for batch in batches:
                logits, _ = model(normalize_views(batch["views"]))
                item = (_to_host(logits.float().argmax(-1) == batch["label"]),
                        meta.popleft())
                if pending is not None:
                    drain(pending)
                pending = item
        if pending is not None:
            drain(pending)

    result = {"accuracy": n_correct / max(n_total, 1), "correct": n_correct,
              "count": n_total}
    if per_class:
        result["per_class_accuracy"] = (
            cls_correct / np.maximum(cls_total, 1)).tolist()
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description="gvcnn_tf_tpu_torch evaluator "
                                            "(PyTorch + CUDA)")
    add_flags(p)
    p.add_argument("--checkpoint_dir", default=None,
                   help="directory of the port's checkpoints (default: "
                        "--train_logdir)")
    p.add_argument("--per_class", action="store_true")
    p.add_argument("--fold_bn", action="store_true",
                   help="fold BatchNorm into conv kernels (exact)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises when no card "
                        "is present, it never falls back to the CPU")
    args = p.parse_args(argv)
    config = config_from_flags(args)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.eval: {e}") from e
    try:
        result = evaluate(config, checkpoint_dir=args.checkpoint_dir,
                          per_class=args.per_class, fold_bn=args.fold_bn,
                          device=args.device)
    except (NotImplementedError, FileNotFoundError) as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.eval: {e}") from e
    log(f"top-1 accuracy {result['accuracy']:.4f} "
        f"({result['correct']}/{result['count']})")
    print(result)


if __name__ == "__main__":
    main()
