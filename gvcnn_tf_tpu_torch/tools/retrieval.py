"""3D shape retrieval on shape descriptors (counterpart of
`gvcnn_tf_tpu/tools/retrieval.py`).

The GVCNN paper evaluates retrieval with the fused shape descriptor; this
tool extracts L2-normalized shape descriptors with the model, ranks the
gallery by cosine similarity and reports mAP and precision@k.

`extract_descriptors` runs the model on the device (uint8 views normalized
there, as the inference engine does) over one pass of the validation split,
the same batches as the JAX tool's `make_dataset(train=False,
num_epochs=1)`; `retrieval_metrics` is numpy on the host and the JAX tool's
function line for line (a test holds them equal).

CLI:
    python -m gvcnn_tf_tpu_torch.tools.retrieval --config mn40_12view \
        --dataset procedural --checkpoint_dir runs/mn40 [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from gvcnn_tf_tpu_torch.configs import GVCNNConfig, add_flags, config_from_flags
from gvcnn_tf_tpu_torch.data import make_dataset
from gvcnn_tf_tpu_torch.eval import scoring_model
from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights, to_device
from gvcnn_tf_tpu_torch.utils import normalize_views, resolve_device


def extract_descriptors(
    config: GVCNNConfig,
    checkpoint_dir: Optional[str] = None,
    *,
    dataset_iter: Optional[Iterator] = None,
    state=None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (descriptors (N, C) L2-normalized fp32, labels (N,)).

    The weights: `state` as `eval.scoring_model` takes it (a `TrainState`,
    which keeps its device, or JAX variables through the bridge), else the
    newest checkpoint under `checkpoint_dir`, else seeded weights (as the
    JAX tool runs its init without either).  The descriptor is the
    model's `shape_descriptor` in fp32 over sqrt(1e-12 + its squared
    norm)."""
    if state is None and not checkpoint_dir:
        scoring = contextlib.nullcontext(to_device(
            init_weights(build_model(config), config.train.seed),
            resolve_device(device)).eval())
    else:
        scoring = scoring_model(config, checkpoint_dir, state, device=device)
    if dataset_iter is None:
        dataset_iter = make_dataset(
            config.data, train=False, seed=config.train.seed, num_epochs=1
        )
    descs, labels = [], []
    with scoring as model, torch.no_grad():
        dev = next(model.parameters()).device
        for batch in dataset_iter:
            views = torch.from_numpy(np.asarray(batch["views"])).to(dev)
            _, ep = model(normalize_views(views))
            d = ep["shape_descriptor"].float()
            d = d / torch.sqrt(1e-12 + (d * d).sum(-1, keepdim=True))
            descs.append(d.cpu().numpy())
            labels.append(np.asarray(batch["label"]))
    return np.concatenate(descs), np.concatenate(labels)


def retrieval_metrics(
    descriptors: np.ndarray,
    labels: np.ndarray,
    *,
    ks: Tuple[int, ...] = (1, 5, 10),
) -> dict:
    """Leave-one-out retrieval over the gallery: each item queries the rest.

    mAP with relevant = same class; AP is the mean of precision@hit over a
    query's relevant items (standard information-retrieval AP).
    """
    n = len(labels)
    sims = descriptors @ descriptors.T
    np.fill_diagonal(sims, -np.inf)             # exclude self-match
    order = np.argsort(-sims, axis=1)[:, : n - 1]
    rel = labels[order] == labels[:, None]      # (n, n-1) relevance

    aps = []
    prec_at = {k: [] for k in ks}
    for i in range(n):
        r = rel[i]
        n_rel = int(r.sum())
        if n_rel == 0:
            continue
        hits = np.flatnonzero(r)
        precisions = (np.arange(1, n_rel + 1)) / (hits + 1)
        aps.append(precisions.mean())
        for k in ks:
            prec_at[k].append(r[:k].mean())
    out = {"mAP": float(np.mean(aps)) if aps else 0.0, "num_queries": n}
    for k in ks:
        out[f"precision@{k}"] = (
            float(np.mean(prec_at[k])) if prec_at[k] else 0.0
        )
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="GVCNN shape retrieval eval")
    add_flags(p)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises when no card "
                        "is present, it never falls back to the CPU")
    args = p.parse_args(argv)
    config = config_from_flags(args)
    try:
        descs, labels = extract_descriptors(
            config,
            checkpoint_dir=args.checkpoint_dir or config.train.train_logdir,
            device=args.device,
        )
    except (RuntimeError, NotImplementedError, FileNotFoundError,
            ImportError, ValueError) as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.tools.retrieval: {e}") from e
    metrics = retrieval_metrics(descs, labels)
    print(metrics)


if __name__ == "__main__":
    main()
