"""The numbers that decide `correct`, worked out from what the timed path
produced and what the plain reference computes on the same inputs.

Rows (a shape's logits, its views' raw FCN scores centered over the
views, the loss's gradient at its logits): each row's largest error over
the reference row's range, and of these the 80th percentile over every
row compared.  GVCNN's grouping is a step function of the scores, so at
bf16 rounding a few shapes in a hundred put a view in another group than
the float32 reference does and read far off; a quantile above them still
sees a fault that touches a fifth of the rows or more.

Leaves (training: the first gradient as the optimizer got it, the
parameters' change over the first three steps): the gap between the
program's norm of a leaf and the reference's, over the reference's norm
of that leaf or of the median leaf, whichever is larger; of these the
median leaf and the worst.  Leaves whose reference gradient is under a
thousandth of the median leaf's (nought to rounding: a bias under a
softmax) are left out of both.

Which of these numbers decide `correct` is the cell's limits file
(`benchmark/limits/<cell>.json`); the others are printed for the record."""

from __future__ import annotations

import statistics
from typing import Dict, Sequence

import numpy as np
import torch

NULL_LEAF = 1e-3


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm(
        [tensors[n].detach().float() for n in names])).cpu().tolist()
    return dict(zip(names, norms))


def moving_leaves(ref_grads: Dict[str, float]) -> list:
    med = statistics.median(ref_grads.values())
    return [n for n, g in ref_grads.items() if g >= NULL_LEAF * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Sequence[str]) -> list:
    """Each leaf's |program norm - reference norm| over the larger of its
    reference norm and the median leaf's."""
    med = statistics.median(ref[n] for n in leaves)
    return [abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves]


def logit_gaps(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each row's largest logit error over its reference logits' range."""
    span = np.maximum(ref.max(-1) - ref.min(-1), 1e-30)
    return np.abs(prog - ref).max(-1) / span


QUANTILE = 0.8


def row_gaps(prog: np.ndarray, ref: np.ndarray, center: bool = False):
    """`logit_gaps` of each row (each centered first, with `center`); all
    ones where the program gave other shapes than the reference."""
    if prog.shape != ref.shape:
        return np.ones(len(ref))
    if center:
        prog = prog - prog.mean(-1, keepdims=True)
        ref = ref - ref.mean(-1, keepdims=True)
    return logit_gaps(prog, ref)


def high(gaps) -> float:
    """The QUANTILE of the row gaps."""
    return float(np.quantile(np.asarray(gaps, np.float64), QUANTILE))


def train_checks(prog: dict, ref: dict) -> Dict[str, float]:
    """prog / ref: {"losses": [3 floats], "steps": each step's {"raw": FCN
    scores (B V,), "logits": (B, K), "dlogits": the loss's gradient at the
    logits (B, K)}, "grads": {leaf: norm}, "changes": {leaf: norm}}; ref
    also "views", V.  The rows of all three steps (`high`), the first
    step's loss, and the median and the worst leaf of the first gradient
    and of the change."""
    leaves = moving_leaves(ref["grads"])
    grad = leaf_gaps(prog["grads"], ref["grads"], leaves)
    change = leaf_gaps(prog["changes"], ref["changes"], leaves)
    v = ref["views"]

    def rows(key, **kw):
        shape = (lambda a: a.reshape(-1, v)) if key == "raw" else np.asarray
        return np.concatenate([row_gaps(shape(p[key]), shape(r[key]), **kw)
                               for p, r in zip(prog["steps"],
                                               ref["steps"])])

    return {"score_gap_p80": high(rows("raw", center=True)),
            "logit_gap_p80": high(rows("logits")),
            "dlogit_gap_p80": high(rows("dlogits")),
            "loss1_gap": abs(prog["losses"][0] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "grad_gap_median": statistics.median(grad),
            "grad_gap": max(grad),
            "change_gap_median": statistics.median(change),
            "change_gap": max(change)}


def print_worst(prog: dict, ref: dict, who: str):
    """The leaves that set the gradient and change gaps, on stderr."""
    import sys

    leaves = moving_leaves(ref["grads"])
    for what in ("grads", "changes"):
        med = statistics.median(ref[what][n] for n in leaves)
        gap, leaf = max(zip(leaf_gaps(prog[what], ref[what], leaves),
                            leaves))
        print(f"{who}: worst {what} leaf {leaf}: program "
              f"{prog[what][leaf]!r}, reference {ref[what][leaf]!r}, median "
              f"{med!r}, gap {gap!r}", file=sys.stderr)
    print(f"{who}: losses program {prog['losses']}, reference "
          f"{ref['losses']}", file=sys.stderr)
