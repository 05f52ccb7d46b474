"""The train step of the reference: softmax cross-entropy plus slim's L2
term 0.5 wd sum ||w||^2 over every conv and linear weight (not a
BatchNorm's scale or bias), the gradient by autograd, and momentum SGD
(trace <- g + m trace; p <- p - lr(t) trace) with slim's staircase
exponential decay of the rate.  Dropout masks are drawn the way the
configuration states them: Bernoulli(keep_prob) from a generator seeded
from (seed, step, microbatch)."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import gvcnn


def learning_rate(opt: dict, count: int) -> float:
    """The staircase schedule lr0 * rate^floor(t / steps) at update t."""
    if opt["lr_decay_steps"] <= 0 or count <= 0:
        return opt["learning_rate"]
    return opt["learning_rate"] * opt["lr_decay_rate"] ** math.floor(
        count / opt["lr_decay_steps"])


def dropout_seed(seed: int, step: int, micro: int) -> int:
    """The 63-bit generator seed of one microbatch's dropout mask."""
    w = np.random.SeedSequence([seed, step, micro]).generate_state(
        2, np.uint32)
    return (int(w[0]) << 31) | (int(w[1]) >> 1)


def dropout_keep(seed: int, step: int, shape, keep_prob: float,
                 device) -> torch.Tensor:
    """The keep mask of step `step`'s (single) microbatch."""
    g = torch.Generator(device=device).manual_seed(dropout_seed(seed, step, 0))
    return torch.rand(shape, generator=g, device=device,
                      dtype=torch.float32) < keep_prob


def loss(params: Dict[str, torch.Tensor], views: torch.Tensor,
         labels: torch.Tensor, model: dict, opt: dict, num, keep=None,
         inside=None):
    """(the loss with its L2 term, the logits); `inside` as
    `gvcnn.forward`'s."""
    logits, _ = gvcnn.forward(params, views, model, "train", num, keep,
                              inside)
    l2 = sum(p.square().sum() for k, p in params.items()
             if k.endswith(".weight"))
    return (F.cross_entropy(logits, labels)
            + 0.5 * opt["weight_decay"] * l2, logits)


def dlogits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The gradient of the mean softmax cross-entropy at the logits."""
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    return (torch.softmax(logits, -1) - onehot) / len(labels)


def _keep(params, views, model, seed, t):
    if model["dropout_keep_prob"] >= 1.0:
        return None
    feat = params["Logits.weight"].shape[1]
    return dropout_keep(seed, t, (views.shape[0], feat),
                        model["dropout_keep_prob"], views.device)


@torch.no_grad()
def step_rows(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
              model: dict, opt: dict, seed: int, t: int, num) -> dict:
    """Step `t`'s rows at `params`: {"raw": FCN scores, "logits",
    "dlogits"}."""
    inside = {}
    _, logits = loss(params, batch["views"], batch["label"], model, opt, num,
                     _keep(params, batch["views"], model, seed, t), inside)
    return {"raw": inside["raw"], "logits": logits,
            "dlogits": dlogits(logits, batch["label"])}


def train(params0: Dict[str, torch.Tensor], trainable: Sequence[str],
          batches: List[Dict[str, torch.Tensor]], model: dict, opt: dict,
          seed: int, num) -> dict:
    """len(batches) momentum-SGD steps from `params0` (not changed).
    Returns {"losses": [loss of each step, before its update], "steps":
    each step's rows (`step_rows`), "states": the parameters each step
    started from, "grads": {name: the first step's gradient}, "params":
    {name: the trainable parameters after the last step}}."""
    params = {k: v.detach().clone() for k, v in params0.items()}
    trace = {k: torch.zeros_like(params[k]) for k in trainable}
    losses, first, steps, states = [], None, [], []
    for t, batch in enumerate(batches):
        states.append({k: v.detach() for k, v in params.items()})
        for k in trainable:
            params[k].requires_grad_(True)
        views = batch["views"]
        inside = {}
        total, logits = loss(params, views, batch["label"], model, opt,
                             num, _keep(params, views, model, seed, t),
                             inside)
        grads = torch.autograd.grad(total, [params[k] for k in trainable])
        logits = logits.detach()
        steps.append({"raw": inside["raw"].detach(), "logits": logits,
                      "dlogits": dlogits(logits, batch["label"])})
        losses.append(float(total.detach()))
        lr = learning_rate(opt, t)
        with torch.no_grad():
            for k, g in zip(trainable, grads):
                params[k] = params[k].detach()
                trace[k] = g + opt["momentum"] * trace[k]
                params[k] = params[k] - lr * trace[k]
        if first is None:
            first = {k: g.detach() for k, g in zip(trainable, grads)}
        del total, grads, logits, inside
    return {"losses": losses, "steps": steps, "states": states,
            "grads": first, "params": {k: params[k] for k in trainable}}
