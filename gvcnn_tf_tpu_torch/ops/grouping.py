"""GVCNN grouping head as plain PyTorch (counterpart of
`gvcnn_tf_tpu/ops/grouping.py:42-155`).

This is the plain version the CUDA kernel (ops/grouping_kernel.py) is held
to, and the path a CPU tensor takes.  Same math and conventions as the JAX
oracle:

  scores: (B, V) float in (0, 1)
  descs:  (B, V, C) float
  scheme: (B, M, V) 0/1 float, scheme[b, j, i] = 1 iff view i is in group j

group id = clip(ceil(score * M) - 1, 0, M - 1); group descriptor = max over
member views (empty groups 0); group weight = mean (or ceil of the sum over
the count) of member scores, normalized over the groups; shape descriptor =
weighted sum of group descriptors.  The scheme is detached, so scores learn
only through the weights, and `ceil_sum` uses a straight-through ceil.
"""

from __future__ import annotations

import torch

__all__ = [
    "squash_scores",
    "grouping_scheme",
    "grouping_weight",
    "view_pooling",
    "group_fusion",
    "group_and_fuse",
]


def squash_scores(raw: torch.Tensor, method: str = "softmax") -> torch.Tensor:
    """Squash raw FCN outputs (B, V) into discrimination scores in (0, 1)."""
    if method == "softmax":
        return torch.softmax(raw, dim=-1)
    if method == "sigmoid":
        return torch.sigmoid(raw)
    if method == "sigmoid_log":
        return torch.sigmoid(torch.log(torch.abs(raw) + 1e-8))
    raise ValueError(f"unknown score squash {method!r}")


def grouping_scheme(scores: torch.Tensor, num_group: int) -> torch.Tensor:
    """Bucket views into M groups by score -> (B, M, V) 0/1 mask."""
    gid = torch.clamp(torch.ceil(scores * num_group) - 1.0, 0.0,
                      num_group - 1.0).long()                     # (B, V)
    onehot = torch.nn.functional.one_hot(gid, num_group).to(scores.dtype)
    return onehot.transpose(-1, -2)                               # (B, M, V)


def grouping_weight(scores: torch.Tensor, scheme: torch.Tensor,
                    mode: str = "mean") -> torch.Tensor:
    """(B, M) group weights, normalized over the groups; empty groups 0."""
    counts = scheme.sum(-1)                                       # (B, M)
    ssum = torch.einsum("bmv,bv->bm", scheme, scores)             # (B, M)
    if mode == "ceil_sum":
        # straight-through ceil: forward ceil(ssum), backward identity
        ssum = ssum + (torch.ceil(ssum) - ssum).detach()
    elif mode != "mean":
        raise ValueError(f"unknown group weight mode {mode!r}")
    raw = ssum / torch.clamp(counts, min=1.0)                     # 0 if empty
    total = raw.sum(-1, keepdim=True)
    return raw / torch.clamp(total, min=1e-12)


def view_pooling(descs: torch.Tensor, scheme: torch.Tensor) -> torch.Tensor:
    """Max over member views: descs (B, V, C), scheme (B, M, V) -> (B, M, C);
    empty groups come out as 0."""
    neg = torch.finfo(descs.dtype).min
    masked = torch.where(scheme[..., None] > 0, descs[:, None, :, :],
                         torch.full((), neg, dtype=descs.dtype,
                                    device=descs.device))  # (B, M, V, C)
    pooled = masked.amax(dim=2)                                   # (B, M, C)
    nonempty = scheme.sum(-1, keepdim=True) > 0                   # (B, M, 1)
    return torch.where(nonempty, pooled, torch.zeros_like(pooled))


def group_fusion(pooled: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """pooled (B, M, C), weights (B, M) -> (B, C) weighted sum."""
    return torch.einsum("bm,bmc->bc", weights, pooled)


def group_and_fuse(scores: torch.Tensor, descs: torch.Tensor, num_group: int,
                   weight_mode: str = "mean"):
    """scheme -> weights -> pooling -> fusion.

    Returns (shape_descriptor (B, C), weights (B, M), scheme (B, M, V)).
    """
    scheme = grouping_scheme(scores, num_group).detach()
    weights = grouping_weight(scores, scheme, weight_mode)
    pooled = view_pooling(descs, scheme)
    fused = group_fusion(pooled, weights)
    return fused, weights, scheme
