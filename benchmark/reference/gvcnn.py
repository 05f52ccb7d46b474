"""GVCNN (Feng et al., CVPR 2018) over a backbone: the views folded into
the batch, one pass through the backbone, the view-discrimination FCN on
the raw endpoint (1x1 conv + BN + ReLU to 128 channels, a 1x1 conv to one
score, global average pool), the scores squashed by a softmax over the
views, grouped into M buckets by score, each group's descriptor the max
over its views, the group weights the mean score of their members
normalized over the groups, the shape descriptor their weighted sum, and
a linear head (with dropout in training).  float32 throughout."""

from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch

from benchmark.reference import inception_v1, resnet50
from benchmark.reference.layers import Net, conv, gap, linear

BACKBONES = {"inception_v1": inception_v1, "resnet50": resnet50}
SCORE_HIDDEN = 128
# Backbones whose BatchNorm has a learned scale (slim's resnet_arg_scope).
_SCALED = {"resnet50"}


def param_spec(model: dict) -> "collections.OrderedDict[str, Tuple]":
    """{parameter or statistic name: (shape, role)} of the model a
    configuration file's `model` section describes, in a fixed order.
    Roles: conv, linear, score_logit, bias, bn_scale, bn_bias, bn_mean,
    bn_var."""
    bb = BACKBONES[model["backbone"]]
    final, raw = model["final_endpoint"], model["raw_endpoint"]
    spec = collections.OrderedDict()

    def conv_bn(name, cin, cout, k, scaled):
        spec[f"{name}.conv.weight"] = ((cout, cin, k, k), "conv")
        bn = f"{name}.BatchNorm"
        if scaled:
            spec[f"{bn}.scale"] = ((cout,), "bn_scale")
        spec[f"{bn}.bias"] = ((cout,), "bn_bias")
        spec[f"{bn}.running_mean"] = ((cout,), "bn_mean")
        spec[f"{bn}.running_var"] = ((cout,), "bn_var")

    for name, cin, cout, k, *_ in bb.conv_shapes(final):
        conv_bn(name, cin, cout, k, model["backbone"] in _SCALED)
    ch = bb.channels(final)
    conv_bn("GroupingModule.Conv2d_score_1x1", ch[raw], SCORE_HIDDEN, 1,
            False)
    spec["GroupingModule.Conv2d_score_logit.weight"] = (
        (1, SCORE_HIDDEN, 1, 1), "score_logit")
    spec["GroupingModule.Conv2d_score_logit.bias"] = ((1,), "bias")
    spec["Logits.weight"] = ((model["num_classes"], ch[final]), "linear")
    spec["Logits.bias"] = ((model["num_classes"],), "bias")
    return spec


def normalize(views: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1] (x / 255 * 2 - 1)."""
    return views.to(torch.float32) / 255.0 * 2.0 - 1.0


def group_and_fuse(scores: torch.Tensor, descs: torch.Tensor, m: int):
    """scores (B, V) in (0, 1), descs (B, V, C) -> shape descriptor (B, C).
    View i joins group clip(ceil(score M) - 1, 0, M - 1); the grouping is
    not differentiated (scores learn through the weights)."""
    gid = torch.clamp(torch.ceil(scores.detach() * m) - 1, 0, m - 1)
    member = gid.long()[:, None, :] == torch.arange(
        m, device=scores.device)[None, :, None]                  # (B, M, V)
    mf = member.to(scores.dtype)
    counts = mf.sum(-1)                                           # (B, M)
    raw = (mf * scores[:, None, :]).sum(-1) / torch.clamp(counts, min=1.0)
    weights = raw / torch.clamp(raw.sum(-1, keepdim=True), min=1e-12)
    pooled = torch.where(member[..., None], descs[:, None],
                         torch.tensor(-torch.inf, device=descs.device)
                         ).amax(dim=2)                            # (B, M, C)
    pooled = torch.where(counts[..., None] > 0, pooled,
                         torch.zeros((), device=descs.device))
    return (weights[..., None] * pooled).sum(dim=1)


def forward(params: Dict[str, torch.Tensor], views: torch.Tensor,
            model: dict, mode: str, num,
            keep: Optional[torch.Tensor] = None, inside: dict = None):
    """views (B, V, H, W, 3) uint8 -> (logits (B, K), scores (B, V)).
    `inside`, where given, receives the FCN's raw scores (B * V,).
    `mode`: "train" (batch statistics), "eval" or "folded" (see
    `layers.Net`); `keep`: the dropout mask of the shape descriptor (train
    mode), kept values scaled by 1 / keep_prob."""
    bb = BACKBONES[model["backbone"]]
    x = normalize(views)
    b, v = x.shape[:2]
    x = x.reshape((b * v,) + tuple(x.shape[2:])).permute(0, 3, 1, 2)
    net = Net(params, mode, num)
    raw_ep = model["raw_endpoint"]
    feats, ends = bb.forward(net, x, model["final_endpoint"], (raw_ep,))
    descs = gap(feats).reshape(b, v, -1)
    h = net.conv_bn(ends.pop(raw_ep), "GroupingModule.Conv2d_score_1x1")
    raw = gap(conv(h, params["GroupingModule.Conv2d_score_logit.weight"], 1,
                   num, params["GroupingModule.Conv2d_score_logit.bias"]))
    if inside is not None:
        inside["raw"] = raw[:, 0]
    scores = torch.softmax(raw[:, 0].reshape(b, v), dim=-1)
    fused = group_and_fuse(scores, descs, model["num_group"])
    if keep is not None:
        fused = torch.where(keep, fused / model["dropout_keep_prob"],
                            torch.zeros((), device=fused.device))
    logits = linear(fused, params["Logits.weight"], params["Logits.bias"],
                    num)
    return logits, scores
