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
import importlib.util
import re
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from benchmark.reference.layers import Net, conv, gap, linear

SCORE_HIDDEN = 128
# The grouping head's BatchNorm epsilon, whatever the backbone's.
SCORE_BN_EPS = 1e-3
# What `backbone` requires of a backbone's module (`reference/__init__.py`).
INTERFACE = ("NAME", "BN_SCALE", "BN_EPS", "MIN_SIZE", "channels",
             "conv_shapes", "spatial", "forward")
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
_NOT_BACKBONES = frozenset({"gvcnn", "layers", "train", "__init__"})
_HERE = Path(__file__).resolve().parent


def _refuse(why: str):
    from benchmark.harness import Refused

    raise Refused(why)


def backbone(name: str):
    """The backbone module `benchmark/reference/<name>.py`, loaded once.
    A name outside the benchmark's name characters, one of the reference's
    own modules, a missing file or a module without the whole interface is
    refused (`harness.Refused`)."""
    if not isinstance(name, str) or not _NAME.fullmatch(name) \
            or name in _NOT_BACKBONES:
        _refuse(f"{name!r} cannot name a backbone")
    path = _HERE / f"{name}.py"
    if not path.is_file():
        _refuse(f"no reference backbone {path} for {name!r}")
    modname = f"{__package__}.{name}"
    mod = sys.modules.get(modname)
    if mod is None:
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[modname]
            raise
    missing = [a for a in INTERFACE if not hasattr(mod, a)]
    if missing:
        _refuse(f"the reference backbone {path} lacks {missing}")
    return mod


def param_spec(model: dict) -> "collections.OrderedDict[str, Tuple]":
    """{parameter or statistic name: (shape, role)} of the model a
    configuration file's `model` section describes, in a fixed order.
    Roles: conv, linear, score_logit, bias, bn_scale, bn_bias, bn_mean,
    bn_var.  A backbone conv without a BatchNorm (`ConvShape.bn` false)
    is its weight (conv) then its bias (bias)."""
    bb = backbone(model["backbone"])
    final, raw = model["final_endpoint"], model["raw_endpoint"]
    spec = collections.OrderedDict()

    def conv_layer(name, cin, cout, kernel, scaled, bn=True):
        spec[f"{name}.conv.weight"] = ((cout, cin) + tuple(kernel), "conv")
        if not bn:
            spec[f"{name}.conv.bias"] = ((cout,), "bias")
            return
        norm = f"{name}.BatchNorm"
        if scaled:
            spec[f"{norm}.scale"] = ((cout,), "bn_scale")
        spec[f"{norm}.bias"] = ((cout,), "bn_bias")
        spec[f"{norm}.running_mean"] = ((cout,), "bn_mean")
        spec[f"{norm}.running_var"] = ((cout,), "bn_var")

    for c in bb.conv_shapes(final, model["height"], model["width"]):
        conv_layer(c.name, c.cin, c.cout, c.kernel, bb.BN_SCALE, c.bn)
    ch = bb.channels(final)
    conv_layer("GroupingModule.Conv2d_score_1x1", ch[raw], SCORE_HIDDEN,
               (1, 1), False)
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
    bb = backbone(model["backbone"])
    x = normalize(views)
    b, v = x.shape[:2]
    x = x.reshape((b * v,) + tuple(x.shape[2:])).permute(0, 3, 1, 2)
    net = Net(params, mode, num, bb.BN_EPS)
    raw_ep = model["raw_endpoint"]
    feats, ends = bb.forward(net, x, model["final_endpoint"], (raw_ep,))
    descs = gap(feats).reshape(b, v, -1)
    h = net.conv_bn(ends.pop(raw_ep), "GroupingModule.Conv2d_score_1x1",
                    eps=SCORE_BN_EPS)
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
