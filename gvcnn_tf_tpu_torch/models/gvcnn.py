"""GVCNN model assembly (counterpart of `gvcnn_tf_tpu/models/gvcnn.py`).

The view axis is folded into the batch: one (B*V) pass through the
backbone; the scoring FCN taps an early endpoint of the same pass; the
grouping head buckets, pools and fuses the views (ops/grouping_kernel.py:
the CUDA kernel on the card, the plain version on the CPU); a linear head
gives the logits.  `end_points` carries the reference names.

Dtypes follow the JAX module: the backbone and the scoring FCN run in
`config.compute_dtype`; the global average pools, the grouping head and the
`Logits` layer run in fp32.

Train mode (`model.train()`): every BatchNorm uses the batch's statistics
and updates its running statistics with decay `config.bn_momentum` (None:
slim's 0.9997), and dropout with keep probability
`config.dropout_keep_prob` acts on the fused descriptor before `Logits`.
Its mask comes from the `torch.Generator` the caller passes (the train step
seeds one from `train.seed` and the step); it cannot match JAX's stream.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from gvcnn_tf_tpu_torch.configs import GVCNNConfig
from gvcnn_tf_tpu_torch.metrics import log
from gvcnn_tf_tpu_torch.models.backbones import get_backbone
from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import (
    _TRUNC_STDDEV,
    BatchNorm,
    ConvBNReLU,
    Stem,
    trunc_normal_,
)
from gvcnn_tf_tpu_torch.ops.grouping import squash_scores
from gvcnn_tf_tpu_torch.ops.grouping_kernel import group_and_fuse


def _global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, C) mean over space."""
    return x.mean(dim=(2, 3))


def dropout(x: torch.Tensor, keep_prob: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax `nn.Dropout(rate=1 - keep_prob)` in train mode: keep each
    element with probability keep_prob and scale it by 1 / keep_prob."""
    if keep_prob >= 1.0:
        return x
    if keep_prob <= 0.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator "
                         "(forward(x, generator=...))")
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def _resolve_endpoints(cfg: GVCNNConfig, backbone_cls) -> Tuple[str, str]:
    """(raw_endpoint, final_endpoint) valid for the chosen backbone: an
    endpoint the backbone lacks, or a pair out of order, falls back to the
    backbone's defaults, as in the JAX package."""
    eps = backbone_cls.ENDPOINTS
    raw, fin = cfg.raw_endpoint, cfg.final_endpoint
    if raw not in eps:
        raw = backbone_cls.DEFAULT_RAW_ENDPOINT
    if fin not in eps:
        fin = backbone_cls.DEFAULT_FINAL_ENDPOINT
    if eps.index(raw) >= eps.index(fin):
        raw = backbone_cls.DEFAULT_RAW_ENDPOINT
        fin = backbone_cls.DEFAULT_FINAL_ENDPOINT
    return raw, fin


class GroupingModule(nn.Module):
    """View-discrimination FCN: 1x1 conv+BN+relu -> 1x1 conv to one channel
    -> global average pool -> one raw score per view.  The convs run in the
    compute dtype, the pool in fp32 (as `gvcnn.py:184-188, 108` do)."""

    def __init__(self, in_ch: int, hidden: int = 128):
        super().__init__()
        self.Conv2d_score_1x1 = ConvBNReLU(in_ch, hidden, (1, 1))
        self.Conv2d_score_logit = nn.Conv2d(hidden, 1, (1, 1), bias=True)

    def forward(self, raw_feats: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_score_1x1(raw_feats)
        logit = self.Conv2d_score_logit
        x = nn.functional.conv2d(x, logit.weight.to(x.dtype),
                                 logit.bias.to(x.dtype))
        return _global_avg_pool(x.float())[:, 0]                # (B*V,)


class GVCNN(nn.Module):
    """forward(x (B, V, H, W, 3) float) -> (logits (B, num_classes) fp32,
    end_points dict)."""

    def __init__(self, config: GVCNNConfig):
        super().__init__()
        self.config = config
        self.compute_dtype = getattr(torch, config.compute_dtype)
        backbone_cls = get_backbone(config.backbone)
        self.raw_endpoint, final_ep = _resolve_endpoints(config, backbone_cls)
        self.InceptionV1 = backbone_cls(final_endpoint=final_ep)
        self.GroupingModule = GroupingModule(
            backbone_cls.ENDPOINT_CHANNELS[self.raw_endpoint])
        self.Logits = nn.Linear(backbone_cls.ENDPOINT_CHANNELS[final_ep],
                                config.data.num_classes)
        if config.bn_momentum is not None:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.momentum = config.bn_momentum

    def cast_convs_(self) -> "GVCNN":
        """In place: store every conv weight in the compute dtype, so the
        per-call casts are no-ops.  BatchNorm and `Logits` stay fp32."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(self.compute_dtype)
        return self

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x (B, V, H, W, 3) -> (logits, end_points); `generator` draws the
        dropout mask in train mode."""
        cfg = self.config
        B, V = x.shape[:2]
        xf = x.reshape((B * V,) + tuple(x.shape[2:]))
        xf = xf.to(self.compute_dtype).contiguous()
        feats, endpoints = self.InceptionV1(xf)

        descs = _global_avg_pool(feats.float()).reshape(B, V, -1)  # fp32
        raw_scores = self.GroupingModule(
            endpoints[self.raw_endpoint]).reshape(B, V)
        scores = squash_scores(raw_scores, cfg.score_squash)
        fused, weights, scheme = group_and_fuse(
            scores.contiguous(), descs.contiguous(), cfg.num_group,
            cfg.group_weight)
        net = (dropout(fused, cfg.dropout_keep_prob, generator)
               if self.training else fused)
        logits = self.Logits(net)

        end_points: Dict[str, torch.Tensor] = {
            "view_descriptors": descs,
            "view_discrimination_scores": scores,
            "group_scheme": scheme,
            "group_weight": weights,
            "shape_descriptor": fused,
            "Logits": logits,
            "Predictions": torch.softmax(logits, dim=-1),
        }
        return logits, end_points


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's default kernel init: variance 1/fan_in, truncated normal."""
    return trunc_normal_(t, fan_in ** -0.5, generator)


@torch.no_grad()
def init_weights(model: GVCNN, seed: int) -> GVCNN:
    """In place: random weights from `seed`, with the distributions of the
    JAX package's initializers (the numbers differ: another generator).
    Conv kernels: truncated normal, stddev 0.09; score-logit conv and
    `Logits`: lecun normal; biases 0; BatchNorm mean 0, var 1."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (ConvBNReLU, Stem)):
            trunc_normal_(m.conv.weight, _TRUNC_STDDEV, g)
            m.BatchNorm.bias.zero_()
            m.BatchNorm.running_mean.zero_()
            m.BatchNorm.running_var.fill_(1.0)
    logit = model.GroupingModule.Conv2d_score_logit
    _lecun_normal_(logit.weight, logit.in_channels, g)
    logit.bias.zero_()
    _lecun_normal_(model.Logits.weight, model.Logits.in_features, g)
    model.Logits.bias.zero_()
    return model


def build_model(config: GVCNNConfig) -> GVCNN:
    """config -> GVCNN with fp32 parameters (uninitialised: see
    `init_weights` and `bridge.jax_to_state_dict`).

    Refuses what the port does not run yet instead of ignoring it."""
    if not config.multi_view:
        raise NotImplementedError(
            "the single-view classifier is not ported yet (ROADMAP §1 "
            "item 13, single-view model)")
    if config.model == "mvcnn":
        raise NotImplementedError(
            "MVCNN is not ported yet (ROADMAP §1 item 13, MVCNN)")
    if config.model != "gvcnn":
        raise ValueError(f"unknown model family {config.model!r}")
    if config.stem_space_to_depth:
        raise NotImplementedError(
            "--stem_space_to_depth is a TPU layout trick the port does not "
            "have (ROADMAP, 'Not ported'); the stem runs as its CUDA kernel")
    if config.remat_until or config.remat_backbone:
        raise NotImplementedError(
            "rematerialization (--remat_until, remat_backbone) is not ported "
            "(ROADMAP, 'Not ported'): the port keeps the activations")
    if config.merge_inception_branches != "none":
        log(f"merge_inception_branches={config.merge_inception_branches!r}: "
            "same math and parameters as unmerged; the port runs the "
            "branches unmerged")
    return GVCNN(config)
