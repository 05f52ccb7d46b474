"""Model assembly (counterpart of `gvcnn_tf_tpu/models/gvcnn.py`): the
three families `build_model` picks from the config.

- `GVCNN`: the view axis is folded into the batch, one (B*V) pass through
  the backbone; the scoring FCN taps an early endpoint of the same pass;
  the grouping head buckets, pools and fuses the views
  (ops/grouping_kernel.py: the CUDA kernel on the card, the plain version
  on the CPU); a linear head gives the logits.
- `MVCNN` (the paper's baseline): the same fold, then an element-wise max
  over all the view descriptors; no scoring FCN, no grouping head.
- `SingleViewClassifier` (`multi_view=False`): one view (B, H, W, 3), or
  (B, 1, H, W, 3) as the data pipeline sends it; global average pool and
  `Logits`.

The backbone is any of the registry's (`config.backbone`), held under its
Flax scope name (`InceptionV1`, `ResNet50`, ...), so the state_dict keys
follow the JAX parameter tree.  `end_points` carries the reference names;
only GVCNN has `view_discrimination_scores`.

Dtypes follow the JAX modules: the backbone and the scoring FCN run in
`config.compute_dtype`; the global average pools, the grouping head, the
view max and the `Logits` layer run in fp32.

Train mode (`model.train()`): every BatchNorm uses the batch's statistics
and updates its running statistics with decay `config.bn_momentum` (None:
slim's 0.9997), and dropout with keep probability
`config.dropout_keep_prob` acts on the shape descriptor before `Logits`.
Its mask comes from the `torch.Generator` the caller passes (the train step
seeds one from `train.seed` and the step); it cannot match JAX's stream.
Under data parallelism with `bn_sync="global"`, `sync_batch_norm_` makes
every BatchNorm take its train-mode statistics over all ranks, and the
caller's `dropout_rows` places the rank's rows in the global batch's mask.

Rematerialization, as the JAX package's configs ask for it:
`config.remat_backbone` runs the backbone call as one `layers.remat` region
in train mode with grad enabled (inert in eval, serving and export, as
Flax's remat is at inference), and `config.remat_until` reaches the
backbones that have it (Inception-v1, as `_backbone_kwargs`; another
backbone runs without it, logged).  Either way the region hands back the
features and only the endpoint the model reads (GVCNN's raw tap).
"""

from __future__ import annotations

import inspect
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from gvcnn_tf_tpu_torch.configs import GVCNNConfig
from gvcnn_tf_tpu_torch.metrics import log
from gvcnn_tf_tpu_torch.models.backbones import get_backbone
from gvcnn_tf_tpu_torch.models.backbones.layers import (
    TRUNC_STDDEV,
    BatchNorm,
    ConvBN,
    lecun_normal_,
    remat,
    trunc_normal_,
)
from gvcnn_tf_tpu_torch.ops.grouping import squash_scores
from gvcnn_tf_tpu_torch.ops.grouping_kernel import group_and_fuse


def _global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, C) mean over space.  Taken over NHWC's (1, 2), the same
    reduction as over NCHW's (2, 3), so that the gradient of a channels-last
    x is channels-last too: the last block's BatchNorms then read their dy
    where it lies (`x.mean(dim=(2, 3))`'s backward gave an NCHW one)."""
    return x.permute(0, 2, 3, 1).mean(dim=(1, 2))


def dropout(x: torch.Tensor, keep_prob: float,
            generator: Optional[torch.Generator],
            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Flax `nn.Dropout(rate=1 - keep_prob)` in train mode: keep each
    element with probability keep_prob and scale it by 1 / keep_prob.

    `rows` (start, total): x holds rows [start, start + len(x)) of a batch
    of `total` rows spread over data-parallel ranks; the mask is drawn for
    the whole batch and this slice kept, so the ranks together drop what
    one process would on the whole batch (`bn_sync="global"`, as the JAX
    package draws one mask over the global batch)."""
    if keep_prob >= 1.0:
        return x
    if keep_prob <= 0.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator "
                         "(forward(x, generator=...))")
    start, total = rows or (0, x.shape[0])
    keep = torch.rand((total,) + tuple(x.shape[1:]), generator=generator,
                      device=x.device, dtype=torch.float32) < keep_prob
    keep = keep[start:start + x.shape[0]]
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def _backbone_kwargs(cfg: GVCNNConfig, backbone_cls, keep) -> dict:
    """The constructor options of the config's that the backbone has (the
    JAX package's `_backbone_kwargs`); `keep`: the endpoints the model
    reads.  Where the backbone lacks one, the JAX package drops it
    silently; the port logs the drop."""
    params = inspect.signature(backbone_cls.__init__).parameters
    kw = {}
    for field in ("remat_until", "stem_space_to_depth"):
        value = getattr(cfg, field)
        if not value:
            continue
        if field not in params:
            log(f"{field}={value!r}: the {backbone_cls.NAME} backbone has "
                "no such option; running without it, as the JAX package "
                "does")
            continue
        kw[field] = value
    if "remat_until" in kw:
        kw["keep"] = keep
    if kw.get("stem_space_to_depth"):
        log("stem_space_to_depth: same math and parameters; the stem runs "
            "as its kernel")
    return kw


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
        self.Conv2d_score_1x1 = ConvBN(in_ch, hidden, (1, 1))
        self.Conv2d_score_logit = nn.Conv2d(hidden, 1, (1, 1), bias=True)

    def forward(self, raw_feats: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_score_1x1(raw_feats)
        logit = self.Conv2d_score_logit
        x = nn.functional.conv2d(x, logit.weight.to(x.dtype),
                                 logit.bias.to(x.dtype))
        return _global_avg_pool(x.float())[:, 0]                # (B*V,)


class ViewModel(nn.Module):
    """What the three families share: the config's backbone under its Flax
    scope name, its endpoints, the compute dtype, the `bn_momentum`
    override, the cast of the convs and the backbone call with its remat.

    `READS_RAW_ENDPOINT`: whether the family reads the raw endpoint (GVCNN's
    scoring FCN), the one endpoint a remat region hands back."""

    READS_RAW_ENDPOINT = False

    def __init__(self, config: GVCNNConfig):
        super().__init__()
        self.config = config
        self.compute_dtype = getattr(torch, config.compute_dtype)
        backbone_cls = get_backbone(config.backbone)
        self.raw_endpoint, self.final_endpoint = _resolve_endpoints(
            config, backbone_cls)
        self._taps = ((self.raw_endpoint,) if self.READS_RAW_ENDPOINT
                      else ())
        self._backbone_name = backbone_cls.NAME
        self.add_module(backbone_cls.NAME, backbone_cls(
            final_endpoint=self.final_endpoint,
            **_backbone_kwargs(config, backbone_cls, self._taps)))

    @property
    def backbone(self) -> nn.Module:
        return getattr(self, self._backbone_name)

    def _backbone_taps(self, x: torch.Tensor):
        feats, endpoints = self.backbone(x)
        return feats, {n: endpoints[n] for n in self._taps}

    def _run_backbone(self, x: torch.Tensor):
        """(features, {endpoint: tensor} of the endpoints the model reads);
        one `remat` region with `config.remat_backbone` in train mode with
        grad enabled."""
        if (self.config.remat_backbone and self.training
                and torch.is_grad_enabled()
                and not torch.compiler.is_compiling()):
            return remat(self._backbone_taps, x)
        return self._backbone_taps(x)

    def _set_bn_momentum(self):
        """`config.bn_momentum`, where given, for every BatchNorm (the
        backbone's and the heads'), as `_backbone_kwargs` passes it."""
        if self.config.bn_momentum is not None:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.momentum = self.config.bn_momentum

    def cast_convs_(self) -> "ViewModel":
        """In place: store every conv weight in the compute dtype, so the
        per-call casts are no-ops.  BatchNorm and `Logits` stay fp32."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(self.compute_dtype)
        return self

    def _fold(self, x: torch.Tensor):
        """(B, V, H, W, 3) -> ((B*V, H, W, 3) contiguous in the compute
        dtype, B, V)."""
        B, V = x.shape[:2]
        xf = x.reshape((B * V,) + tuple(x.shape[2:]))
        return xf.to(self.compute_dtype).contiguous(), B, V

    def sync_batch_norm_(self, group) -> "ViewModel":
        """In place: every BatchNorm's train-mode statistics are summed over
        the ranks of `group` (None: each rank's own batch)."""
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.sync_group = group
        return self

    def _logits(self, net, generator, dropout_rows=None):
        if self.training:
            net = dropout(net, self.config.dropout_keep_prob, generator,
                          dropout_rows)
        return self.Logits(net)


class GVCNN(ViewModel):
    """forward(x (B, V, H, W, 3) float) -> (logits (B, num_classes) fp32,
    end_points dict)."""

    READS_RAW_ENDPOINT = True

    def __init__(self, config: GVCNNConfig):
        super().__init__(config)
        chans = self.backbone.ENDPOINT_CHANNELS
        self.GroupingModule = GroupingModule(chans[self.raw_endpoint])
        self.Logits = nn.Linear(chans[self.final_endpoint],
                                config.data.num_classes)
        self._set_bn_momentum()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dropout_rows: Optional[Tuple[int, int]] = None):
        """x (B, V, H, W, 3) -> (logits, end_points); `generator` draws the
        dropout mask in train mode (`dropout_rows`: see `dropout`)."""
        cfg = self.config
        xf, B, V = self._fold(x)
        feats, endpoints = self._run_backbone(xf)

        descs = _global_avg_pool(feats.float()).reshape(B, V, -1)  # fp32
        raw_scores = self.GroupingModule(
            endpoints[self.raw_endpoint]).reshape(B, V)
        scores = squash_scores(raw_scores, cfg.score_squash)
        fused, weights, scheme = group_and_fuse(
            scores.contiguous(), descs.contiguous(), cfg.num_group,
            cfg.group_weight)
        logits = self._logits(fused, generator, dropout_rows)

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


class MVCNN(ViewModel):
    """MVCNN (Su et al., ICCV 2015): the shared backbone over the folded
    views, an element-wise max over all V view descriptors (fp32), dropout
    and `Logits`.  forward(x (B, V, H, W, 3)) -> (logits, end_points)."""

    def __init__(self, config: GVCNNConfig):
        super().__init__(config)
        self.Logits = nn.Linear(
            self.backbone.ENDPOINT_CHANNELS[self.final_endpoint],
            config.data.num_classes)
        self._set_bn_momentum()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dropout_rows: Optional[Tuple[int, int]] = None):
        xf, B, V = self._fold(x)
        feats, _ = self._run_backbone(xf)
        descs = _global_avg_pool(feats.float()).reshape(B, V, -1)
        pooled = descs.amax(dim=1)                          # view pooling
        logits = self._logits(pooled, generator, dropout_rows)
        return logits, {
            "view_descriptors": descs,
            "shape_descriptor": pooled,
            "Logits": logits,
            "Predictions": torch.softmax(logits, dim=-1),
        }


class SingleViewClassifier(ViewModel):
    """BASELINE config 1: the backbone on one view, global average pool
    (fp32), dropout, `Logits` (slim's classification head).  forward(x
    (B, H, W, 3) or (B, 1, H, W, 3)) -> (logits, end_points)."""

    def __init__(self, config: GVCNNConfig):
        super().__init__(config)
        self.Logits = nn.Linear(
            self.backbone.ENDPOINT_CHANNELS[self.final_endpoint],
            config.data.num_classes)
        self._set_bn_momentum()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dropout_rows: Optional[Tuple[int, int]] = None):
        if x.dim() == 5:
            if x.shape[1] != 1:
                raise ValueError(f"the single-view classifier takes one "
                                 f"view, got {tuple(x.shape)}")
            x = x[:, 0]
        feats, _ = self._run_backbone(x.to(self.compute_dtype).contiguous())
        logits = self._logits(_global_avg_pool(feats.float()), generator,
                              dropout_rows)
        return logits, {"Logits": logits,
                        "Predictions": torch.softmax(logits, dim=-1)}


@torch.no_grad()
def init_weights(model: ViewModel, seed: int) -> ViewModel:
    """In place: random weights from `seed`, with the distributions of the
    JAX package's initializers (the numbers differ: another generator).
    Backbone convs: the family's (`KERNEL_INIT`: slim's truncated normal,
    stddev 0.09, for Inception-v1 and v2; lecun normal for v3, v4 and
    ResNet); the scoring FCN's 1x1 conv: truncated normal 0.09; the
    score-logit conv and `Logits`: lecun normal; biases 0 (slim's zeros,
    also a backbone conv's); BatchNorm scale 1, mean 0, var 1."""
    g = torch.Generator().manual_seed(seed)
    lecun = {id(m) for m in model.backbone.modules()
             if isinstance(m, nn.Conv2d)
             and model.backbone.KERNEL_INIT == "lecun_normal"}
    grouping = getattr(model, "GroupingModule", None)
    logit = None if grouping is None else grouping.Conv2d_score_logit
    for m in model.modules():
        if isinstance(m, nn.Conv2d) and m is not logit:
            if id(m) in lecun:
                lecun_normal_(m.weight, g)
            else:
                trunc_normal_(m.weight, TRUNC_STDDEV, g)
            if m.bias is not None:       # Inception-ResNet-v2's up convs
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset_()
    if logit is not None:
        lecun_normal_(logit.weight, g)
        logit.bias.zero_()
    lecun_normal_(model.Logits.weight, g)
    model.Logits.bias.zero_()
    return model


def to_device(model: ViewModel, device: torch.device) -> ViewModel:
    """In place: `model` on `device`, channels-last on a card (the layout
    of the cuDNN convs and of the stem kernel's NHWC output)."""
    return model.to(device, memory_format=(torch.channels_last
                                           if device.type == "cuda"
                                           else torch.preserve_format))


def build_model(config: GVCNNConfig) -> ViewModel:
    """config -> GVCNN, MVCNN or SingleViewClassifier with fp32 parameters
    (uninitialised: see `init_weights` and `bridge.jax_to_state_dict`), as
    the JAX package's `build_model` picks them.

    The data-parallel degree (`num_devices`) does not change the model:
    every rank builds the same one.  A layout option of the JAX package's
    that computes the same function is accepted and logged, and so are its
    Pallas switches (`stem_pallas`, `use_pallas_grouping`)."""
    for flag in ("stem_pallas", "use_pallas_grouping"):
        if getattr(config, flag):
            log(f"{flag}=True: the port has no switch for its kernels; a "
                "CUDA tensor always goes through the hand-written CUDA "
                "kernel and a CPU tensor through the plain version")
    if config.merge_inception_branches != "none":
        log(f"merge_inception_branches={config.merge_inception_branches!r}: "
            "same math and parameters as unmerged; the port runs the "
            "branches unmerged")
    if not config.multi_view:
        return SingleViewClassifier(config)
    if config.model == "mvcnn":
        return MVCNN(config)
    if config.model == "gvcnn":
        return GVCNN(config)
    raise ValueError(f"unknown model family {config.model!r}")
