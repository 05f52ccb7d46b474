"""Inception-v2 backbone (counterpart of
`gvcnn_tf_tpu/models/backbones/inception_v2.py`).

TF-Slim `inception_v2` structure, as the JAX module: the depthwise-separable
7x7/2 stem (`SeparableConvBNReLU`: a depthwise 7x7 with depth multiplier 8,
3 -> 24 channels, then a 1x1 projection to 64, then BN + ReLU), the v1-style
convs and TF-'SAME' max-pools, and the v2 Mixed blocks:
  normal block:   1x1 | 1x1->3x3 | 1x1->3x3->3x3 | pool->1x1
                  (a 3x3/1 average pool counting the padded zeros, as
                  Flax's; Mixed_5c takes a max-pool)
  stride-2 block: 1x1->3x3/2 | 1x1->3x3->3x3/2 | max-pool/2
At 224: Conv2d_1a_7x7 112x112x64 ... Mixed_3c 28x28x320, Mixed_4a
14x14x576, Mixed_5c 7x7x1024.  BN eps 1e-3 without a scale, decay 0.9997;
kernels (the depthwise and pointwise too) init slim's trunc_normal(0.09).

The depthwise conv is a grouped cuDNN conv (`groups=3`): in the JAX
package it is an `nn.Conv` with `feature_group_count`, not a Pallas kernel.

NHWC (N, H, W, 3) in; every layer runs on NCHW tensors (channels-last in
memory on the card); endpoints are NCHW.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn as nn

from gvcnn_tf_tpu_torch.models.backbones.inception_v4 import (
    StagedBackbone,
    Towers,
    avg_pool3,
    cs,
)
from gvcnn_tf_tpu_torch.models.backbones.layers import BatchNorm, conv2d_tf
from gvcnn_tf_tpu_torch.ops.pool import max_pool


class SeparableConvBNReLU(nn.Module):
    """slim.separable_conv2d + BN + relu: depthwise `kernel` conv with
    `depth_multiplier` outputs per input channel, pointwise 1x1 projection
    to `features`, BatchNorm, ReLU; TF-'SAME' padding, no biases."""

    def __init__(self, in_ch: int, features: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), depth_multiplier: int = 8):
        super().__init__()
        mid = in_ch * depth_multiplier
        self.depthwise = nn.Conv2d(in_ch, mid, kernel, stride=stride,
                                   groups=in_ch, bias=False)
        self.pointwise = nn.Conv2d(mid, features, (1, 1), bias=False)
        self.BatchNorm = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dw = self.depthwise
        x = conv2d_tf(x, dw.weight, dw.stride, groups=dw.groups)
        x = conv2d_tf(x, self.pointwise.weight, (1, 1))
        return self.BatchNorm(x, relu=True)


def _max_pool3(x):
    return max_pool(x, (3, 3), (1, 1))


def _max_pool3s2(x):
    return max_pool(x, (3, 3), (2, 2))


def mixed(in_ch, b0, b1r, b1, b2r, b2, b3, pool="avg") -> Towers:
    """Normal v2 Mixed block."""
    return Towers(in_ch, [
        (None, [cs("Branch_0_Conv2d_0a_1x1", b0, (1, 1))]),
        (None, [cs("Branch_1_Conv2d_0a_1x1", b1r, (1, 1)),
                cs("Branch_1_Conv2d_0b_3x3", b1, (3, 3))]),
        (None, [cs("Branch_2_Conv2d_0a_1x1", b2r, (1, 1)),
                cs("Branch_2_Conv2d_0b_3x3", b2, (3, 3)),
                cs("Branch_2_Conv2d_0c_3x3", b2, (3, 3))]),
        (avg_pool3 if pool == "avg" else _max_pool3,
         [cs("Branch_3_Conv2d_0b_1x1", b3, (1, 1))]),
    ])


def reduce(in_ch, b0r, b0, b1r, b1) -> Towers:
    """Stride-2 v2 block (Mixed_4a / Mixed_5a)."""
    return Towers(in_ch, [
        (None, [cs("Branch_0_Conv2d_0a_1x1", b0r, (1, 1)),
                cs("Branch_0_Conv2d_1a_3x3", b0, (3, 3), 2)]),
        (None, [cs("Branch_1_Conv2d_0a_1x1", b1r, (1, 1)),
                cs("Branch_1_Conv2d_0b_3x3", b1, (3, 3)),
                cs("Branch_1_Conv2d_1a_3x3", b1, (3, 3), 2)]),
        (_max_pool3s2, []),
    ])


# (endpoint, spec), as `_V2_PLAN` of the JAX module: ("sep", feats, kernel,
# stride) | ("conv", feats, kernel, stride) | ("pool", kernel, stride) |
# ("mixed", b0, b1r, b1, b2r, b2, b3, pool) | ("reduce", b0r, b0, b1r, b1).
_V2_PLAN: Sequence[Tuple[str, Tuple]] = (
    ("Conv2d_1a_7x7", ("sep", 64, (7, 7), (2, 2))),
    ("MaxPool_2a_3x3", ("pool", (3, 3), (2, 2))),
    ("Conv2d_2b_1x1", ("conv", 64, (1, 1), (1, 1))),
    ("Conv2d_2c_3x3", ("conv", 192, (3, 3), (1, 1))),
    ("MaxPool_3a_3x3", ("pool", (3, 3), (2, 2))),
    ("Mixed_3b", ("mixed", 64, 64, 64, 64, 96, 32, "avg")),
    ("Mixed_3c", ("mixed", 64, 64, 96, 64, 96, 64, "avg")),
    ("Mixed_4a", ("reduce", 128, 160, 64, 96)),
    ("Mixed_4b", ("mixed", 224, 64, 96, 96, 128, 128, "avg")),
    ("Mixed_4c", ("mixed", 192, 96, 128, 96, 128, 128, "avg")),
    ("Mixed_4d", ("mixed", 160, 128, 160, 128, 160, 96, "avg")),
    ("Mixed_4e", ("mixed", 96, 128, 192, 160, 192, 96, "avg")),
    ("Mixed_5a", ("reduce", 128, 192, 192, 256)),
    ("Mixed_5b", ("mixed", 352, 192, 320, 160, 224, 128, "avg")),
    ("Mixed_5c", ("mixed", 352, 192, 320, 192, 224, 128, "max")),
)

ENDPOINTS = tuple(name for name, _ in _V2_PLAN)

ENDPOINT_CHANNELS = {
    "Conv2d_1a_7x7": 64, "MaxPool_2a_3x3": 64, "Conv2d_2b_1x1": 64,
    "Conv2d_2c_3x3": 192, "MaxPool_3a_3x3": 192, "Mixed_3b": 256,
    "Mixed_3c": 320, "Mixed_4a": 576, "Mixed_4b": 576, "Mixed_4c": 576,
    "Mixed_4d": 576, "Mixed_4e": 576, "Mixed_5a": 1024, "Mixed_5b": 1024,
    "Mixed_5c": 1024,
}


class InceptionV2Base(StagedBackbone):
    """`inception_v2_base`."""

    NAME = "InceptionV2"
    DEFAULT_RAW_ENDPOINT = "Mixed_3c"
    DEFAULT_FINAL_ENDPOINT = "Mixed_5c"
    DESCRIPTOR_DIM = 1024
    ENDPOINTS = ENDPOINTS
    ENDPOINT_CHANNELS = ENDPOINT_CHANNELS
    KERNEL_INIT = "trunc_normal"      # slim's trunc_normal(0.09)

    def _build(self, name: str, ch: int) -> Callable:
        kind, *args = dict(_V2_PLAN)[name]
        if kind == "pool":
            return lambda x: max_pool(x, *args)
        if kind == "sep":
            self.add_module(name, SeparableConvBNReLU(ch, *args))
            return getattr(self, name)
        if kind == "conv":
            return self._conv(name, ch, *args)
        self.add_module(name, (mixed if kind == "mixed" else reduce)(ch,
                                                                    *args))
        return getattr(self, name)
