"""ResNet-50 (v1) backbone (counterpart of
`gvcnn_tf_tpu/models/backbones/resnet.py`).

TF-Slim `resnet_v1` conventions, as the JAX module: a 7x7/2 conv + BN +
ReLU and a 3x3/2 TF-'SAME' max-pool (endpoint `conv1`), then bottleneck
blocks [3, 4, 6, 3] of widths 64/128/256/512 (outputs 4x that) whose stride
(2, 2, 2, 1) is applied at the LAST unit of each block (slim's
`resnet_v1_block`; torchvision strides the first unit of the next stage):
at 224 `block1` is 28x28x256 and `block4` 7x7x2048.  Post-activation (v1)
residuals; a projection shortcut (1x1 conv + BN) wherever the width or the
stride changes.  BatchNorm with a learned scale, eps 1e-5, decay 0.997
(slim's resnet_arg_scope); kernels init lecun normal (Flax's default).

`conv1` is a cuDNN conv (`layers.conv2d_tf`): in the JAX package it is an
`nn.Conv`, not the Pallas stem kernel, so no hand-written kernel serves it.

NHWC (N, H, W, 3) in; every layer runs on NCHW tensors (channels-last in
memory on the card); endpoints are NCHW.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from gvcnn_tf_tpu_torch.models.backbones.layers import ConvBN
from gvcnn_tf_tpu_torch.ops.pool import max_pool

_BN = dict(eps=1e-5, momentum=0.997, use_scale=True)

# (endpoint, bottleneck width, units, stride of the last unit)
_BLOCKS = (("block1", 64, 3, 2), ("block2", 128, 4, 2),
           ("block3", 256, 6, 2), ("block4", 512, 3, 1))

ENDPOINTS = ("conv1",) + tuple(b[0] for b in _BLOCKS)
ENDPOINT_CHANNELS = {"conv1": 64, "block1": 256, "block2": 512,
                     "block3": 1024, "block4": 2048}


class Bottleneck(nn.Module):
    """v1 bottleneck: 1x1 reduce -> 3x3 (strided) -> 1x1 expand, then
    relu(shortcut + y): the shortcut goes into conv3's BatchNorm as its
    residual, which train mode adds and passes through the ReLU in its
    kernels (eval mode: `F.batch_norm`, the add, `F.relu`)."""

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        out_ch = 4 * width
        if in_ch != out_ch or stride != 1:
            self.shortcut = ConvBN(in_ch, out_ch, (1, 1), (stride, stride),
                                   relu=False, **_BN)
        else:
            self.shortcut = None
        self.conv1 = ConvBN(in_ch, width, (1, 1), **_BN)
        self.conv2 = ConvBN(width, width, (3, 3), (stride, stride), **_BN)
        self.conv3 = ConvBN(width, out_ch, (1, 1), **_BN)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return self.conv3(self.conv2(self.conv1(x)), residual=shortcut)


class ResNet50Base(nn.Module):
    """forward(x NHWC (N, H, W, 3)) -> (features NCHW, {endpoint: NCHW}),
    up to `final_endpoint`."""

    NAME = "ResNet50"
    DEFAULT_RAW_ENDPOINT = "block2"
    DEFAULT_FINAL_ENDPOINT = "block4"
    DESCRIPTOR_DIM = 2048
    ENDPOINTS = ENDPOINTS
    ENDPOINT_CHANNELS = ENDPOINT_CHANNELS
    KERNEL_INIT = "lecun_normal"

    def __init__(self, final_endpoint: str = "block4"):
        super().__init__()
        if final_endpoint not in ENDPOINTS:
            raise ValueError(f"unknown endpoint {final_endpoint!r}")
        self.final_endpoint = final_endpoint
        self.conv1 = ConvBN(3, 64, (7, 7), (2, 2), **_BN)
        self._blocks = []
        ch = 64
        for name, width, units, stride in _BLOCKS[
                :ENDPOINTS.index(final_endpoint)]:
            unit_names = []
            for u in range(units):
                unit = f"{name}_unit{u + 1}"
                self.add_module(unit, Bottleneck(
                    ch, width, stride if u == units - 1 else 1))
                unit_names.append(unit)
                ch = 4 * width
            self._blocks.append((name, unit_names))

    def forward(self, x: torch.Tensor):
        net = max_pool(self.conv1(x.permute(0, 3, 1, 2)), (3, 3), (2, 2))
        endpoints: Dict[str, torch.Tensor] = {"conv1": net}
        for name, units in self._blocks:
            for unit in units:
                net = getattr(self, unit)(net)
            endpoints[name] = net
        return net, endpoints
