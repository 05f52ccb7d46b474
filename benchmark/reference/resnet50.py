"""ResNet-50 v1 (He et al. 2016, arXiv:1512.03385) as slim's resnet_v1_50:
a 7x7/2 conv + BN + ReLU and a 3x3/2 TF-'SAME' max-pool (endpoint
`conv1`), then bottleneck blocks [3, 4, 6, 3] of widths 64/128/256/512
whose stride (2, 2, 2, 1) sits on each block's LAST unit, post-activation
residuals, a projection shortcut (1x1 conv + BN) where the width or the
stride changes.  BatchNorm with a learned scale, eps 1e-5.  NCHW float32."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.layers import Net, max_pool

NAME = "ResNet50"
EPS = 1e-5
BLOCKS = (("block1", 64, 3, 2), ("block2", 128, 4, 2),
          ("block3", 256, 6, 2), ("block4", 512, 3, 1))
ENDPOINTS = ("conv1",) + tuple(b[0] for b in BLOCKS)


def channels(final: str) -> Dict[str, int]:
    out = {"conv1": 64}
    for name, width, _, _ in BLOCKS:
        out[name] = 4 * width
    return {k: v for k, v in out.items()
            if ENDPOINTS.index(k) <= ENDPOINTS.index(final)}


def conv_shapes(final: str, height: int = 224, width: int = 224):
    """[(layer name, cin, cout, kernel, stride, input H, input W)] of every
    conv up to `final`; the layer's weight is `<name>.conv.weight`.  Every
    conv and pool is TF-'SAME': its output is ceil(input / stride)."""
    out = [(f"{NAME}.conv1", 3, 64, 7, 2, height, width)]
    h, w = spatial("conv1", height, width)
    ch = 64
    for name, width_, units, stride in BLOCKS[:ENDPOINTS.index(final)]:
        for u in range(units):
            s = stride if u == units - 1 else 1
            unit = f"{NAME}.{name}_unit{u + 1}"
            if ch != 4 * width_ or s != 1:
                out.append((f"{unit}.shortcut", ch, 4 * width_, 1, s, h, w))
            out += [(f"{unit}.conv1", ch, width_, 1, 1, h, w),
                    (f"{unit}.conv2", width_, width_, 3, s, h, w)]
            h, w = -(-h // s), -(-w // s)
            out.append((f"{unit}.conv3", width_, 4 * width_, 1, 1, h, w))
            ch = 4 * width_
    return out


def spatial(endpoint: str, height: int = 224, width: int = 224):
    """(H, W) of the activation at `endpoint`."""
    h, w = -(-height // 4), -(-width // 4)          # conv1, then the pool
    for _, _, _, stride in BLOCKS[:ENDPOINTS.index(endpoint)]:
        h, w = -(-h // stride), -(-w // stride)
    return h, w


def forward(net: Net, x: torch.Tensor, final: str, taps: Tuple[str, ...]):
    """x NCHW (N, 3, H, W) -> (features at `final`, {tap: activation})."""
    x = max_pool(net.conv_bn(x, f"{NAME}.conv1", stride=2, eps=EPS), 3, 2)
    ends = {"conv1": x} if "conv1" in taps else {}
    ch = 64
    for name, width, units, stride in BLOCKS[:ENDPOINTS.index(final)]:
        for u in range(units):
            s = stride if u == units - 1 else 1
            unit = f"{NAME}.{name}_unit{u + 1}"
            short = (net.conv_bn(x, f"{unit}.shortcut", s, relu=False,
                                 eps=EPS)
                     if ch != 4 * width or s != 1 else x)
            y = net.conv_bn(x, f"{unit}.conv1", eps=EPS)
            y = net.conv_bn(y, f"{unit}.conv2", s, eps=EPS)
            y = net.conv_bn(y, f"{unit}.conv3", relu=False, eps=EPS)
            x = F.relu(short + y)
            ch = 4 * width
        if name in taps:
            ends[name] = x
    return x, ends
