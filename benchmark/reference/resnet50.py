"""ResNet-50 v1 (He et al. 2016, arXiv:1512.03385) as slim's resnet_v1_50:
a 7x7/2 conv + BN + ReLU and a 3x3/2 TF-'SAME' max-pool (endpoint
`conv1`), then bottleneck blocks [3, 4, 6, 3] of widths 64/128/256/512
whose stride (2, 2, 2, 1) sits on each block's LAST unit, post-activation
residuals, a projection shortcut (1x1 conv + BN) where the width or the
stride changes.  BatchNorm with a learned scale, eps 1e-5 (slim's
resnet_arg_scope).  NCHW float32."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.layers import ConvShape, Net, max_pool, out_hw

NAME = "ResNet50"
BN_SCALE = True
BN_EPS = 1e-5
# Every conv and pool is TF-'SAME', so any input reaches every endpoint.
MIN_SIZE = 1
BLOCKS = (("block1", 64, 3, 2), ("block2", 128, 4, 2),
          ("block3", 256, 6, 2), ("block4", 512, 3, 1))
ENDPOINTS = ("conv1",) + tuple(b[0] for b in BLOCKS)


def channels(final: str) -> Dict[str, int]:
    out = {"conv1": 64}
    for name, width, _, _ in BLOCKS:
        out[name] = 4 * width
    return {k: v for k, v in out.items()
            if ENDPOINTS.index(k) <= ENDPOINTS.index(final)}


def conv_shapes(final: str, height: int, width: int):
    """`ConvShape` of every conv up to `final`, in order.  Every conv and
    pool is TF-'SAME': its output is ceil(input / stride)."""
    h, w = out_hw(height, width, 7, 2)
    out = [ConvShape(f"{NAME}.conv1", 3, 64, (7, 7), (2, 2), (h, w))]
    h, w = out_hw(h, w, 3, 2)
    ch = 64
    for name, width_, units, stride in BLOCKS[:ENDPOINTS.index(final)]:
        for u in range(units):
            s = stride if u == units - 1 else 1
            unit = f"{NAME}.{name}_unit{u + 1}"
            ho, wo = out_hw(h, w, 1, s)
            if ch != 4 * width_ or s != 1:
                out.append(ConvShape(f"{unit}.shortcut", ch, 4 * width_,
                                     (1, 1), (s, s), (ho, wo)))
            out += [ConvShape(f"{unit}.conv1", ch, width_, (1, 1), (1, 1),
                              (h, w)),
                    ConvShape(f"{unit}.conv2", width_, width_, (3, 3),
                              (s, s), (ho, wo)),
                    ConvShape(f"{unit}.conv3", width_, 4 * width_, (1, 1),
                              (1, 1), (ho, wo))]
            h, w, ch = ho, wo, 4 * width_
    return out


def spatial(endpoint: str, height: int, width: int):
    """(H, W) of the activation at `endpoint`."""
    h, w = out_hw(*out_hw(height, width, 7, 2), 3, 2)   # conv1, the pool
    for _, _, _, stride in BLOCKS[:ENDPOINTS.index(endpoint)]:
        h, w = out_hw(h, w, 1, stride)
    return h, w


def forward(net: Net, x: torch.Tensor, final: str, taps: Tuple[str, ...]):
    """x NCHW (N, 3, H, W) -> (features at `final`, {tap: activation})."""
    x = max_pool(net.conv_bn(x, f"{NAME}.conv1", stride=2), 3, 2)
    ends = {"conv1": x} if "conv1" in taps else {}
    ch = 64
    for name, width, units, stride in BLOCKS[:ENDPOINTS.index(final)]:
        for u in range(units):
            s = stride if u == units - 1 else 1
            unit = f"{NAME}.{name}_unit{u + 1}"
            short = (net.conv_bn(x, f"{unit}.shortcut", s, relu=False)
                     if ch != 4 * width or s != 1 else x)
            y = net.conv_bn(x, f"{unit}.conv1")
            y = net.conv_bn(y, f"{unit}.conv2", s)
            y = net.conv_bn(y, f"{unit}.conv3", relu=False)
            x = F.relu(short + y)
            ch = 4 * width
        if name in taps:
            ends[name] = x
    return x, ends
