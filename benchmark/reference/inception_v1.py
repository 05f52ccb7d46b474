"""Inception-v1 (GoogLeNet; Szegedy et al. 2015) at slim's widths, with
TF-'SAME' pads and BatchNorm after every conv (slim's inception_v1 with
batch_norm, eps 1e-3, no scale).  NCHW float32."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference.layers import ConvShape, Net, max_pool, out_hw

NAME = "InceptionV1"
BN_SCALE = False
BN_EPS = 1e-3
# Every conv and pool is TF-'SAME', so any input reaches every endpoint.
MIN_SIZE = 1

# (endpoint, spec) in order: ("conv", out, kernel, stride) | ("pool",
# kernel, stride) | ("mixed", b0, b1 reduce, b1, b2 reduce, b2, b3).
PLAN = (
    ("Conv2d_1a_7x7", ("conv", 64, 7, 2)),
    ("MaxPool_2a_3x3", ("pool", 3, 2)),
    ("Conv2d_2b_1x1", ("conv", 64, 1, 1)),
    ("Conv2d_2c_3x3", ("conv", 192, 3, 1)),
    ("MaxPool_3a_3x3", ("pool", 3, 2)),
    ("Mixed_3b", ("mixed", 64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", ("mixed", 128, 128, 192, 32, 96, 64)),
    ("MaxPool_4a_3x3", ("pool", 3, 2)),
    ("Mixed_4b", ("mixed", 192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", ("mixed", 160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", ("mixed", 128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", ("mixed", 112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", ("mixed", 256, 160, 320, 32, 128, 128)),
    ("MaxPool_5a_2x2", ("pool", 2, 2)),
    ("Mixed_5b", ("mixed", 256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", ("mixed", 384, 192, 384, 48, 128, 128)),
)


def channels(final: str) -> Dict[str, int]:
    """Output channels of each endpoint up to `final`."""
    out, ch = {}, 3
    for name, spec in PLAN:
        if spec[0] == "conv":
            ch = spec[1]
        elif spec[0] == "mixed":
            ch = spec[1] + spec[3] + spec[5] + spec[6]
        out[name] = ch
        if name == final:
            break
    return out


def conv_shapes(final: str, height: int, width: int):
    """`ConvShape` of every conv up to `final`, in order.  Every conv and
    pool is TF-'SAME': its output is ceil(input / stride)."""
    out, ch, h, w = [], 3, height, width
    for name, spec in PLAN:
        if spec[0] == "conv":
            _, cout, k, s = spec
            h, w = out_hw(h, w, k, s)
            out.append(ConvShape(f"{NAME}.{name}", ch, cout, (k, k), (s, s),
                                 (h, w)))
            ch = cout
        elif spec[0] == "pool":
            h, w = out_hw(h, w, spec[1], spec[2])
        else:
            b0, b1r, b1, b2r, b2, b3 = spec[1:]
            convs = (("Branch_0_Conv2d_0a_1x1", ch, b0, 1),
                     ("Branch_1_Conv2d_0a_1x1", ch, b1r, 1),
                     ("Branch_1_Conv2d_0b_3x3", b1r, b1, 3),
                     ("Branch_2_Conv2d_0a_1x1", ch, b2r, 1),
                     ("Branch_2_Conv2d_0b_3x3", b2r, b2, 3),
                     ("Branch_3_Conv2d_0b_1x1", ch, b3, 1))
            for br, i, o, k in convs:
                out.append(ConvShape(f"{NAME}.{name}.{br}", i, o, (k, k),
                                     (1, 1), (h, w)))
            ch = b0 + b1 + b2 + b3
        if name == final:
            break
    return out


def spatial(endpoint: str, height: int, width: int):
    """(H, W) of the activation at `endpoint`."""
    h, w = height, width
    for name, spec in PLAN:
        if spec[0] == "conv":
            h, w = out_hw(h, w, spec[2], spec[3])
        elif spec[0] == "pool":
            h, w = out_hw(h, w, spec[1], spec[2])
        if name == endpoint:
            return h, w
    raise ValueError(f"unknown endpoint {endpoint!r}")


def forward(net: Net, x: torch.Tensor, final: str, taps: Tuple[str, ...]):
    """x NCHW (N, 3, H, W) -> (features at `final`, {tap: activation})."""
    ends = {}
    for name, spec in PLAN:
        if spec[0] == "conv":
            x = net.conv_bn(x, f"{NAME}.{name}", stride=spec[3])
        elif spec[0] == "pool":
            x = max_pool(x, spec[1], spec[2])
        else:
            p = f"{NAME}.{name}"
            br0 = net.conv_bn(x, f"{p}.Branch_0_Conv2d_0a_1x1")
            br1 = net.conv_bn(net.conv_bn(x, f"{p}.Branch_1_Conv2d_0a_1x1"),
                              f"{p}.Branch_1_Conv2d_0b_3x3")
            br2 = net.conv_bn(net.conv_bn(x, f"{p}.Branch_2_Conv2d_0a_1x1"),
                              f"{p}.Branch_2_Conv2d_0b_3x3")
            br3 = net.conv_bn(max_pool(x, 3, 1), f"{p}.Branch_3_Conv2d_0b_1x1")
            x = torch.cat([br0, br1, br2, br3], dim=1)
        if name in taps:
            ends[name] = x
        if name == final:
            return x, ends
    raise ValueError(f"unknown endpoint {final!r}")
