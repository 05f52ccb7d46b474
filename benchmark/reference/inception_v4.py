"""Inception-v4 (Szegedy et al. 2016, arXiv:1602.07261) as TF-Slim's
`inception_v4` base: a stem whose reductions are 'VALID' (Conv2d_1a-2b,
Mixed_3a, Mixed_4a, Mixed_5a), 4 Inception-A blocks (Mixed_5b-5e, 384
channels), Reduction-A (Mixed_6a), 7 Inception-B blocks (Mixed_6b-6h,
1024), Reduction-B (Mixed_7a) and 3 Inception-C blocks (Mixed_7b-7d,
1536), with factorized 1x7 / 7x1 and 1x3 / 3x1 convs.  Every conv is
followed by BatchNorm (eps 1e-3, no scale) and a ReLU.  At 299x299 the
net ends at 8x8x1536; 75x75 is the smallest input that reaches Mixed_7d.
NCHW float32.

One departure from TF-Slim: the 3x3/1 'SAME' average pools of the A, B
and C blocks count the padded zeros in every window's mean
(`count_include_pad=True`, as Flax's `avg_pool` and the program do), where
TF-Slim's `avg_pool2d` divides by the window's in-image size.  The two
differ only at the border windows; `correct` compares one function on both
sides.

Memory: a train step of 384 views at 299 in float32 would keep about
three full-size tensors a conv for the backward (60-75 GB).  So each
endpoint runs under `torch.utils.checkpoint` (non-reentrant), which keeps
only the endpoints' outputs and recomputes the rest in the backward, and
with gradients off just runs the endpoint.  That is exact: the recompute
runs the same operations on the same values, and the reference's
BatchNorm is a pure function that updates no running statistics."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.layers import (
    ConvShape, Net, avg_pool, max_pool, out_hw, pair)

NAME = "InceptionV4"
BN_SCALE = False
BN_EPS = 1e-3
MIN_SIZE = 75

# A branch's input transform: None, or a pool (kind, kernel, stride,
# padding).
AVG = ("avg", 3, 1, "SAME")
REDUCE = ("max", 3, 2, "VALID")


def _c(name, cout, kernel, stride=1, padding="SAME"):
    """One conv of a branch: (name, cout, (kh, kw), stride, padding)."""
    return (name, cout, pair(kernel), stride, padding)


# A block is a tuple of branches (pool or None, convs); a branch's last
# entry may be a tuple of convs that all read the one before and are
# concatenated (Inception-C's 1x3 || 3x1 forks).
BLOCK_A = (
    (None, (_c("Branch_0_Conv2d_0a_1x1", 96, 1),)),
    (None, (_c("Branch_1_Conv2d_0a_1x1", 64, 1),
            _c("Branch_1_Conv2d_0b_3x3", 96, 3))),
    (None, (_c("Branch_2_Conv2d_0a_1x1", 64, 1),
            _c("Branch_2_Conv2d_0b_3x3", 96, 3),
            _c("Branch_2_Conv2d_0c_3x3", 96, 3))),
    (AVG, (_c("Branch_3_Conv2d_0b_1x1", 96, 1),)),
)
REDUCTION_A = (
    (None, (_c("Branch_0_Conv2d_1a_3x3", 384, 3, 2, "VALID"),)),
    (None, (_c("Branch_1_Conv2d_0a_1x1", 192, 1),
            _c("Branch_1_Conv2d_0b_3x3", 224, 3),
            _c("Branch_1_Conv2d_1a_3x3", 256, 3, 2, "VALID"))),
    (REDUCE, ()),
)
BLOCK_B = (
    (None, (_c("Branch_0_Conv2d_0a_1x1", 384, 1),)),
    (None, (_c("Branch_1_Conv2d_0a_1x1", 192, 1),
            _c("Branch_1_Conv2d_0b_1x7", 224, (1, 7)),
            _c("Branch_1_Conv2d_0c_7x1", 256, (7, 1)))),
    (None, (_c("Branch_2_Conv2d_0a_1x1", 192, 1),
            _c("Branch_2_Conv2d_0b_7x1", 192, (7, 1)),
            _c("Branch_2_Conv2d_0c_1x7", 224, (1, 7)),
            _c("Branch_2_Conv2d_0d_7x1", 224, (7, 1)),
            _c("Branch_2_Conv2d_0e_1x7", 256, (1, 7)))),
    (AVG, (_c("Branch_3_Conv2d_0b_1x1", 128, 1),)),
)
REDUCTION_B = (
    (None, (_c("Branch_0_Conv2d_0a_1x1", 192, 1),
            _c("Branch_0_Conv2d_1a_3x3", 192, 3, 2, "VALID"))),
    (None, (_c("Branch_1_Conv2d_0a_1x1", 256, 1),
            _c("Branch_1_Conv2d_0b_1x7", 256, (1, 7)),
            _c("Branch_1_Conv2d_0c_7x1", 320, (7, 1)),
            _c("Branch_1_Conv2d_1a_3x3", 320, 3, 2, "VALID"))),
    (REDUCE, ()),
)
BLOCK_C = (
    (None, (_c("Branch_0_Conv2d_0a_1x1", 256, 1),)),
    (None, (_c("Branch_1_Conv2d_0a_1x1", 384, 1),
            (_c("Branch_1_Conv2d_0b_1x3", 256, (1, 3)),
             _c("Branch_1_Conv2d_0c_3x1", 256, (3, 1))))),
    (None, (_c("Branch_2_Conv2d_0a_1x1", 384, 1),
            _c("Branch_2_Conv2d_0b_3x1", 448, (3, 1)),
            _c("Branch_2_Conv2d_0c_1x3", 512, (1, 3)),
            (_c("Branch_2_Conv2d_0d_1x3", 256, (1, 3)),
             _c("Branch_2_Conv2d_0e_3x1", 256, (3, 1))))),
    (AVG, (_c("Branch_3_Conv2d_0b_1x1", 256, 1),)),
)

# (endpoint, a conv or a block, the separator between the endpoint and a
# branch conv's name in its parameters: the stem's blocks are flat scopes,
# `InceptionV4.Mixed_3a_Branch_1_...`, the others nested, `...Mixed_5b.`).
PLAN = (
    ("Conv2d_1a_3x3", _c("", 32, 3, 2, "VALID"), None),
    ("Conv2d_2a_3x3", _c("", 32, 3, 1, "VALID"), None),
    ("Conv2d_2b_3x3", _c("", 64, 3), None),
    ("Mixed_3a", ((REDUCE, ()),
                  (None, (_c("Branch_1_Conv2d_0a_3x3", 96, 3, 2,
                             "VALID"),))), "_"),
    ("Mixed_4a", ((None, (_c("Branch_0_Conv2d_0a_1x1", 64, 1),
                          _c("Branch_0_Conv2d_1a_3x3", 96, 3, 1, "VALID"))),
                  (None, (_c("Branch_1_Conv2d_0a_1x1", 64, 1),
                          _c("Branch_1_Conv2d_0b_1x7", 64, (1, 7)),
                          _c("Branch_1_Conv2d_0c_7x1", 64, (7, 1)),
                          _c("Branch_1_Conv2d_1a_3x3", 96, 3, 1,
                             "VALID")))), "_"),
    ("Mixed_5a", ((None, (_c("Branch_0_Conv2d_1a_3x3", 192, 3, 2,
                             "VALID"),)),
                  (REDUCE, ())), "_"),
    *((f"Mixed_5{c}", BLOCK_A, ".") for c in "bcde"),
    ("Mixed_6a", REDUCTION_A, "."),
    *((f"Mixed_6{c}", BLOCK_B, ".") for c in "bcdefgh"),
    ("Mixed_7a", REDUCTION_B, "."),
    *((f"Mixed_7{c}", BLOCK_C, ".") for c in "bcd"),
)
ENDPOINTS = tuple(name for name, _, _ in PLAN)


class PoolShape(NamedTuple):
    """One pool of the backbone: its endpoint, kind ("max" or "avg"),
    kernel and stride as (h, w) pairs, padding, channels, and the input
    and output (h, w)."""

    endpoint: str
    kind: str
    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    padding: str
    channels: int
    inp: Tuple[int, int]
    out: Tuple[int, int]


def _is_conv(spec) -> bool:
    return isinstance(spec[0], str)


def _plan(final: str):
    if final not in ENDPOINTS:
        raise ValueError(f"unknown endpoint {final!r}")
    return PLAN[:ENDPOINTS.index(final) + 1]


def _conv_name(endpoint, sep, conv) -> str:
    return (f"{NAME}.{endpoint}" if sep is None
            else f"{NAME}.{endpoint}{sep}{conv[0]}")


def _walk(final: str, height: int, width: int):
    """Every conv and pool up to `final` in the parameters' order, as
    ("conv", ConvShape) or ("pool", PoolShape), and each endpoint's
    ("end", endpoint, channels, (h, w))."""
    ch, h, w = 3, height, width
    for endpoint, spec, sep in _plan(final):
        if _is_conv(spec):
            spec = ((None, (spec,)),)
        outs = []
        for pre, convs in spec:
            bc, bh, bw = ch, h, w
            if pre is not None:
                kind, k, s, padding = pre
                oh, ow = out_hw(bh, bw, k, s, padding)
                yield "pool", PoolShape(endpoint, kind, pair(k), pair(s),
                                        padding, bc, (bh, bw), (oh, ow))
                bh, bw = oh, ow
            for conv in convs:
                for c in (conv if not _is_conv(conv) else (conv,)):
                    _, cout, k, s, padding = c
                    oh, ow = out_hw(bh, bw, k, s, padding)
                    yield "conv", ConvShape(_conv_name(endpoint, sep, c), bc,
                                            cout, k, pair(s), (oh, ow))
                if _is_conv(conv):
                    bc, bh, bw = conv[1], oh, ow
                else:                   # a fork: its convs concatenated
                    bc, bh, bw = sum(c[1] for c in conv), oh, ow
            outs.append((bc, bh, bw))
        if len({(oh, ow) for _, oh, ow in outs}) != 1:
            raise ValueError(f"{endpoint}'s branches disagree at "
                             f"{height}x{width}: {outs}")
        ch, h, w = sum(c for c, _, _ in outs), outs[0][1], outs[0][2]
        yield "end", endpoint, ch, (h, w)


def channels(final: str) -> Dict[str, int]:
    """Output channels of each endpoint up to `final` (at any size)."""
    return {item[1]: item[2] for item in _walk(final, MIN_SIZE, MIN_SIZE)
            if item[0] == "end"}


def conv_shapes(final: str, height: int, width: int) -> List[ConvShape]:
    """`ConvShape` of every conv up to `final`, in order, with the output
    size its own padding gives ('VALID': floor((size - k) / s) + 1)."""
    return [item[1] for item in _walk(final, height, width)
            if item[0] == "conv"]


def pool_shapes(final: str, height: int, width: int) -> List[PoolShape]:
    """`PoolShape` of every pool up to `final`, in order: the 'VALID'
    3x3/2 max pools of the reductions and the 3x3/1 'SAME' average pools
    of the A, B and C blocks."""
    return [item[1] for item in _walk(final, height, width)
            if item[0] == "pool"]


def spatial(endpoint: str, height: int, width: int):
    """(H, W) of the activation at `endpoint`."""
    for item in _walk(endpoint, height, width):
        if item[0] == "end" and item[1] == endpoint:
            return item[3]
    raise ValueError(f"unknown endpoint {endpoint!r}")


def _pool(x, pre):
    kind, k, s, padding = pre
    if kind == "max":
        return max_pool(x, k, s, padding)
    return avg_pool(x, k, s, padding, count_include_pad=True)


def _endpoint(net: Net, x: torch.Tensor, endpoint: str, spec, sep):
    if _is_conv(spec):
        _, _, k, s, padding = spec
        return net.conv_bn(x, _conv_name(endpoint, sep, spec), stride=s,
                           padding=padding)
    outs = []
    for pre, convs in spec:
        y = x if pre is None else _pool(x, pre)
        for conv in convs:
            if _is_conv(conv):
                y = net.conv_bn(y, _conv_name(endpoint, sep, conv),
                                stride=conv[3], padding=conv[4])
            else:
                outs.extend(net.conv_bn(y, _conv_name(endpoint, sep, c),
                                        stride=c[3], padding=c[4])
                            for c in conv)
                y = None
        if y is not None:
            outs.append(y)
    return torch.cat(outs, dim=1)


def forward(net: Net, x: torch.Tensor, final: str, taps: Tuple[str, ...]):
    """x NCHW (N, 3, H, W) -> (features at `final`, {tap: activation});
    each endpoint recomputed in the backward."""
    ends = {}
    for endpoint, spec, sep in _plan(final):
        x = checkpoint(_endpoint, net, x, endpoint, spec, sep,
                       use_reentrant=False)
        if endpoint in taps:
            ends[endpoint] = x
    return x, ends
