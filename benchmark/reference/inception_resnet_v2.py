"""Inception-ResNet-v2 (Szegedy et al. 2016, arXiv:1602.07261) as TF-Slim's
`inception_resnet_v2_base` (output_stride 32): a stem whose reductions are
'VALID' (Conv2d_1a-4a and two 3x3/2 max pools), Mixed_5b (35x35x320), 10
block35 (scale 0.17), Mixed_6a (17x17x1088), 20 block17 (0.10), Mixed_7a
(8x8x2080), 9 block8 (0.20), a last block8 (`Block8`: scale 1, no ReLU)
and Conv2d_7b_1x1 (1536).  A residual block concatenates its branches,
brings them back to its input's width with a 1x1 conv that has a bias and
no BatchNorm (`Net.conv_bias`), and joins: x + scale * up, then a ReLU
where slim applies one.  Every other conv is followed by BatchNorm (eps
1e-3, no scale) and a ReLU.  At 299x299 the net ends at 8x8x1536; 75x75 is
the smallest input that reaches Conv2d_7b_1x1.  NCHW float32.

Endpoints: slim's, and `Repeat` (the output of the 10 block35s, 35x35x320;
slim's scope of them, where it registers no endpoint), which the scoring
FCN taps.  Parameter names follow slim's scopes in dotted form:
`InceptionResnetV2.Repeat.block35_1.Branch_2_Conv2d_0b_3x3.conv.weight`,
`InceptionResnetV2.Repeat.block35_1.Conv2d_1x1.conv.bias`.

One departure from TF-Slim, as in the Inception-v4 reference: Mixed_5b's
3x3/1 'SAME' average pool counts the padded zeros in every window's mean
(`count_include_pad=True`, as Flax's `avg_pool` and the program compute
it), where TF-Slim's `avg_pool2d` divides by the window's in-image size.
The two differ only at the border windows; `correct` compares one function
on both sides.

Memory: a float32 train step of 384 views at 299 would keep several
full-size tensors a conv for the backward, and an endpoint of 20 block17s
recomputed whole would keep on the order of 80 GB.  So every unit (each
stem layer, each Mixed block and each residual block) runs under
`torch.utils.checkpoint` (non-reentrant), which keeps only the units'
inputs and recomputes the rest in the backward, and with gradients off
just runs the unit.  That is exact: the recompute runs the same operations
on the same values, and the reference's BatchNorm is a pure function that
updates no running statistics."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.layers import (
    ConvShape, Net, avg_pool, max_pool, out_hw, pair)

NAME = "InceptionResnetV2"
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


# A block is a tuple of branches (pool or None, convs), concatenated.
MIXED_5B = (
    (None, (_c("Branch_0_Conv2d_1x1", 96, 1),)),
    (None, (_c("Branch_1_Conv2d_0a_1x1", 48, 1),
            _c("Branch_1_Conv2d_0b_5x5", 64, 5))),
    (None, (_c("Branch_2_Conv2d_0a_1x1", 64, 1),
            _c("Branch_2_Conv2d_0b_3x3", 96, 3),
            _c("Branch_2_Conv2d_0c_3x3", 96, 3))),
    (AVG, (_c("Branch_3_Conv2d_0b_1x1", 64, 1),)),
)
BLOCK35 = (
    (None, (_c("Branch_0_Conv2d_1x1", 32, 1),)),
    (None, (_c("Branch_1_Conv2d_0a_1x1", 32, 1),
            _c("Branch_1_Conv2d_0b_3x3", 32, 3))),
    (None, (_c("Branch_2_Conv2d_0a_1x1", 32, 1),
            _c("Branch_2_Conv2d_0b_3x3", 48, 3),
            _c("Branch_2_Conv2d_0c_3x3", 64, 3))),
)
MIXED_6A = (
    (None, (_c("Branch_0_Conv2d_1a_3x3", 384, 3, 2, "VALID"),)),
    (None, (_c("Branch_1_Conv2d_0a_1x1", 256, 1),
            _c("Branch_1_Conv2d_0b_3x3", 256, 3),
            _c("Branch_1_Conv2d_1a_3x3", 384, 3, 2, "VALID"))),
    (REDUCE, ()),
)
BLOCK17 = (
    (None, (_c("Branch_0_Conv2d_1x1", 192, 1),)),
    (None, (_c("Branch_1_Conv2d_0a_1x1", 128, 1),
            _c("Branch_1_Conv2d_0b_1x7", 160, (1, 7)),
            _c("Branch_1_Conv2d_0c_7x1", 192, (7, 1)))),
)
MIXED_7A = (
    (None, (_c("Branch_0_Conv2d_0a_1x1", 256, 1),
            _c("Branch_0_Conv2d_1a_3x3", 384, 3, 2, "VALID"))),
    (None, (_c("Branch_1_Conv2d_0a_1x1", 256, 1),
            _c("Branch_1_Conv2d_1a_3x3", 288, 3, 2, "VALID"))),
    (None, (_c("Branch_2_Conv2d_0a_1x1", 256, 1),
            _c("Branch_2_Conv2d_0b_3x3", 288, 3),
            _c("Branch_2_Conv2d_1a_3x3", 320, 3, 2, "VALID"))),
    (REDUCE, ()),
)
BLOCK8 = (
    (None, (_c("Branch_0_Conv2d_1x1", 192, 1),)),
    (None, (_c("Branch_1_Conv2d_0a_1x1", 192, 1),
            _c("Branch_1_Conv2d_0b_1x3", 224, (1, 3)),
            _c("Branch_1_Conv2d_0c_3x1", 256, (3, 1)))),
)


def _repeat(scope, block, count, branches, scale):
    return tuple(("residual", f"{scope}.{block}_{i}", branches, scale, True)
                 for i in range(1, count + 1))


# (endpoint, its units in order).  A unit is ("conv", scope, conv),
# ("pool", pool), ("towers", scope, branches) or ("residual", scope,
# branches, scale, relu); each is recomputed in the backward on its own.
PLAN = (
    ("Conv2d_1a_3x3", (("conv", "Conv2d_1a_3x3",
                        _c("", 32, 3, 2, "VALID")),)),
    ("Conv2d_2a_3x3", (("conv", "Conv2d_2a_3x3",
                        _c("", 32, 3, 1, "VALID")),)),
    ("Conv2d_2b_3x3", (("conv", "Conv2d_2b_3x3", _c("", 64, 3)),)),
    ("MaxPool_3a_3x3", (("pool", REDUCE),)),
    ("Conv2d_3b_1x1", (("conv", "Conv2d_3b_1x1",
                        _c("", 80, 1, 1, "VALID")),)),
    ("Conv2d_4a_3x3", (("conv", "Conv2d_4a_3x3",
                        _c("", 192, 3, 1, "VALID")),)),
    ("MaxPool_5a_3x3", (("pool", REDUCE),)),
    ("Mixed_5b", (("towers", "Mixed_5b", MIXED_5B),)),
    ("Repeat", _repeat("Repeat", "block35", 10, BLOCK35, 0.17)),
    ("Mixed_6a", (("towers", "Mixed_6a", MIXED_6A),)),
    ("PreAuxLogits", _repeat("Repeat_1", "block17", 20, BLOCK17, 0.10)),
    ("Mixed_7a", (("towers", "Mixed_7a", MIXED_7A),)),
    ("Conv2d_7b_1x1", _repeat("Repeat_2", "block8", 9, BLOCK8, 0.20) + (
        ("residual", "Block8", BLOCK8, 1.0, False),
        ("conv", "Conv2d_7b_1x1", _c("", 1536, 1)))),
)
ENDPOINTS = tuple(name for name, _ in PLAN)


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


class JoinShape(NamedTuple):
    """One residual join x + scale * up of the backbone: its block's scope,
    the channels and (h, w) of x, up and the result, the scale, and whether
    a ReLU follows."""

    name: str
    channels: int
    hw: Tuple[int, int]
    scale: float
    relu: bool


def _plan(final: str):
    if final not in ENDPOINTS:
        raise ValueError(f"unknown endpoint {final!r}")
    return PLAN[:ENDPOINTS.index(final) + 1]


def _towers(endpoint, scope, branches, ch, h, w):
    """The pools and convs of concatenated `branches` over (ch, h, w), as
    `_walk` yields them, then ("out", channels, (h, w))."""
    outs = []
    for pre, convs in branches:
        bc, bh, bw = ch, h, w
        if pre is not None:
            kind, k, s, padding = pre
            oh, ow = out_hw(bh, bw, k, s, padding)
            yield "pool", PoolShape(endpoint, kind, pair(k), pair(s),
                                    padding, bc, (bh, bw), (oh, ow))
            bh, bw = oh, ow
        for name, cout, k, s, padding in convs:
            oh, ow = out_hw(bh, bw, k, s, padding)
            yield "conv", ConvShape(f"{NAME}.{scope}.{name}", bc, cout, k,
                                    pair(s), (oh, ow))
            bc, bh, bw = cout, oh, ow
        outs.append((bc, bh, bw))
    if len({(oh, ow) for _, oh, ow in outs}) != 1:
        raise ValueError(f"{scope}'s branches disagree at {h}x{w}: {outs}")
    yield "out", sum(c for c, _, _ in outs), outs[0][1:]


def _walk(final: str, height: int, width: int):
    """Every conv, pool and join up to `final` in the parameters' order, as
    ("conv", ConvShape), ("pool", PoolShape) or ("join", JoinShape), and
    each endpoint's ("end", endpoint, channels, (h, w))."""
    ch, h, w = 3, height, width
    for endpoint, units in _plan(final):
        for unit in units:
            if unit[0] == "conv":
                _, scope, (_, cout, k, s, padding) = unit
                oh, ow = out_hw(h, w, k, s, padding)
                yield "conv", ConvShape(f"{NAME}.{scope}", ch, cout, k,
                                        pair(s), (oh, ow))
                ch, h, w = cout, oh, ow
            elif unit[0] == "pool":
                kind, k, s, padding = unit[1]
                oh, ow = out_hw(h, w, k, s, padding)
                yield "pool", PoolShape(endpoint, kind, pair(k), pair(s),
                                        padding, ch, (h, w), (oh, ow))
                h, w = oh, ow
            else:
                scope, branches = unit[1], unit[2]
                for item in _towers(endpoint, scope, branches, ch, h, w):
                    if item[0] != "out":
                        yield item
                mixed = item[1]
                if unit[0] == "towers":
                    ch, (h, w) = mixed, item[2]
                    continue
                yield "conv", ConvShape(f"{NAME}.{scope}.Conv2d_1x1", mixed,
                                        ch, (1, 1), (1, 1), (h, w), bn=False)
                yield "join", JoinShape(scope, ch, (h, w), unit[3], unit[4])
        yield "end", endpoint, ch, (h, w)


def channels(final: str) -> Dict[str, int]:
    """Output channels of each endpoint up to `final` (at any size)."""
    return {item[1]: item[2] for item in _walk(final, MIN_SIZE, MIN_SIZE)
            if item[0] == "end"}


def conv_shapes(final: str, height: int, width: int) -> List[ConvShape]:
    """`ConvShape` of every conv up to `final`, in order, with the output
    size its own padding gives ('VALID': floor((size - k) / s) + 1); the
    residual blocks' up convs have `bn` false."""
    return [item[1] for item in _walk(final, height, width)
            if item[0] == "conv"]


def pool_shapes(final: str, height: int, width: int) -> List[PoolShape]:
    """`PoolShape` of every pool up to `final`, in order: the 'VALID' 3x3/2
    max pools of the stem and the reductions, and Mixed_5b's 3x3/1 'SAME'
    average pool."""
    return [item[1] for item in _walk(final, height, width)
            if item[0] == "pool"]


def join_shapes(final: str, height: int, width: int) -> List[JoinShape]:
    """`JoinShape` of every residual join up to `final`, in order: 10
    block35, 20 block17, 9 block8 and `Block8` through Conv2d_7b_1x1."""
    return [item[1] for item in _walk(final, height, width)
            if item[0] == "join"]


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


def _concat(net: Net, x: torch.Tensor, scope: str, branches):
    outs = []
    for pre, convs in branches:
        y = x if pre is None else _pool(x, pre)
        for name, _, _, s, padding in convs:
            y = net.conv_bn(y, f"{NAME}.{scope}.{name}", stride=s,
                            padding=padding)
        outs.append(y)
    return torch.cat(outs, dim=1)


def _unit(net: Net, x: torch.Tensor, unit) -> torch.Tensor:
    if unit[0] == "conv":
        _, scope, (_, _, _, s, padding) = unit
        return net.conv_bn(x, f"{NAME}.{scope}", stride=s, padding=padding)
    if unit[0] == "pool":
        return _pool(x, unit[1])
    mixed = _concat(net, x, unit[1], unit[2])
    if unit[0] == "towers":
        return mixed
    _, scope, _, scale, relu = unit
    up = net.conv_bias(mixed, f"{NAME}.{scope}.Conv2d_1x1")
    y = x + scale * up
    return torch.relu(y) if relu else y


def forward(net: Net, x: torch.Tensor, final: str, taps: Tuple[str, ...]):
    """x NCHW (N, 3, H, W) -> (features at `final`, {tap: activation});
    each unit recomputed in the backward."""
    ends = {}
    for endpoint, units in _plan(final):
        for unit in units:
            x = checkpoint(_unit, net, x, unit, use_reentrant=False)
        if endpoint in taps:
            ends[endpoint] = x
    return x, ends
