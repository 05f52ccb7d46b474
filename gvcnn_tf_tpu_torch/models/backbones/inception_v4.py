"""Inception-v4 backbone (counterpart of
`gvcnn_tf_tpu/models/backbones/inception_v4.py`).

TF-Slim `inception_v4` structure, as the JAX module: a stem whose
reductions are 'VALID' (Conv2d_1a..2b, Mixed_3a, Mixed_4a, Mixed_5a), 4x
Inception-A (Mixed_5b-5e, 384 channels), Reduction-A (Mixed_6a), 7x
Inception-B (Mixed_6b-6h, 1024), Reduction-B (Mixed_7a), 3x Inception-C
(Mixed_7b-7d, 1536).  Every conv is `ConvBN` (conv + BN + ReLU, BN eps
1e-3 without a scale, decay 0.9997; kernels init lecun normal, Flax's
default); the pool branches of the A/B/C blocks are Flax's 3x3/1 'SAME'
average pool, which counts the padded zeros (`ops/pool.py::avg_pool`).  At
299 the net ends at 8x8x1536, at 224 at 5x5x1536; the smallest input that
reaches Mixed_7d is 75x75.

NHWC (N, H, W, 3) in; every layer runs on NCHW tensors (channels-last in
memory on the card); endpoints are NCHW.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from gvcnn_tf_tpu_torch.models.backbones.layers import ConvBN
from gvcnn_tf_tpu_torch.ops.pool import avg_pool, max_pool


def avg_pool3(x):
    return avg_pool(x, (3, 3), (1, 1))


def reduce_pool(x):
    return max_pool(x, (3, 3), (2, 2), "VALID")


class Towers(nn.Module):
    """A block of branch towers concatenated on channels.  `spec` lists,
    per branch, its input transform (None, or a pool) and its convs as
    (name, features, kernel, stride, padding); a branch may fork its last
    tower into several convs (Inception-C's 1x3 || 3x1), written as a tuple
    of convs in place of the last one."""

    def __init__(self, in_ch: int, spec: Sequence[Tuple]):
        super().__init__()
        self._branches: List[Tuple[Callable, List[str], List[str]]] = []
        for pre, convs in spec:
            trunk, fork, ch = [], [], in_ch
            for conv in convs:
                layers = conv if isinstance(conv[0], tuple) else (conv,)
                for name, feats, kernel, stride, padding in layers:
                    self.add_module(name, ConvBN(ch, feats, kernel,
                                                 (stride, stride), padding))
                if len(layers) > 1:
                    fork = [layer[0] for layer in layers]
                else:
                    trunk.append(layers[0][0])
                    ch = layers[0][1]
            self._branches.append((pre, trunk, fork))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_towers(lambda name: getattr(self, name), self._branches,
                          x)


def run_towers(get: Callable, branches, x: torch.Tensor) -> torch.Tensor:
    """The concatenated branch outputs of a `Towers` whose convs `get`
    returns by name."""
    outs = []
    for pre, trunk, fork in branches:
        y = x if pre is None else pre(x)
        for name in trunk:
            y = get(name)(y)
        if fork:
            outs.extend(get(name)(y) for name in fork)
        else:
            outs.append(y)
    return torch.cat(outs, dim=1)


def cs(name, feats, kernel, stride=1, padding="SAME"):
    """One conv of a `Towers` spec."""
    return (name, feats, kernel, stride, padding)


def inception_a(in_ch: int = 384) -> Towers:
    return Towers(in_ch, [
        (None, [cs("Branch_0_Conv2d_0a_1x1", 96, (1, 1))]),
        (None, [cs("Branch_1_Conv2d_0a_1x1", 64, (1, 1)),
                cs("Branch_1_Conv2d_0b_3x3", 96, (3, 3))]),
        (None, [cs("Branch_2_Conv2d_0a_1x1", 64, (1, 1)),
                cs("Branch_2_Conv2d_0b_3x3", 96, (3, 3)),
                cs("Branch_2_Conv2d_0c_3x3", 96, (3, 3))]),
        (avg_pool3, [cs("Branch_3_Conv2d_0b_1x1", 96, (1, 1))]),
    ])                                                          # 384


def reduction_a(in_ch: int = 384) -> Towers:
    return Towers(in_ch, [
        (None, [cs("Branch_0_Conv2d_1a_3x3", 384, (3, 3), 2, "VALID")]),
        (None, [cs("Branch_1_Conv2d_0a_1x1", 192, (1, 1)),
                cs("Branch_1_Conv2d_0b_3x3", 224, (3, 3)),
                cs("Branch_1_Conv2d_1a_3x3", 256, (3, 3), 2, "VALID")]),
        (reduce_pool, []),
    ])                                                          # 1024


def inception_b(in_ch: int = 1024) -> Towers:
    return Towers(in_ch, [
        (None, [cs("Branch_0_Conv2d_0a_1x1", 384, (1, 1))]),
        (None, [cs("Branch_1_Conv2d_0a_1x1", 192, (1, 1)),
                cs("Branch_1_Conv2d_0b_1x7", 224, (1, 7)),
                cs("Branch_1_Conv2d_0c_7x1", 256, (7, 1))]),
        (None, [cs("Branch_2_Conv2d_0a_1x1", 192, (1, 1)),
                cs("Branch_2_Conv2d_0b_7x1", 192, (7, 1)),
                cs("Branch_2_Conv2d_0c_1x7", 224, (1, 7)),
                cs("Branch_2_Conv2d_0d_7x1", 224, (7, 1)),
                cs("Branch_2_Conv2d_0e_1x7", 256, (1, 7))]),
        (avg_pool3, [cs("Branch_3_Conv2d_0b_1x1", 128, (1, 1))]),
    ])                                                          # 1024


def reduction_b(in_ch: int = 1024) -> Towers:
    return Towers(in_ch, [
        (None, [cs("Branch_0_Conv2d_0a_1x1", 192, (1, 1)),
                cs("Branch_0_Conv2d_1a_3x3", 192, (3, 3), 2, "VALID")]),
        (None, [cs("Branch_1_Conv2d_0a_1x1", 256, (1, 1)),
                cs("Branch_1_Conv2d_0b_1x7", 256, (1, 7)),
                cs("Branch_1_Conv2d_0c_7x1", 320, (7, 1)),
                cs("Branch_1_Conv2d_1a_3x3", 320, (3, 3), 2, "VALID")]),
        (reduce_pool, []),
    ])                                                          # 1536


def inception_c(in_ch: int = 1536) -> Towers:
    return Towers(in_ch, [
        (None, [cs("Branch_0_Conv2d_0a_1x1", 256, (1, 1))]),
        (None, [cs("Branch_1_Conv2d_0a_1x1", 384, (1, 1)),
                (cs("Branch_1_Conv2d_0b_1x3", 256, (1, 3)),
                 cs("Branch_1_Conv2d_0c_3x1", 256, (3, 1)))]),
        (None, [cs("Branch_2_Conv2d_0a_1x1", 384, (1, 1)),
                cs("Branch_2_Conv2d_0b_3x1", 448, (3, 1)),
                cs("Branch_2_Conv2d_0c_1x3", 512, (1, 3)),
                (cs("Branch_2_Conv2d_0d_1x3", 256, (1, 3)),
                 cs("Branch_2_Conv2d_0e_3x1", 256, (3, 1)))]),
        (avg_pool3, [cs("Branch_3_Conv2d_0b_1x1", 256, (1, 1))]),
    ])                                                          # 1536


def flat_towers(owner: nn.Module, prefix: str, towers: Towers) -> Callable:
    """Register `towers`' convs on `owner` as `<prefix>_<conv name>` (the
    JAX stem's flat scopes, e.g. `Mixed_4a_Branch_0_Conv2d_0a_1x1`) and
    return the block's forward."""
    for name, mod in list(towers.named_children()):
        owner.add_module(f"{prefix}_{name}", mod)
    return lambda x: run_towers(lambda n: getattr(owner, f"{prefix}_{n}"),
                                towers._branches, x)


ENDPOINTS = (
    "Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Mixed_3a",
    "Mixed_4a", "Mixed_5a",
    "Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_5e",
    "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_6f",
    "Mixed_6g", "Mixed_6h",
    "Mixed_7a", "Mixed_7b", "Mixed_7c", "Mixed_7d",
)

ENDPOINT_CHANNELS = {
    "Conv2d_1a_3x3": 32, "Conv2d_2a_3x3": 32, "Conv2d_2b_3x3": 64,
    "Mixed_3a": 160, "Mixed_4a": 192, "Mixed_5a": 384,
    **{f"Mixed_5{c}": 384 for c in "bcde"}, "Mixed_6a": 1024,
    **{f"Mixed_6{c}": 1024 for c in "bcdefgh"}, "Mixed_7a": 1536,
    **{f"Mixed_7{c}": 1536 for c in "bcd"},
}


class StagedBackbone(nn.Module):
    """A backbone run as a sequence of endpoints (Inception-v3 and v4):
    forward(x NHWC (N, H, W, 3)) -> (features NCHW, {endpoint: NCHW}), up
    to `final_endpoint`.  A subclass's `_build(name, in_ch)` registers the
    endpoint's modules and returns its forward."""

    ENDPOINTS: Tuple[str, ...] = ()
    ENDPOINT_CHANNELS: Dict[str, int] = {}

    def __init__(self, final_endpoint: str = None):
        super().__init__()
        final_endpoint = final_endpoint or self.DEFAULT_FINAL_ENDPOINT
        if final_endpoint not in self.ENDPOINTS:
            raise ValueError(f"unknown endpoint {final_endpoint!r}")
        self.final_endpoint = final_endpoint
        self._stages: List[Tuple[str, Callable]] = []
        ch = 3
        for name in self.ENDPOINTS[:self.ENDPOINTS.index(final_endpoint) + 1]:
            self._stages.append((name, self._build(name, ch)))
            ch = self.ENDPOINT_CHANNELS[name]

    def _build(self, name: str, ch: int) -> Callable:
        raise NotImplementedError

    def _conv(self, name, *args) -> Callable:
        self.add_module(name, ConvBN(*args))
        return getattr(self, name)

    def forward(self, x: torch.Tensor):
        net = x.permute(0, 3, 1, 2)
        endpoints: Dict[str, torch.Tensor] = {}
        for name, run in self._stages:
            net = endpoints[name] = run(net)
        return net, endpoints


class InceptionV4Base(StagedBackbone):
    """`inception_v4_base`."""

    NAME = "InceptionV4"
    DEFAULT_RAW_ENDPOINT = "Mixed_5e"
    DEFAULT_FINAL_ENDPOINT = "Mixed_7d"
    DESCRIPTOR_DIM = 1536
    ENDPOINTS = ENDPOINTS
    ENDPOINT_CHANNELS = ENDPOINT_CHANNELS
    KERNEL_INIT = "lecun_normal"

    def _build(self, name: str, ch: int) -> Callable:
        if name == "Conv2d_1a_3x3":
            return self._conv(name, ch, 32, (3, 3), (2, 2), "VALID")
        if name == "Conv2d_2a_3x3":
            return self._conv(name, ch, 32, (3, 3), (1, 1), "VALID")
        if name == "Conv2d_2b_3x3":
            return self._conv(name, ch, 64, (3, 3))
        if name == "Mixed_3a":            # max-pool || conv 96/2 VALID
            return flat_towers(self, name, Towers(ch, [
                (reduce_pool, []),
                (None, [cs("Branch_1_Conv2d_0a_3x3", 96, (3, 3), 2,
                           "VALID")])]))
        if name == "Mixed_4a":
            return flat_towers(self, name, Towers(ch, [
                (None, [cs("Branch_0_Conv2d_0a_1x1", 64, (1, 1)),
                        cs("Branch_0_Conv2d_1a_3x3", 96, (3, 3), 1,
                           "VALID")]),
                (None, [cs("Branch_1_Conv2d_0a_1x1", 64, (1, 1)),
                        cs("Branch_1_Conv2d_0b_1x7", 64, (1, 7)),
                        cs("Branch_1_Conv2d_0c_7x1", 64, (7, 1)),
                        cs("Branch_1_Conv2d_1a_3x3", 96, (3, 3), 1,
                           "VALID")])]))
        if name == "Mixed_5a":            # conv 192/2 VALID || max-pool
            return flat_towers(self, name, Towers(ch, [
                (None, [cs("Branch_0_Conv2d_1a_3x3", 192, (3, 3), 2,
                           "VALID")]),
                (reduce_pool, [])]))
        block = {"Mixed_5": inception_a, "Mixed_6": inception_b,
                 "Mixed_7": inception_c}[name[:7]]
        if name == "Mixed_6a":
            block = reduction_a
        elif name == "Mixed_7a":
            block = reduction_b
        self.add_module(name, block(ch))
        return getattr(self, name)
