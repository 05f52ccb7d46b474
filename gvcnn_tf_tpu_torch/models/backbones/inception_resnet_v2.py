"""Inception-ResNet-v2 backbone (Szegedy et al. 2016, arXiv:1602.07261), as
TF-Slim's `inception_resnet_v2_base`.  The port has it alone: the JAX
package has no such backbone.

A stem whose reductions are 'VALID' (Conv2d_1a-4a, two 3x3/2 max pools),
Mixed_5b (35x35x320), 10 block35 (scale 0.17), Mixed_6a (17x17x1088), 20
block17 (0.10), Mixed_7a (8x8x2080), 9 block8 (0.20), a last block8
(`Block8`: scale 1, no ReLU) and Conv2d_7b_1x1 (1536).  A residual block's
branches are concatenated and a 1x1 "up" conv with a bias and no BatchNorm
brings them back to the input's width; the block's output is
relu?(x + scale * up), the conv run without its bias (`layers.ConvBias`)
and the bias, scale, add and ReLU one op (`ops/residual_join.py`).  Every
other conv is `ConvBN` (conv + BN + ReLU, BN eps 1e-3 without a scale,
decay 0.9997; kernels init lecun normal, as the port's other Inception
backbones);
Mixed_5b's pool branch is the 3x3/1 'SAME' average pool that counts the
padded zeros (`ops/pool.py::avg_pool`), as the port's v4 computes its pools.

Endpoints: slim's (Conv2d_1a_3x3 .. MaxPool_5a_3x3, Mixed_5b, Mixed_6a,
PreAuxLogits after the block17s, Mixed_7a, Conv2d_7b_1x1) and one the port
adds, `Repeat`, the output of the 10 block35s (35x35x320; `Repeat` is
slim's scope of them), which the scoring FCN taps as v4's Mixed_5e.
Parameters follow slim's scopes: `Repeat.block35_1`, `Repeat_1.block17_1`,
`Repeat_2.block8_1`, `Block8`, a branch's conv as
`Branch_<i>_<conv>` and the up conv as `Conv2d_1x1` (e.g.
`InceptionResnetV2.Repeat.block35_1.Conv2d_1x1.conv.bias`).  At 299 the
net ends at 8x8x1536; the smallest input that reaches Conv2d_7b_1x1 is
75x75.

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
    reduce_pool,
)
from gvcnn_tf_tpu_torch.models.backbones.layers import ConvBias
from gvcnn_tf_tpu_torch.ops.residual_join import residual_join

BLOCK35 = [
    (None, [cs("Branch_0_Conv2d_1x1", 32, (1, 1))]),
    (None, [cs("Branch_1_Conv2d_0a_1x1", 32, (1, 1)),
            cs("Branch_1_Conv2d_0b_3x3", 32, (3, 3))]),
    (None, [cs("Branch_2_Conv2d_0a_1x1", 32, (1, 1)),
            cs("Branch_2_Conv2d_0b_3x3", 48, (3, 3)),
            cs("Branch_2_Conv2d_0c_3x3", 64, (3, 3))]),
]                                                               # 128 -> 320
BLOCK17 = [
    (None, [cs("Branch_0_Conv2d_1x1", 192, (1, 1))]),
    (None, [cs("Branch_1_Conv2d_0a_1x1", 128, (1, 1)),
            cs("Branch_1_Conv2d_0b_1x7", 160, (1, 7)),
            cs("Branch_1_Conv2d_0c_7x1", 192, (7, 1))]),
]                                                               # 384 -> 1088
BLOCK8 = [
    (None, [cs("Branch_0_Conv2d_1x1", 192, (1, 1))]),
    (None, [cs("Branch_1_Conv2d_0a_1x1", 192, (1, 1)),
            cs("Branch_1_Conv2d_0b_1x3", 224, (1, 3)),
            cs("Branch_1_Conv2d_0c_3x1", 256, (3, 1))]),
]                                                               # 448 -> 2080


class Residual(Towers):
    """slim's block35 / block17 / block8: the branch towers concatenated,
    the 1x1 up conv (`Conv2d_1x1`, a bias and no BatchNorm) back to the
    input's width, and the join relu?(x + scale * up)."""

    def __init__(self, ch: int, spec: Sequence[Tuple], scale: float,
                 relu: bool = True):
        super().__init__(ch, spec)
        self.scale, self.relu = scale, relu
        mixed = sum(convs[-1][1] for _, convs in spec)
        self.Conv2d_1x1 = ConvBias(mixed, ch, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self.Conv2d_1x1
        return residual_join(x, up(super().forward(x)), up.bias, self.scale,
                             self.relu)


class Repeat(nn.Sequential):
    """slim.repeat(net, count, block): `<block>_1` .. `<block>_<count>`."""

    def __init__(self, ch: int, block: str, count: int, spec, scale: float):
        super().__init__()
        for i in range(1, count + 1):
            self.add_module(f"{block}_{i}", Residual(ch, spec, scale))


ENDPOINTS = (
    "Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "MaxPool_3a_3x3",
    "Conv2d_3b_1x1", "Conv2d_4a_3x3", "MaxPool_5a_3x3", "Mixed_5b",
    "Repeat", "Mixed_6a", "PreAuxLogits", "Mixed_7a", "Conv2d_7b_1x1",
)

ENDPOINT_CHANNELS = {
    "Conv2d_1a_3x3": 32, "Conv2d_2a_3x3": 32, "Conv2d_2b_3x3": 64,
    "MaxPool_3a_3x3": 64, "Conv2d_3b_1x1": 80, "Conv2d_4a_3x3": 192,
    "MaxPool_5a_3x3": 192, "Mixed_5b": 320, "Repeat": 320,
    "Mixed_6a": 1088, "PreAuxLogits": 1088, "Mixed_7a": 2080,
    "Conv2d_7b_1x1": 1536,
}


class InceptionResNetV2Base(StagedBackbone):
    """`inception_resnet_v2_base` (output_stride 32, 'VALID' reductions)."""

    NAME = "InceptionResnetV2"
    DEFAULT_RAW_ENDPOINT = "Repeat"
    DEFAULT_FINAL_ENDPOINT = "Conv2d_7b_1x1"
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
        if name in ("MaxPool_3a_3x3", "MaxPool_5a_3x3"):
            return reduce_pool
        if name == "Conv2d_3b_1x1":
            return self._conv(name, ch, 80, (1, 1), (1, 1), "VALID")
        if name == "Conv2d_4a_3x3":
            return self._conv(name, ch, 192, (3, 3), (1, 1), "VALID")
        if name == "Mixed_5b":
            self.Mixed_5b = Towers(ch, [
                (None, [cs("Branch_0_Conv2d_1x1", 96, (1, 1))]),
                (None, [cs("Branch_1_Conv2d_0a_1x1", 48, (1, 1)),
                        cs("Branch_1_Conv2d_0b_5x5", 64, (5, 5))]),
                (None, [cs("Branch_2_Conv2d_0a_1x1", 64, (1, 1)),
                        cs("Branch_2_Conv2d_0b_3x3", 96, (3, 3)),
                        cs("Branch_2_Conv2d_0c_3x3", 96, (3, 3))]),
                (avg_pool3, [cs("Branch_3_Conv2d_0b_1x1", 64, (1, 1))]),
            ])
            return self.Mixed_5b
        if name == "Repeat":
            self.Repeat = Repeat(ch, "block35", 10, BLOCK35, 0.17)
            return self.Repeat
        if name == "Mixed_6a":
            self.Mixed_6a = Towers(ch, [
                (None, [cs("Branch_0_Conv2d_1a_3x3", 384, (3, 3), 2,
                           "VALID")]),
                (None, [cs("Branch_1_Conv2d_0a_1x1", 256, (1, 1)),
                        cs("Branch_1_Conv2d_0b_3x3", 256, (3, 3)),
                        cs("Branch_1_Conv2d_1a_3x3", 384, (3, 3), 2,
                           "VALID")]),
                (reduce_pool, []),
            ])
            return self.Mixed_6a
        if name == "PreAuxLogits":
            self.Repeat_1 = Repeat(ch, "block17", 20, BLOCK17, 0.10)
            return self.Repeat_1
        if name == "Mixed_7a":
            self.Mixed_7a = Towers(ch, [
                (None, [cs("Branch_0_Conv2d_0a_1x1", 256, (1, 1)),
                        cs("Branch_0_Conv2d_1a_3x3", 384, (3, 3), 2,
                           "VALID")]),
                (None, [cs("Branch_1_Conv2d_0a_1x1", 256, (1, 1)),
                        cs("Branch_1_Conv2d_1a_3x3", 288, (3, 3), 2,
                           "VALID")]),
                (None, [cs("Branch_2_Conv2d_0a_1x1", 256, (1, 1)),
                        cs("Branch_2_Conv2d_0b_3x3", 288, (3, 3)),
                        cs("Branch_2_Conv2d_1a_3x3", 320, (3, 3), 2,
                           "VALID")]),
                (reduce_pool, []),
            ])
            return self.Mixed_7a
        # Conv2d_7b_1x1: the 9 block8s, the last without a ReLU, the conv.
        self.Repeat_2 = Repeat(ch, "block8", 9, BLOCK8, 0.20)
        self.Block8 = Residual(ch, BLOCK8, 1.0, relu=False)
        conv = self._conv(name, ch, 1536, (1, 1))
        return lambda x: conv(self.Block8(self.Repeat_2(x)))
