"""Inception-v3 backbone (counterpart of
`gvcnn_tf_tpu/models/backbones/inception_v3.py`).

TF-Slim `inception_v3` structure, as the JAX module: a 'VALID' stem to
35x35x192 (at 299), 3x block A (Mixed_5b-5d), the grid reduction Mixed_6a
to 17x17x768, 4x factorized-7x7 blocks (Mixed_6b-6e), the reduction
Mixed_7a to 8x8x1280, 2x expanded blocks (Mixed_7b-7c, 2048 channels).  It
reuses Inception-v4's conv (`ConvBN`: BN eps 1e-3 without a scale, decay
0.9997, lecun-normal kernels) and branch-tower machinery, as the JAX file
reuses v4's `_Conv`.  The smallest input that reaches Mixed_7c is 75x75.

NHWC (N, H, W, 3) in; every layer runs on NCHW tensors (channels-last in
memory on the card); endpoints are NCHW.
"""

from __future__ import annotations

from typing import Callable

from gvcnn_tf_tpu_torch.models.backbones.inception_v4 import (
    StagedBackbone,
    Towers,
    avg_pool3,
    cs,
    flat_towers,
    reduce_pool,
)


def block_a(in_ch: int, pool_proj: int, b1_reduce: int = 48) -> Towers:
    """35x35 block: 1x1 / 5x5 / double-3x3 / pool-proj."""
    return Towers(in_ch, [
        (None, [cs("Branch_0_Conv2d_0a_1x1", 64, (1, 1))]),
        (None, [cs("Branch_1_Conv2d_0a_1x1", b1_reduce, (1, 1)),
                cs("Branch_1_Conv2d_0b_5x5", 64, (5, 5))]),
        (None, [cs("Branch_2_Conv2d_0a_1x1", 64, (1, 1)),
                cs("Branch_2_Conv2d_0b_3x3", 96, (3, 3)),
                cs("Branch_2_Conv2d_0c_3x3", 96, (3, 3))]),
        (avg_pool3, [cs("Branch_3_Conv2d_0b_1x1", pool_proj, (1, 1))]),
    ])


def block_b(width: int, in_ch: int = 768) -> Towers:
    """17x17 block with factorized 7x7 convs (768 channels out)."""
    w = width
    return Towers(in_ch, [
        (None, [cs("Branch_0_Conv2d_0a_1x1", 192, (1, 1))]),
        (None, [cs("Branch_1_Conv2d_0a_1x1", w, (1, 1)),
                cs("Branch_1_Conv2d_0b_1x7", w, (1, 7)),
                cs("Branch_1_Conv2d_0c_7x1", 192, (7, 1))]),
        (None, [cs("Branch_2_Conv2d_0a_1x1", w, (1, 1)),
                cs("Branch_2_Conv2d_0b_7x1", w, (7, 1)),
                cs("Branch_2_Conv2d_0c_1x7", w, (1, 7)),
                cs("Branch_2_Conv2d_0d_7x1", w, (7, 1)),
                cs("Branch_2_Conv2d_0e_1x7", 192, (1, 7))]),
        (avg_pool3, [cs("Branch_3_Conv2d_0b_1x1", 192, (1, 1))]),
    ])


def block_c(in_ch: int) -> Towers:
    """8x8 block with expanded 1x3 / 3x1 branches (2048 channels out)."""
    return Towers(in_ch, [
        (None, [cs("Branch_0_Conv2d_0a_1x1", 320, (1, 1))]),
        (None, [cs("Branch_1_Conv2d_0a_1x1", 384, (1, 1)),
                (cs("Branch_1_Conv2d_0b_1x3", 384, (1, 3)),
                 cs("Branch_1_Conv2d_0c_3x1", 384, (3, 1)))]),
        (None, [cs("Branch_2_Conv2d_0a_1x1", 448, (1, 1)),
                cs("Branch_2_Conv2d_0b_3x3", 384, (3, 3)),
                (cs("Branch_2_Conv2d_0c_1x3", 384, (1, 3)),
                 cs("Branch_2_Conv2d_0d_3x1", 384, (3, 1)))]),
        (avg_pool3, [cs("Branch_3_Conv2d_0b_1x1", 192, (1, 1))]),
    ])


ENDPOINTS = (
    "Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "MaxPool_3a_3x3",
    "Conv2d_3b_1x1", "Conv2d_4a_3x3", "MaxPool_5a_3x3",
    "Mixed_5b", "Mixed_5c", "Mixed_5d",
    "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
    "Mixed_7a", "Mixed_7b", "Mixed_7c",
)

ENDPOINT_CHANNELS = {
    "Conv2d_1a_3x3": 32, "Conv2d_2a_3x3": 32, "Conv2d_2b_3x3": 64,
    "MaxPool_3a_3x3": 64, "Conv2d_3b_1x1": 80, "Conv2d_4a_3x3": 192,
    "MaxPool_5a_3x3": 192, "Mixed_5b": 256, "Mixed_5c": 288,
    "Mixed_5d": 288, "Mixed_6a": 768, "Mixed_6b": 768, "Mixed_6c": 768,
    "Mixed_6d": 768, "Mixed_6e": 768, "Mixed_7a": 1280, "Mixed_7b": 2048,
    "Mixed_7c": 2048,
}

# (pool_proj, b1_reduce) of the A blocks, width of the B blocks.
_A = {"Mixed_5b": (32, 48), "Mixed_5c": (64, 48), "Mixed_5d": (64, 48)}
_B = {"Mixed_6b": 128, "Mixed_6c": 160, "Mixed_6d": 160, "Mixed_6e": 192}


class InceptionV3Base(StagedBackbone):
    """`inception_v3_base`."""

    NAME = "InceptionV3"
    DEFAULT_RAW_ENDPOINT = "Mixed_5d"
    DEFAULT_FINAL_ENDPOINT = "Mixed_7c"
    DESCRIPTOR_DIM = 2048
    ENDPOINTS = ENDPOINTS
    ENDPOINT_CHANNELS = ENDPOINT_CHANNELS
    KERNEL_INIT = "lecun_normal"

    def _build(self, name: str, ch: int) -> Callable:
        if name.startswith("MaxPool"):
            return reduce_pool
        if name == "Conv2d_1a_3x3":
            return self._conv(name, ch, 32, (3, 3), (2, 2), "VALID")
        if name == "Conv2d_2a_3x3":
            return self._conv(name, ch, 32, (3, 3), (1, 1), "VALID")
        if name == "Conv2d_2b_3x3":
            return self._conv(name, ch, 64, (3, 3))
        if name == "Conv2d_3b_1x1":
            return self._conv(name, ch, 80, (1, 1), (1, 1), "VALID")
        if name == "Conv2d_4a_3x3":
            return self._conv(name, ch, 192, (3, 3), (1, 1), "VALID")
        if name == "Mixed_6a":            # grid reduction 35 -> 17
            return flat_towers(self, name, Towers(ch, [
                (None, [cs("Branch_0_Conv2d_1a_1x1", 384, (3, 3), 2,
                           "VALID")]),
                (None, [cs("Branch_1_Conv2d_0a_1x1", 64, (1, 1)),
                        cs("Branch_1_Conv2d_0b_3x3", 96, (3, 3)),
                        cs("Branch_1_Conv2d_1a_1x1", 96, (3, 3), 2,
                           "VALID")]),
                (reduce_pool, [])]))
        if name == "Mixed_7a":            # grid reduction 17 -> 8
            return flat_towers(self, name, Towers(ch, [
                (None, [cs("Branch_0_Conv2d_0a_1x1", 192, (1, 1)),
                        cs("Branch_0_Conv2d_1a_3x3", 320, (3, 3), 2,
                           "VALID")]),
                (None, [cs("Branch_1_Conv2d_0a_1x1", 192, (1, 1)),
                        cs("Branch_1_Conv2d_0b_1x7", 192, (1, 7)),
                        cs("Branch_1_Conv2d_0c_7x1", 192, (7, 1)),
                        cs("Branch_1_Conv2d_1a_3x3", 192, (3, 3), 2,
                           "VALID")]),
                (reduce_pool, [])]))
        if name in _A:
            block = block_a(ch, *_A[name])
        elif name in _B:
            block = block_b(_B[name], ch)
        else:
            block = block_c(ch)
        self.add_module(name, block)
        return block
