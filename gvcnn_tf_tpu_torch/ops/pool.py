"""TF-'SAME' / 'VALID' pooling and padding arithmetic (counterpart of
`gvcnn_tf_tpu/ops/pool.py:41-58, 194-220` and of `flax.linen.avg_pool`).

TF-'SAME' pads bottom/right-heavy: a 3x3/2 pool on an even size pads (0, 1).
Tensors are NCHW (any memory format).

`max_pool` is the op `gvcnn::max_pool_same` (`ops/pool_kernel.py`): where
x needs a gradient the forward also records each window's winning slot in
one byte and the backward gathers dy into dx from that record.  By x's
device:

  CPU   `F.max_pool2d`, an asymmetric pad applied explicitly with -inf
        before a padding-free pool (`F.max_pool2d`'s own padding is
        symmetric), and the record and the gather as plain PyTorch;
  CUDA  the hand-written kernels (`csrc/max_pool.cu`), which pad inside
        themselves.

Both credit each window's first maximum, as XLA's select-and-scatter does.

`avg_pool` takes the one geometry of the backbones' average pools, a 3x3
window at stride 1 with 'SAME' pads (1, 1), and raises on another.  It is
the op `gvcnn::avg_pool_same`, whose backward is the same box mean over dy
and saves nothing; by x's device:

  CPU   `F.avg_pool2d` with the padded zeros counted, and the box mean of
        dy as plain PyTorch;
  CUDA  the hand-written kernels (`csrc/avg_pool.cu`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from gvcnn_tf_tpu_torch.ops import pool_kernel


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-'SAME' (lo, hi) padding of one spatial dim."""
    out = -(-size // s)  # ceil
    total = max((out - 1) * s + k - size, 0)
    lo = total // 2
    return lo, total - lo


def _pads(x: torch.Tensor, kernel, strides, padding: str):
    """((lo, hi) of H, (lo, hi) of W) for `padding` 'SAME' or 'VALID'."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding != "SAME":
        raise ValueError(f"unsupported padding {padding!r}")
    return (same_pads(x.shape[2], kernel[0], strides[0]),
            same_pads(x.shape[3], kernel[1], strides[1]))


def max_pool(x: torch.Tensor, kernel: Sequence[int],
             strides: Sequence[int], padding: str = "SAME") -> torch.Tensor:
    """`flax.linen.max_pool(x, kernel, strides, padding)` on NCHW."""
    kernel, strides = tuple(kernel), tuple(strides)
    return pool_kernel.max_pool_same(x, kernel, strides,
                                     _pads(x, kernel, strides, padding))


def avg_pool(x: torch.Tensor, kernel: Sequence[int],
             strides: Sequence[int], padding: str = "SAME") -> torch.Tensor:
    """`flax.linen.avg_pool(x, kernel, strides, padding)` on NCHW, for a
    3x3 window at stride 1, 'SAME' (another raises).

    Flax's default `count_include_pad=True`: the padded zeros count in
    every window's mean (unlike TF-Slim's 'SAME' average pool, which
    divides by the window's in-image size); the port follows the JAX
    package."""
    if (tuple(kernel), tuple(strides), padding) != ((3, 3), (1, 1), "SAME"):
        raise ValueError(f"avg_pool: takes a 3x3 window at stride 1 with "
                         f"'SAME' padding, got kernel {kernel}, strides "
                         f"{strides}, padding {padding!r}")
    return pool_kernel.avg_pool_same(x)
