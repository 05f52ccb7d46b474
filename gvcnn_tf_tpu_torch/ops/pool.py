"""TF-'SAME' max pooling and padding arithmetic, forward only
(counterpart of `gvcnn_tf_tpu/ops/pool.py:41-58, 194-220`).

TF-'SAME' pads bottom/right-heavy: a 3x3/2 pool on an even size pads (0, 1).
`F.max_pool2d`'s own padding is symmetric, so an asymmetric pad is applied
explicitly with -inf before a padding-free pool.  Tensors are NCHW (any
memory format).  The backward pass comes with the training port.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-'SAME' (lo, hi) padding of one spatial dim."""
    out = -(-size // s)  # ceil
    total = max((out - 1) * s + k - size, 0)
    lo = total // 2
    return lo, total - lo


def max_pool(x: torch.Tensor, kernel: Sequence[int],
             strides: Sequence[int]) -> torch.Tensor:
    """`flax.linen.max_pool(x, kernel, strides, padding="SAME")` on NCHW."""
    (kh, kw), (sh, sw) = tuple(kernel), tuple(strides)
    ph = same_pads(x.shape[2], kh, sh)
    pw = same_pads(x.shape[3], kw, sw)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        # Symmetric: max_pool2d's implicit padding never wins the max.
        return F.max_pool2d(x, (kh, kw), (sh, sw), padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=-torch.inf)
    return F.max_pool2d(x, (kh, kw), (sh, sw))
