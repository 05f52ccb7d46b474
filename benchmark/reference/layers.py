"""Plain layers with TF semantics, in float32, and the numerics they compute
in: `Exact` (float32, TF32 off) or `FP8` (every conv and matmul operand
rounded to float8 e4m3 with a per-tensor scale, its incoming gradient to
e5m2: the lower precision a bf16 configuration's control computes in)."""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN and cuBLAS inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` (an fp8 format) under a per-tensor scale that
    maps its largest magnitude to the format's largest finite value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


class Exact:
    """float32 operands as they are."""

    name = "float32"

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        return x


class _BF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class BF16:
    """Conv and matmul operands and their incoming gradients rounded to
    bfloat16 (sums in float32): the precision a bf16 configuration states,
    emulated in the reference, as a second witness of how far rounding
    alone moves the compared numbers."""

    name = "bf16"

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        return _BF16.apply(x)


class FP8:
    """Conv and matmul operands through float8 (see the module docstring)."""

    name = "fp8"

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        return _FP8.apply(x)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-'SAME' (lo, hi) padding of one spatial dim: bottom/right heavy."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int, num,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """TF-'SAME' conv of NCHW x with OIHW w (zeros padded explicitly)."""
    kh, kw = w.shape[2:]
    ph = same_pads(x.shape[2], kh, stride)
    pw = same_pads(x.shape[3], kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(num.q(x), num.q(w), bias, stride=stride)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num):
    return F.linear(num.q(x), num.q(w), b)


def max_pool(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF-'SAME' max pool: -inf padding, which never wins a window."""
    ph = same_pads(x.shape[2], k, s)
    pw = same_pads(x.shape[3], k, s)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=-torch.inf)
    return F.max_pool2d(x, k, s)


def gap(x: torch.Tensor) -> torch.Tensor:
    """Global average pool, NCHW -> (N, C)."""
    return x.mean(dim=(2, 3))


def fold(w: torch.Tensor, bn: Dict[str, torch.Tensor], eps: float):
    """BatchNorm folded into the conv before it: s = scale / sqrt(var +
    eps); W' = W s, b' = bias - mean s."""
    s = bn.get("scale", 1.0) / torch.sqrt(bn["running_var"] + eps)
    if not torch.is_tensor(s):
        s = torch.full_like(bn["bias"], s)
    return w * s.view(-1, 1, 1, 1), bn["bias"] - bn["running_mean"] * s


def batch_norm(x: torch.Tensor, bn: Dict[str, torch.Tensor], eps: float,
               train: bool) -> torch.Tensor:
    """Train: the batch's mean and biased variance over (N, H, W).
    Eval: the running statistics.  y = (x - mean) / sqrt(var + eps) *
    scale + bias (scale 1 where the layer has none)."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
    else:
        mean, var = bn["running_mean"], bn["running_var"]
    y = (x - mean.view(1, -1, 1, 1)) * torch.rsqrt(var + eps).view(1, -1, 1, 1)
    if "scale" in bn:
        y = y * bn["scale"].view(1, -1, 1, 1)
    return y + bn["bias"].view(1, -1, 1, 1)


class Net:
    """What a backbone's layers read: the weights by name, the mode
    ("train": batch statistics; "eval": running statistics; "folded": BN
    folded into the convs by `fold`) and the numerics."""

    def __init__(self, params: Dict[str, torch.Tensor], mode: str, num):
        if mode not in ("train", "eval", "folded"):
            raise ValueError(f"unknown mode {mode!r}")
        self.p, self.mode, self.num = params, mode, num

    def bn_params(self, name: str) -> Dict[str, torch.Tensor]:
        keys = ("scale", "bias", "running_mean", "running_var")
        return {k: self.p[f"{name}.{k}"] for k in keys
                if f"{name}.{k}" in self.p}

    def conv_bn(self, x: torch.Tensor, name: str, stride: int = 1,
                relu: bool = True, eps: float = 1e-3) -> torch.Tensor:
        """conv (no bias) + BatchNorm (+ ReLU): the layer `name` holds
        `name.conv.weight` and `name.BatchNorm.*`."""
        w = self.p[f"{name}.conv.weight"]
        bn = self.bn_params(f"{name}.BatchNorm")
        if self.mode == "folded":
            wf, bf = fold(w, bn, eps)
            y = conv(x, wf, stride, self.num, bias=bf)
        else:
            y = batch_norm(conv(x, w, stride, self.num), bn, eps,
                           self.mode == "train")
        return F.relu(y) if relu else y
