"""Plain layers with TF semantics, in float32, and the numerics they compute
in: `Exact` (float32, TF32 off) or `FP8` (every conv and matmul operand
rounded to float8 e4m3 with a per-tensor scale, its incoming gradient to
e5m2: the lower precision a bf16 configuration's control computes in)."""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

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


class ConvShape(NamedTuple):
    """One conv of a backbone, as its `conv_shapes` yields it: the layer
    `name` (weight `<name>.conv.weight`, shape (cout, cin, kh, kw)), its
    kernel and stride as (h, w) pairs, the output (h, w) that the
    backbone computes under its own padding, and `bn`: whether a
    BatchNorm follows it (`<name>.BatchNorm.*`, `Net.conv_bn`) or, where
    false, the conv has a bias `<name>.conv.bias` of shape (cout,) and no
    BatchNorm (TF-Slim's `conv2d` with `normalizer_fn=None`,
    `Net.conv_bias`)."""

    name: str
    cin: int
    cout: int
    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    out: Tuple[int, int]
    bn: bool = True


def pair(v) -> Tuple[int, int]:
    """A kernel or stride given as an int or an (h, w) pair, as (h, w)."""
    if isinstance(v, int):
        return v, v
    h, w = v
    return int(h), int(w)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-'SAME' (lo, hi) padding of one spatial dim: bottom/right heavy."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def out_hw(h: int, w: int, kernel, stride,
           padding: str = "SAME") -> Tuple[int, int]:
    """(H, W) out of a conv or pool over (h, w): ceil(size / stride) under
    TF-'SAME', floor((size - kernel) / stride) + 1 under 'VALID'."""
    (kh, kw), (sh, sw) = pair(kernel), pair(stride)
    if padding == "SAME":
        return -(-h // sh), -(-w // sw)
    if padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    if h < kh or w < kw:
        raise ValueError(f"a 'VALID' {kh}x{kw} window over {h}x{w}")
    return (h - kh) // sh + 1, (w - kw) // sw + 1


def pads(x: torch.Tensor, kernel, stride, padding: str):
    """F.pad's (left, right, top, bottom) of NCHW x under `padding`."""
    (kh, kw), (sh, sw) = pair(kernel), pair(stride)
    if padding == "VALID":
        return 0, 0, 0, 0
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r}")
    ph, pw = same_pads(x.shape[2], kh, sh), same_pads(x.shape[3], kw, sw)
    return pw[0], pw[1], ph[0], ph[1]


def conv(x: torch.Tensor, w: torch.Tensor, stride, num,
         bias: Optional[torch.Tensor] = None,
         padding: str = "SAME") -> torch.Tensor:
    """TF-'SAME' (zeros padded explicitly) or 'VALID' conv of NCHW x with
    OIHW w; `stride` an int or an (h, w) pair."""
    x = F.pad(x, pads(x, w.shape[2:], stride, padding))
    return F.conv2d(num.q(x), num.q(w), bias, stride=stride)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num):
    return F.linear(num.q(x), num.q(w), b)


def max_pool(x: torch.Tensor, k, s, padding: str = "SAME") -> torch.Tensor:
    """TF-'SAME' max pool (-inf padding, which never wins a window) or
    'VALID'; `k` and `s` ints or (h, w) pairs."""
    x = F.pad(x, pads(x, k, s, padding), value=-torch.inf)
    return F.max_pool2d(x, k, s)


def avg_pool(x: torch.Tensor, k, s, padding: str = "SAME", *,
             count_include_pad: bool) -> torch.Tensor:
    """TF-'SAME' (zeros padded) or 'VALID' average pool.  Under 'SAME' the
    two conventions differ at the border: `count_include_pad=True` divides
    every window by its full size, the padded zeros counted (Flax's
    `avg_pool`, which the port follows); False divides by the number of
    the window's elements inside the image (TF-Slim's `avg_pool2d`)."""
    p = pads(x, k, s, padding)
    y = F.avg_pool2d(F.pad(x, p), k, s)
    if count_include_pad:
        return y
    # Each window's share of elements inside the image.
    inside = F.avg_pool2d(F.pad(torch.ones_like(x[:1, :1]), p), k, s)
    return y / inside


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
    folded into the convs by `fold`), the numerics and the BatchNorm's
    epsilon."""

    def __init__(self, params: Dict[str, torch.Tensor], mode: str, num,
                 eps: float):
        if mode not in ("train", "eval", "folded"):
            raise ValueError(f"unknown mode {mode!r}")
        self.p, self.mode, self.num, self.eps = params, mode, num, eps

    def bn_params(self, name: str) -> Dict[str, torch.Tensor]:
        keys = ("scale", "bias", "running_mean", "running_var")
        return {k: self.p[f"{name}.{k}"] for k in keys
                if f"{name}.{k}" in self.p}

    def conv_bn(self, x: torch.Tensor, name: str, stride=1,
                relu: bool = True, eps: Optional[float] = None,
                padding: str = "SAME") -> torch.Tensor:
        """conv (no bias) + BatchNorm (+ ReLU): the layer `name` holds
        `name.conv.weight` and `name.BatchNorm.*`; `eps` defaults to the
        net's (its backbone's `BN_EPS`)."""
        eps = self.eps if eps is None else eps
        w = self.p[f"{name}.conv.weight"]
        bn = self.bn_params(f"{name}.BatchNorm")
        if self.mode == "folded":
            wf, bf = fold(w, bn, eps)
            y = conv(x, wf, stride, self.num, bias=bf, padding=padding)
        else:
            y = batch_norm(conv(x, w, stride, self.num, padding=padding),
                           bn, eps, self.mode == "train")
        return F.relu(y) if relu else y

    def conv_bias(self, x: torch.Tensor, name: str, stride=1,
                  padding: str = "SAME") -> torch.Tensor:
        """conv + bias with no BatchNorm and no activation: the layer
        `name` holds `name.conv.weight` and `name.conv.bias`.  The same in
        every mode, since there is nothing to fold; the numerics round the
        conv's operands, not the float32 bias."""
        return conv(x, self.p[f"{name}.conv.weight"], stride, self.num,
                    bias=self.p[f"{name}.conv.bias"], padding=padding)
