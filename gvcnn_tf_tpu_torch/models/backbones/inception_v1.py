"""Inception-v1 (GoogLeNet) backbone, slim-compatible (counterpart of
`gvcnn_tf_tpu/models/backbones/inception_v1.py`).

Same endpoint names, channel plan, BatchNorm eps (1e-3, no scale) and
TF-'SAME' padding as the JAX package, and module names that follow its
parameter tree, so that `bridge.py` maps one onto the other by path.

Layout: `InceptionV1Base` takes NHWC input (N, H, W, 3), as the JAX module
does.  The stem goes through `ops/stem_kernel.py`, which returns NHWC; its
permute is a channels-last NCHW tensor, and every later layer runs on NCHW
tensors (channels-last in memory on the card).  Endpoints are NCHW.

Dtypes: convs run in the input's dtype (the weight is cast where it is not
already that dtype, as Flax casts fp32 params to the compute dtype);
BatchNorm computes in fp32 and returns the input's dtype, as Flax's does.

Train and eval mode follow the module's `training` flag: in train mode
BatchNorm normalizes with the batch's statistics and updates its running
statistics in place (Flax's `use_running_average=False`).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gvcnn_tf_tpu_torch.ops.pool import max_pool, same_pads
from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv

# slim's inception_v1 trunc_normal(0.09) for conv kernels.
_TRUNC_STDDEV = 0.09
# jax.nn.initializers.truncated_normal divides stddev by the stddev of a
# unit normal truncated to [-2, 2], so the samples have the stddev asked for.
_TRUNC_CORRECTION = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, stddev: float,
                  generator: torch.Generator) -> torch.Tensor:
    """In place: the distribution of jax's truncated_normal(stddev)."""
    s = stddev / _TRUNC_CORRECTION
    return nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s,
                                 generator=generator)


def conv2d_same(x: torch.Tensor, weight: torch.Tensor,
                stride: Tuple[int, int]) -> torch.Tensor:
    """`F.conv2d` with TF-'SAME' padding (zeros), in x's dtype."""
    kh, kw = weight.shape[2:]
    ph = same_pads(x.shape[2], kh, stride[0])
    pw = same_pads(x.shape[3], kw, stride[1])
    weight = weight.to(x.dtype)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, weight, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, weight, stride=stride)


class BatchNorm(nn.Module):
    """Flax `BatchNorm(use_scale=False)` over channel dim 1, computed in fp32
    and returned in x's dtype; parameters and statistics stay fp32.

    Eval: y = (x - running_mean) / sqrt(running_var + eps) + bias.
    Train (Flax's `use_running_average=False`): y normalized with the
    batch's mean and biased variance over (N, H, W), in fp32, by PyTorch's
    fused batch-norm kernel (`native_batch_norm`, which also gives the
    gradients of x and bias); then in place
    r <- momentum * r + (1 - momentum) * stat for the running mean and the
    running *biased* variance, as Flax updates `batch_stats` (torch's own
    running update would store the unbiased one).  The kernel computes the
    variance in one Welford pass where Flax takes max(0, E[x^2] - E[x]^2):
    the same statistic, rounded differently; the variance comes back as
    1 / invstd^2 - eps, floored at 0.  `momentum` is the EMA decay (slim's
    0.9997; `config.bn_momentum` overrides it)."""

    def __init__(self, features: int, eps: float = 1e-3,
                 momentum: float = 0.9997):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        # The fused kernel's unit scale: given no weight, its CUDA backward
        # returns no bias gradient.  Not part of the state_dict.
        self.register_buffer("_unit", torch.ones(features), persistent=False)
        self._affine = None           # (key, (scale, shift)); scale_shift

    def _check_eval(self):
        if self.training:
            raise RuntimeError(
                "BatchNorm.scale_shift is the eval-mode affine; the module "
                "is in training mode")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                None, self.bias, False, 0.0, self.eps)
        y, mean, invstd = torch.native_batch_norm(
            x, self._unit, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = torch.clamp(invstd.square().reciprocal() - self.eps,
                              min=0.0)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean * (1.0 - m))
            self.running_var.mul_(m).add_(var * (1.0 - m))
        return y

    def scale_shift(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 (scale, shift) with BN(y) == y * scale + shift:
        scale = 1 / sqrt(var + eps), shift = bias - mean * scale.

        With grad mode off they are kept until a parameter or statistic
        changes (storage or version counter), so serving computes them
        once."""
        self._check_eval()
        tensors = (self.bias, self.running_mean, self.running_var)
        if torch.is_grad_enabled() or any(t.is_inference() for t in tensors):
            return self._scale_shift()
        key = tuple((t.data_ptr(), t._version) for t in tensors)
        if self._affine is None or self._affine[0] != key:
            self._affine = (key, self._scale_shift())
        return self._affine[1]

    def _scale_shift(self):
        scale = torch.rsqrt(self.running_var + self.eps)
        return scale, torch.addcmul(self.bias, self.running_mean, scale,
                                    value=-1.0)


class ConvBNReLU(nn.Module):
    """slim.conv2d + batch_norm + relu, TF-'SAME' padding, no conv bias."""

    def __init__(self, in_ch: int, features: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride,
                              bias=False)
        self.BatchNorm = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same(x, self.conv.weight, self.conv.stride)
        return F.relu(self.BatchNorm(y))


class Stem(nn.Module):
    """Conv2d_1a_7x7 through the stem kernel (counterpart of `PallasStem`,
    the same parameters as a `ConvBNReLU(3, 64, 7x7, stride 2)`).

    NHWC (N, H, W, 3) in, NCHW out.  In eval mode with no gradient to
    take, the BatchNorm and the ReLU run as the kernel's epilogue
    (`BatchNorm.scale_shift`), so on the card the conv output is written
    once, in bf16; on the CPU the plain version applies the same affine in
    fp32 after the conv.  Otherwise (train mode: batch statistics; or a
    gradient is needed) the kernel runs without its epilogue, through
    `StemConvFunction`, and BatchNorm and the ReLU follow as their own
    passes."""

    def __init__(self, features: int = 64):
        super().__init__()
        self.conv = nn.Conv2d(3, features, (7, 7), stride=(2, 2), bias=False)
        self.BatchNorm = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.to(x.dtype)
        if self.training or (torch.is_grad_enabled() and (
                x.requires_grad or w.requires_grad
                or self.BatchNorm.bias.requires_grad)):
            y = stem_conv(x, w).permute(0, 3, 1, 2)
            return F.relu(self.BatchNorm(y))
        scale, shift = self.BatchNorm.scale_shift()
        return stem_conv(x, w, scale, shift, relu=True).permute(0, 3, 1, 2)


class InceptionBlock(nn.Module):
    """One Mixed_* block (slim inception_v1's branch plan).

    The JAX package's `merge_branches` policies run some branch convs as one
    wider conv; the math and parameters are the same as these separate
    branches, which is what the port runs."""

    def __init__(self, in_ch: int, b0: int, b1_reduce: int, b1: int,
                 b2_reduce: int, b2: int, b3: int):
        super().__init__()
        self.Branch_0_Conv2d_0a_1x1 = ConvBNReLU(in_ch, b0, (1, 1))
        self.Branch_1_Conv2d_0a_1x1 = ConvBNReLU(in_ch, b1_reduce, (1, 1))
        self.Branch_1_Conv2d_0b_3x3 = ConvBNReLU(b1_reduce, b1, (3, 3))
        self.Branch_2_Conv2d_0a_1x1 = ConvBNReLU(in_ch, b2_reduce, (1, 1))
        self.Branch_2_Conv2d_0b_3x3 = ConvBNReLU(b2_reduce, b2, (3, 3))
        self.Branch_3_Conv2d_0b_1x1 = ConvBNReLU(in_ch, b3, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        br0 = self.Branch_0_Conv2d_0a_1x1(x)
        br1 = self.Branch_1_Conv2d_0b_3x3(self.Branch_1_Conv2d_0a_1x1(x))
        br2 = self.Branch_2_Conv2d_0b_3x3(self.Branch_2_Conv2d_0a_1x1(x))
        br3 = self.Branch_3_Conv2d_0b_1x1(max_pool(x, (3, 3), (1, 1)))
        return torch.cat([br0, br1, br2, br3], dim=1)


# (endpoint, spec) in execution order: ("conv", features, kernel, stride) |
# ("pool", kernel, stride) | ("mixed", b0, b1r, b1, b2r, b2, b3).
_V1_PLAN: Sequence[Tuple[str, Tuple]] = (
    ("Conv2d_1a_7x7", ("conv", 64, (7, 7), (2, 2))),
    ("MaxPool_2a_3x3", ("pool", (3, 3), (2, 2))),
    ("Conv2d_2b_1x1", ("conv", 64, (1, 1), (1, 1))),
    ("Conv2d_2c_3x3", ("conv", 192, (3, 3), (1, 1))),
    ("MaxPool_3a_3x3", ("pool", (3, 3), (2, 2))),
    ("Mixed_3b", ("mixed", 64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", ("mixed", 128, 128, 192, 32, 96, 64)),
    ("MaxPool_4a_3x3", ("pool", (3, 3), (2, 2))),
    ("Mixed_4b", ("mixed", 192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", ("mixed", 160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", ("mixed", 128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", ("mixed", 112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", ("mixed", 256, 160, 320, 32, 128, 128)),
    ("MaxPool_5a_2x2", ("pool", (2, 2), (2, 2))),
    ("Mixed_5b", ("mixed", 256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", ("mixed", 384, 192, 384, 48, 128, 128)),
)

ENDPOINTS = tuple(name for name, _ in _V1_PLAN)

ENDPOINT_CHANNELS = {
    "Conv2d_1a_7x7": 64, "MaxPool_2a_3x3": 64, "Conv2d_2b_1x1": 64,
    "Conv2d_2c_3x3": 192, "MaxPool_3a_3x3": 192, "Mixed_3b": 256,
    "Mixed_3c": 480, "MaxPool_4a_3x3": 480, "Mixed_4b": 512,
    "Mixed_4c": 512, "Mixed_4d": 512, "Mixed_4e": 528, "Mixed_4f": 832,
    "MaxPool_5a_2x2": 832, "Mixed_5b": 832, "Mixed_5c": 1024,
}


class InceptionV1Base(nn.Module):
    """`inception_v1_base`: stem + Mixed blocks up to `final_endpoint`.

    forward(x NHWC (N, H, W, 3)) -> (features NCHW, {endpoint: NCHW})."""

    DEFAULT_RAW_ENDPOINT = "Mixed_3c"
    DEFAULT_FINAL_ENDPOINT = "Mixed_5c"
    ENDPOINTS = ENDPOINTS
    ENDPOINT_CHANNELS = ENDPOINT_CHANNELS

    def __init__(self, final_endpoint: str = "Mixed_5c"):
        super().__init__()
        if final_endpoint not in ENDPOINTS:
            raise ValueError(f"unknown endpoint {final_endpoint!r}")
        self.final_endpoint = final_endpoint
        self._pools: Dict[str, Tuple] = {}
        plan = _V1_PLAN[:ENDPOINTS.index(final_endpoint) + 1]
        ch = 3
        for name, spec in plan:
            if name == "Conv2d_1a_7x7":
                self.add_module(name, Stem(spec[1]))
            elif spec[0] == "conv":
                self.add_module(name, ConvBNReLU(ch, spec[1], spec[2],
                                                 spec[3]))
            elif spec[0] == "pool":
                self._pools[name] = spec[1:]
            else:
                self.add_module(name, InceptionBlock(ch, *spec[1:]))
            ch = ENDPOINT_CHANNELS[name]
        self._names = [name for name, _ in plan]

    def forward(self, x: torch.Tensor):
        endpoints: Dict[str, torch.Tensor] = {}
        for name in self._names:
            if name in self._pools:
                x = max_pool(x, *self._pools[name])
            else:
                x = getattr(self, name)(x)
            endpoints[name] = x
        return x, endpoints
