"""Layers shared by the port's backbones, with TF/Flax semantics.

- `conv2d_tf`: `F.conv2d` with TF-'SAME' padding (asymmetric, bottom/right
  heavy) or 'VALID', in x's dtype, optionally grouped (depthwise).
- `BatchNorm`: Flax's `BatchNorm` over channel dim 1, with an optional
  learned `scale` (Flax `use_scale=True`, ResNet) and the family's own eps
  and EMA decay, and the ReLU that follows it where the caller asks.
- `ConvBN`: conv + BatchNorm (+ ReLU), no conv bias: Inception-v1's
  `ConvBNReLU`, Inception-v3/v4's `_Conv` and ResNet's `_ConvBN`.
- `ConvBias`: a conv with a bias and no BatchNorm (slim's `conv2d` with
  `normalizer_fn=None`); its forward leaves the bias to the caller
  (Inception-ResNet-v2's "up" convs add it in the residual join).
- The JAX package's initializers: slim's truncated normal (Inception-v1 and
  v2) and Flax's default lecun normal (v3, v4, ResNet, the heads).
- `remat`: Flax's `nn.remat` for the port, one non-reentrant
  `torch.utils.checkpoint` region whose recompute in the backward leaves
  BatchNorm's running statistics alone.

Dtypes: convs run in the input's dtype (the weight is cast where it is not
already that dtype, as Flax casts fp32 params to the compute dtype);
BatchNorm computes in fp32 and returns the input's dtype, as Flax's does.
On the card an fp32 conv here goes through cuDNN with PyTorch's default
(`torch.backends.cudnn.allow_tf32` True: TF32 products, fp32 sums); the
port sets no global flag.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from gvcnn_tf_tpu_torch.ops import capturing
from gvcnn_tf_tpu_torch.ops.batch_norm_kernel import (
    batch_norm_train,
    update_plain,
)
from gvcnn_tf_tpu_torch.ops.pool import same_pads

# slim's inception_v1 trunc_normal(0.09) for conv kernels.
TRUNC_STDDEV = 0.09
# jax.nn.initializers.truncated_normal divides stddev by the stddev of a
# unit normal truncated to [-2, 2], so the samples have the stddev asked for.
_TRUNC_CORRECTION = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, stddev: float,
                  generator: torch.Generator) -> torch.Tensor:
    """In place: the distribution of jax's truncated_normal(stddev)."""
    s = stddev / _TRUNC_CORRECTION
    return nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s,
                                 generator=generator)


def lecun_normal_(t: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
    """In place: Flax's default kernel init, variance 1 / fan_in, truncated
    normal.  fan_in of an OIHW conv weight is I * H * W (per group), of a
    Linear weight (out, in) its `in`."""
    return trunc_normal_(t, t[0].numel() ** -0.5, generator)


# How deep the calling thread is in `remat` recomputes (backward passes run
# on autograd's threads, so the depth is per thread).
_recompute = threading.local()


@contextlib.contextmanager
def _recomputing():
    depth = getattr(_recompute, "depth", 0)
    _recompute.depth = depth + 1
    try:
        yield
    finally:
        _recompute.depth = depth


def recomputing() -> bool:
    """Whether this thread is inside a `remat` region's recompute."""
    return getattr(_recompute, "depth", 0) > 0


def _remat_contexts():
    return contextlib.nullcontext(), _recomputing()


def remat(fn, *args):
    """fn(*args) as one rematerialized region (Flax's `nn.remat`): the
    tensors autograd would save inside it are dropped, and the backward
    runs fn again to get them back (`torch.utils.checkpoint`,
    non-reentrant, so the region may return any structure and nest).

    The recompute runs the same ops on the same inputs, so it gives the
    same values; a BatchNorm in it normalizes with the recomputed batch
    statistics but leaves its running statistics alone (`recomputing()`),
    as Flax's remat leaves `batch_stats` alone: they move once a step.
    Under `bn_sync="global"` the recompute all-reduces the statistics
    again, every rank at the same point of its backward.  No RNG state is
    kept: the backbones draw no random numbers.

    Only what autograd saves through `ctx.save_for_backward` or an op's
    own saved tensors is dropped; a tensor kept as an attribute of a
    Function's ctx would stay resident."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=_remat_contexts)


def conv2d_tf(x: torch.Tensor, weight: torch.Tensor, stride: Tuple[int, int],
              padding: str = "SAME", groups: int = 1) -> torch.Tensor:
    """`F.conv2d` with TF-'SAME' (zeros) or 'VALID' padding, in x's
    dtype."""
    weight = weight.to(x.dtype)
    if padding == "VALID":
        return F.conv2d(x, weight, stride=stride, groups=groups)
    if padding != "SAME":
        raise ValueError(f"unsupported padding {padding!r}")
    kh, kw = weight.shape[2:]
    ph = same_pads(x.shape[2], kh, stride[0])
    pw = same_pads(x.shape[3], kw, stride[1])
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, weight, stride=stride, padding=(ph[0], pw[0]),
                        groups=groups)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, weight, stride=stride, groups=groups)


class BatchNorm(nn.Module):
    """Flax `BatchNorm` over channel dim 1, computed in fp32 and returned in
    x's dtype; parameters and statistics stay fp32.

    `use_scale` False (the Inception families, Flax `use_scale=False`): no
    gamma.  True (ResNet): a learned per-channel `scale`, init 1, named
    `scale` as in Flax, so the L2 term (`train.kernel_params`, parameters
    named `*.weight`) and the bridge's `weight` <-> `kernel` rule leave it
    alone.

    `forward(x, relu=False)`; with `relu` the result is max(y, 0), the
    ReLU that follows nearly every BatchNorm of the backbones, which train
    mode folds into its kernels.

    Eval: y = (x - running_mean) / sqrt(running_var + eps) * scale + bias
    (`F.batch_norm`, then `F.relu`).
    Train (Flax's `use_running_average=False`): y normalized with the
    batch's mean and biased variance over (N, H, W), in fp32, by the
    port's train-mode BatchNorm (`ops/batch_norm_kernel.py`: on the card
    the hand-written kernels of `csrc/batch_norm.cu`, which apply the ReLU
    and take its gradient too, on the CPU `native_batch_norm`'s math); and
    in place r <- momentum * r + (1 - momentum) * stat for the running
    mean and the running *biased* variance, as Flax updates `batch_stats`
    (torch's own running update would store the unbiased one).  The
    variance comes from deviations from the mean (the kernels: Welford and
    Chan's merges) where Flax takes max(0, E[x^2] - E[x]^2): the same
    statistic, rounded differently.  `momentum`
    is the EMA decay (slim's 0.9997 for Inception, 0.997 for ResNet;
    `config.bn_momentum` overrides it).  Inside a `remat` recompute the
    statistics are not moved again.  With `sync_group` set (`bn_sync=
    "global"`) train mode sums the statistics over the ranks instead
    (`_global_forward`), then the ReLU."""

    def __init__(self, features: int, eps: float = 1e-3,
                 momentum: float = 0.9997, use_scale: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.register_parameter(
            "scale", nn.Parameter(torch.ones(features)) if use_scale
            else None)
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self._affine = None           # (key, (scale, shift)); scale_shift
        self.sync_group = None        # process group of global statistics

    def _check_eval(self):
        if self.training:
            raise RuntimeError(
                "BatchNorm.scale_shift is the eval-mode affine; the module "
                "is in training mode")

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.scale, self.bias, False, 0.0, self.eps)
        elif self.sync_group is not None:
            y = self._global_forward(x)
        else:
            return batch_norm_train(
                x, self.scale, self.bias, self.running_mean,
                self.running_var, self.momentum, self.eps, relu,
                not recomputing())
        return F.relu(y) if relu else y

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        # Imported here: the parallel package imports the utilities, which
        # import this module.
        from gvcnn_tf_tpu_torch.parallel.collectives import sum_across_ranks

        c = x.shape[1]
        xf = x.float()
        local = torch.cat([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3)),
                           xf.new_full((1,), x.numel() // c)])
        stats = sum_across_ranks(local, self.sync_group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean.square(), min=0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.scale is not None:
            mul = mul * self.scale
        # Flax's order: (x - mean) * mul + bias.
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        if not recomputing():
            update_plain(self.running_mean, self.running_var, mean, var,
                         self.momentum)
        return y.to(x.dtype)

    def _params(self):
        return tuple(t for t in (self.scale, self.bias, self.running_mean,
                                 self.running_var) if t is not None)

    def scale_shift(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 (scale, shift) with BN(y) == y * scale + shift:
        scale = gamma / sqrt(var + eps) (gamma = 1 without a learned
        scale), shift = bias - mean * scale.

        With grad mode off they are kept until a parameter or statistic
        changes (storage or version counter), so serving computes them
        once.  While tracing (`torch.export`) they are computed, not looked
        up: a traced tensor has no storage to key on, so an exported graph
        computes them on every call.  So does a CUDA graph
        (`utils/graphs.py`): while one is captured they are computed, and
        every replay computes them from the statistics as it finds them."""
        self._check_eval()
        tensors = self._params()
        if (torch.is_grad_enabled() or torch.compiler.is_compiling()
                or capturing() or any(t.is_inference() for t in tensors)):
            return self._scale_shift()
        key = tuple((t.data_ptr(), t._version) for t in tensors)
        if self._affine is None or self._affine[0] != key:
            self._affine = (key, self._scale_shift())
        return self._affine[1]

    def _scale_shift(self):
        scale = torch.rsqrt(self.running_var + self.eps)
        if self.scale is not None:
            scale = scale * self.scale
        return scale, torch.addcmul(self.bias, self.running_mean, scale,
                                    value=-1.0)

    @torch.no_grad()
    def reset_(self):
        """Flax's init: scale 1, bias 0, mean 0, var 1."""
        if self.scale is not None:
            self.scale.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


class ConvBN(nn.Module):
    """slim.conv2d + batch_norm (+ relu): TF-'SAME' or 'VALID' padding, no
    conv bias (Inception-v1's `ConvBNReLU`, v3/v4's `_Conv`, ResNet's
    `_ConvBN`)."""

    def __init__(self, in_ch: int, features: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: str = "SAME",
                 relu: bool = True, eps: float = 1e-3,
                 momentum: float = 0.9997, use_scale: bool = False):
        super().__init__()
        self.padding = padding
        self.relu = relu
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride,
                              bias=False)
        self.BatchNorm = BatchNorm(features, eps, momentum, use_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm(conv2d_tf(x, self.conv.weight, self.conv.stride,
                                        self.padding), relu=self.relu)


class ConvBias(nn.Module):
    """slim.conv2d with a bias and no BatchNorm or activation
    (`normalizer_fn=None, activation_fn=None`).  forward(x) is the conv
    without its bias; the caller adds `bias` (fp32), so that it can fold
    it into the op that follows: Inception-ResNet-v2's 1x1 "up" convs
    hand theirs to the residual join (`ops/residual_join.py`).  The weight
    and bias keep the names `conv.weight` and `conv.bias`;
    `fold_batch_norm` finds no BatchNorm beside the conv and leaves it
    alone, and the L2 term (`*.weight`) leaves the bias out."""

    def __init__(self, in_ch: int, features: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: str = "SAME"):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride,
                              bias=True)

    @property
    def bias(self) -> torch.Tensor:
        """The conv's bias in fp32, whatever `cast_convs_` made of it
        (serving casts it to the compute dtype)."""
        return self.conv.bias.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_tf(x, self.conv.weight, self.conv.stride, self.padding)
