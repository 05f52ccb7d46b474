"""Inception-v1 (GoogLeNet) backbone, slim-compatible (counterpart of
`gvcnn_tf_tpu/models/backbones/inception_v1.py`).

Same endpoint names, channel plan, BatchNorm eps (1e-3, no scale) and
TF-'SAME' padding as the JAX package, and module names that follow its
parameter tree, so that `bridge.py` maps one onto the other by path.

Layout: `InceptionV1Base` takes NHWC input (N, H, W, 3), as the JAX module
does.  The stem goes through `ops/stem_kernel.py`, which returns NHWC; its
permute is a channels-last NCHW tensor, and every later layer runs on NCHW
tensors (channels-last in memory on the card).  Endpoints are NCHW.

Dtypes: as `layers.py` says; the stem runs the bf16 or the fp32 kernel
with the input's dtype.

Train and eval mode follow the module's `training` flag: in train mode
BatchNorm normalizes with the batch's statistics and updates its running
statistics in place (Flax's `use_running_average=False`).

`remat_until` (the JAX module's selective remat): the plan's prefix through
that endpoint runs as one `layers.remat` region whenever a gradient is
being taken, so its activations are recomputed in the backward instead of
kept.  `stem_space_to_depth` (the JAX module's `SpaceToDepthStem`, a TPU
layout of the same conv with the same parameters): accepted, and the stem
runs as its kernel; like the JAX transform it takes even H and W only.

`start_endpoint` (the JAX module's segment towers, for the per-layer
attribution of `tools/bench_layers.py`): only the layers strictly after it
run, on the activation at it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from gvcnn_tf_tpu_torch.models.backbones.layers import (  # noqa: F401
    TRUNC_STDDEV,
    BatchNorm,
    ConvBN,
    remat,
    trunc_normal_,
)
from gvcnn_tf_tpu_torch.ops.pool import max_pool
from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv

# slim.conv2d + batch_norm + relu, TF-'SAME' padding, no conv bias, BN eps
# 1e-3 without a scale (inception_arg_scope): `ConvBN`'s defaults.
ConvBNReLU = ConvBN


class Stem(nn.Module):
    """Conv2d_1a_7x7 through the stem kernel (counterpart of `PallasStem`,
    the same parameters as a `ConvBNReLU(3, 64, 7x7, stride 2)`).

    NHWC (N, H, W, 3) in, NCHW out.  In eval mode with no gradient to
    take, the BatchNorm and the ReLU run as the kernel's epilogue
    (`BatchNorm.scale_shift`), so on the card the conv output is written
    once, in the compute dtype (both kernels on the tensor cores, the fp32
    one in 3xTF32); on the CPU the plain version applies
    the same affine in fp32 after the conv.  Otherwise (train mode: batch statistics; or a
    gradient is needed) the kernel runs without its epilogue, and BatchNorm
    with its ReLU follows (in train mode one op, `BatchNorm(y, relu=True)`)."""

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
            return self.BatchNorm(y, relu=True)
        scale, shift = self.BatchNorm.scale_shift()
        return stem_conv(x, w, scale, shift, relu=True).permute(0, 3, 1, 2)


class MaxPool(nn.Module):
    """A TF-'SAME' max pool of the plan as a layer of its own, with no
    parameters: its name is the endpoint's, as the JAX module runs each
    step of the plan in a named scope, so a per-layer tool sees the pool's
    ops under its endpoint (`tools/profile_step.py`)."""

    def __init__(self, kernel: Tuple[int, int], strides: Tuple[int, int]):
        super().__init__()
        self.kernel, self.strides = kernel, strides

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(x, self.kernel, self.strides)


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

    forward(x NHWC (N, H, W, 3)) -> (features NCHW, {endpoint: NCHW}).

    `start_endpoint` (an endpoint before `final_endpoint`, "" = the whole
    tower, as in `gvcnn_tf_tpu/models/backbones/inception_v1.py:361-366,
    469-479`): the module is a segment.  Its input is the activation at
    `start_endpoint` as the port's endpoints hold it, NCHW (N, C, H, W)
    (the JAX segment takes it NHWC), and only the layers strictly after it
    run, up to `final_endpoint`; the endpoints returned are the segment's.
    Its layers have the full tower's names, so its state_dict keys are a
    subset of the full tower's and the bridge loads it from the full
    tower's variables.  An unknown name, or a start that does not precede
    the final endpoint, raises ValueError, as in JAX.  With it:
    `remat_until` must name an endpoint of the segment (ValueError
    otherwise, as in JAX), and the region is the segment's layers through
    it; `stem_space_to_depth` raises ValueError, since a segment has no
    stem to run that way (the JAX module accepts the flag there and it has
    no effect; the port does not ignore a flag).

    `remat_until` (an endpoint of the plan, "" = off): while grad mode is
    on, the layers through it run as one `remat` region.  The region
    returns the boundary activation and, of its endpoints, only those in
    `keep` (None: all); a returned endpoint stays alive until the caller
    drops it, so a model passes the endpoints it reads and no others (the
    JAX module returns them all and XLA drops the unread ones)."""

    NAME = "InceptionV1"
    DEFAULT_RAW_ENDPOINT = "Mixed_3c"
    DEFAULT_FINAL_ENDPOINT = "Mixed_5c"
    DESCRIPTOR_DIM = 1024
    ENDPOINTS = ENDPOINTS
    ENDPOINT_CHANNELS = ENDPOINT_CHANNELS
    KERNEL_INIT = "trunc_normal"      # slim's trunc_normal(0.09)

    def __init__(self, final_endpoint: str = "Mixed_5c",
                 remat_until: str = "", stem_space_to_depth: bool = False,
                 keep: Optional[Sequence[str]] = None,
                 start_endpoint: str = ""):
        super().__init__()
        if final_endpoint not in ENDPOINTS:
            raise ValueError(f"unknown endpoint {final_endpoint!r}")
        start = 0
        if start_endpoint:
            if start_endpoint not in ENDPOINTS:
                raise ValueError(f"unknown endpoint {start_endpoint!r}")
            if (ENDPOINTS.index(start_endpoint)
                    >= ENDPOINTS.index(final_endpoint)):
                raise ValueError(
                    f"start_endpoint {start_endpoint!r} must precede "
                    f"final_endpoint {final_endpoint!r}")
            if stem_space_to_depth:
                raise ValueError(
                    f"stem_space_to_depth with start_endpoint "
                    f"{start_endpoint!r}: the segment has no stem")
            start = ENDPOINTS.index(start_endpoint) + 1
        self.final_endpoint = final_endpoint
        plan = _V1_PLAN[start:ENDPOINTS.index(final_endpoint) + 1]
        ch = ENDPOINT_CHANNELS[start_endpoint] if start_endpoint else 3
        for name, spec in plan:
            if name == "Conv2d_1a_7x7":
                self.add_module(name, Stem(spec[1]))
            elif spec[0] == "conv":
                self.add_module(name, ConvBNReLU(ch, spec[1], spec[2],
                                                 spec[3]))
            elif spec[0] == "pool":
                self.add_module(name, MaxPool(*spec[1:]))
            else:
                self.add_module(name, InceptionBlock(ch, *spec[1:]))
            ch = ENDPOINT_CHANNELS[name]
        self._names = [name for name, _ in plan]
        if remat_until and remat_until not in self._names:
            raise ValueError(f"remat_until {remat_until!r} not in the active "
                             f"plan {self._names}")
        self.remat_until = remat_until
        # The plan's layers [:_split] form the remat region.
        self._split = self._names.index(remat_until) + 1 if remat_until else 0
        self.stem_space_to_depth = stem_space_to_depth
        self.keep = None if keep is None else tuple(keep)

    def _run(self, x: torch.Tensor, names: Sequence[str]):
        endpoints: Dict[str, torch.Tensor] = {}
        for name in names:
            x = getattr(self, name)(x)
            endpoints[name] = x
        return x, endpoints

    def _prefix(self, x: torch.Tensor):
        """The remat region: the plan through `remat_until`; its boundary
        activation and the endpoints in `keep`."""
        x, endpoints = self._run(x, self._names[:self._split])
        if self.keep is not None:
            endpoints = {n: t for n, t in endpoints.items() if n in self.keep}
        return x, endpoints

    def forward(self, x: torch.Tensor):
        if self.stem_space_to_depth and (x.shape[1] % 2 or x.shape[2] % 2):
            raise ValueError(
                f"stem_space_to_depth takes even H and W, got "
                f"{tuple(x.shape[1:3])} (the JAX package's space-to-depth "
                "reshape needs them even)")
        if not (self.remat_until and torch.is_grad_enabled()
                and not torch.compiler.is_compiling()):
            return self._run(x, self._names)
        x, endpoints = remat(self._prefix, x)
        x, rest = self._run(x, self._names[self._split:])
        endpoints.update(rest)
        return x, endpoints
