"""The Inception-v1 stem conv (7x7, stride 2, 3 -> 64 channels, TF-'SAME')
as a hand-written CUDA kernel, with its plain PyTorch version.

Replaces the TPU kernel `gvcnn_tf_tpu/ops/pallas_stem.py::_stem_fwd`.  The
kernel is `csrc/stem_conv.cu` (its source note says what bounds it on the
H100 and what the design does about it): an implicit GEMM on the tensor
cores, bf16 NHWC in, fp32 accumulation, bf16 NHWC out.  Both functions take
the input NHWC (N, H, W, 3) and the weight in the port's OIHW layout
(64, 3, 7, 7), and return NHWC (N, ceil(H/2), ceil(W/2), 64); a
`.permute(0, 3, 1, 2)` of the result is a channels-last NCHW tensor, with
no copy.

Optional epilogue: a per-channel fp32 `scale` and `shift` and a `relu`
flag, out = relu(conv * scale + shift).  With scale = 1 / sqrt(var + eps)
and shift = bias - mean * scale it is eval-mode BatchNorm and its ReLU
(`BatchNorm.scale_shift`); the kernel applies it to the fp32 accumulator
and rounds once.

`stem_conv` runs the plain version for a CPU tensor only.  For a CUDA tensor
it launches the kernel or raises: it never falls back.

Gradients (counterpart of `stem_conv`'s custom VJP, `pallas_stem.py:
145-164`, which is XLA's conv VJP and no Pallas kernel): where x or the
weight needs a gradient, `stem_conv` goes through `StemConvFunction`.  Its
forward is the kernel (the plain version for a CPU tensor) without the
epilogue; its backward is cuDNN's (on the CPU, PyTorch's) gradient of the
same stride-2 conv on the explicitly padded input,
`aten.convolution_backward`: dw always, dx only when x needs one (for a
data input it is dead, as in JAX).  The only full-size tensor the backward
reads is the incoming gradient, used in place as a channels-last NCHW view
of the NHWC output; the padded copy of x is the input's size (3 channels).
The epilogue is eval-only: a call with scale/shift that needs a gradient
raises (`Stem` runs its train-mode BatchNorm as its own pass).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gvcnn_tf_tpu_torch.ops import _build
from gvcnn_tf_tpu_torch.ops.pool import same_pads

KERNEL_NAME = "stem_conv7x7s2_bf16"
_KSIZE, _STRIDE, _CIN, _COUT = 7, 2, 3, 64
# The kernel's K layout: row kh * 24 + 3 * kw + c; rows kh * 24 + 21..23 and
# 168..175 are zero, so K = 176 is 11 tensor-core k-steps of 16.
K_ROW, K_PADDED = 24, 176
# Widest output row the kernel's shared memory holds (csrc/stem_conv.cu:
# two 7-row input buffers beside 80,384 fixed bytes, 227 KB a block).
MAX_OUT_WIDTH = 900


def pack_stem_weight(weight: torch.Tensor) -> torch.Tensor:
    """(64, 3, 7, 7) OIHW -> (176, 64), the kernel's B operand: row
    kh * 24 + 3 * kw + c holds weight[:, c, kh, kw]; the 3 rows after each
    kernel row's 21 taps and the last 8 rows are zeros."""
    taps = weight.permute(2, 3, 1, 0).reshape(_KSIZE, _KSIZE * _CIN, _COUT)
    packed = weight.new_zeros((K_PADDED, _COUT))
    packed[:_KSIZE * K_ROW].view(_KSIZE, K_ROW, _COUT)[:, :_KSIZE * _CIN] = taps
    return packed


def _packed_weight(weight: torch.Tensor) -> torch.Tensor:
    """pack_stem_weight(weight), kept on the weight while its storage and
    version counter stay the same and grad mode is off, so a serving
    forward pays no packing launches.  (Inside `StemConvFunction.forward`
    grad mode is off too, and the pack stays out of the autograd graph.)"""
    if torch.is_grad_enabled() or weight.is_inference():
        return pack_stem_weight(weight)
    key = (weight.data_ptr(), weight._version)
    hit = getattr(weight, "_stem_packed", None)
    if hit is None or hit[0] != key:
        hit = weight._stem_packed = (key, pack_stem_weight(weight))
    return hit[1]


def stem_conv_plain(x: torch.Tensor, weight: torch.Tensor,
                    scale: Optional[torch.Tensor] = None,
                    shift: Optional[torch.Tensor] = None,
                    relu: bool = False) -> torch.Tensor:
    """`F.conv2d` on explicitly TF-'SAME'-padded input, in x's dtype; then,
    if given, the affine in fp32 and the ReLU, returned in x's dtype."""
    ph = same_pads(x.shape[1], _KSIZE, _STRIDE)
    pw = same_pads(x.shape[2], _KSIZE, _STRIDE)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xn, weight.to(x.dtype), stride=_STRIDE).permute(0, 2, 3, 1)
    if scale is not None:
        y = (y.float() * scale + shift).to(x.dtype)
    return F.relu(y) if relu else y


def _check_cuda_args(x, weight, scale, shift):
    if x.dim() != 4 or x.shape[-1] != _CIN:
        raise ValueError(f"{KERNEL_NAME}: x must be (N, H, W, 3), got "
                         f"{tuple(x.shape)}")
    if tuple(weight.shape) != (_COUT, _CIN, _KSIZE, _KSIZE):
        raise ValueError(f"{KERNEL_NAME}: weight must be (64, 3, 7, 7), got "
                         f"{tuple(weight.shape)}")
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(f"{KERNEL_NAME}: takes bfloat16, got {x.dtype} and "
                        f"{weight.dtype}")
    if weight.device != x.device:
        raise ValueError(f"{KERNEL_NAME}: x on {x.device}, weight on "
                         f"{weight.device}")
    if not x.is_contiguous():
        raise ValueError(f"{KERNEL_NAME}: x must be contiguous NHWC")
    if -(-x.shape[2] // _STRIDE) > MAX_OUT_WIDTH:
        raise ValueError(f"{KERNEL_NAME}: W = {x.shape[2]} is wider than "
                         f"the kernel takes ({2 * MAX_OUT_WIDTH})")
    affine = (scale, shift)
    if (scale is None) != (shift is None):
        raise ValueError(f"{KERNEL_NAME}: give both scale and shift, or "
                         "neither")
    if scale is not None:
        for t in affine:
            if (t.shape != (_COUT,) or t.dtype != torch.float32
                    or t.device != x.device or not t.is_contiguous()):
                raise ValueError(
                    f"{KERNEL_NAME}: scale and shift must be contiguous "
                    f"float32 (64,) on {x.device}, got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device}")


def stem_conv(x: torch.Tensor, weight: torch.Tensor,
              scale: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None,
              relu: bool = False) -> torch.Tensor:
    """x (N, H, W, 3), weight (64, 3, 7, 7) -> (N, Ho, Wo, 64), NHWC, with
    the optional epilogue relu(conv * scale + shift).

    CPU: the plain version, in x's dtype.  CUDA: the kernel, bf16 only.
    Where x or the weight needs a gradient: `StemConvFunction` (no
    epilogue).
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, scale, shift)):
        if scale is not None or shift is not None or relu:
            raise NotImplementedError(
                f"{KERNEL_NAME}: the scale/shift/ReLU epilogue is eval-only "
                "and has no gradient; run the conv alone and BatchNorm after "
                "it (Stem does so in train mode)")
        return StemConvFunction.apply(x, weight)
    return _stem_forward(x, weight, scale, shift, relu)


def _stem_forward(x, weight, scale=None, shift=None, relu=False):
    """The forward with no autograd: plain on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return stem_conv_plain(x, weight, scale, shift, relu)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL_NAME}: unsupported device {x.device}")
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _stem_forward(x, weight, scale, shift, relu)
    _check_cuda_args(x, weight, scale, shift)
    n, h, w, _ = x.shape
    ho, wo = -(-h // _STRIDE), -(-w // _STRIDE)
    out = torch.empty((n, ho, wo, _COUT), dtype=torch.bfloat16,
                      device=x.device)
    if out.numel() == 0:
        return out
    packed = _packed_weight(weight)
    code = _build.library().stem_conv7x7s2_bf16(
        x.data_ptr(), packed.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), out.data_ptr(),
        n, h, w, ho, wo, same_pads(h, _KSIZE, _STRIDE)[0],
        same_pads(w, _KSIZE, _STRIDE)[0], int(relu),
        torch.cuda.current_stream().cuda_stream)
    _build.check(code, KERNEL_NAME)
    stem_conv.launches += 1
    return out


stem_conv.launches = 0


def stem_conv_backward(x: torch.Tensor, weight: torch.Tensor,
                       grad_out: torch.Tensor, need_dx: bool = False,
                       need_dw: bool = True):
    """(dx or None, dw or None) of the stem conv at x (N, H, W, 3) NHWC,
    weight (64, 3, 7, 7), for grad_out (N, Ho, Wo, 64) NHWC: the reference
    conv's VJP, one `aten.convolution_backward` on the TF-'SAME'-padded
    input, in x's dtype (cuDNN accumulates bf16 in fp32).  dw comes back
    in the weight's dtype, dx as NHWC."""
    h, w = x.shape[1], x.shape[2]
    ph = same_pads(h, _KSIZE, _STRIDE)
    pw = same_pads(w, _KSIZE, _STRIDE)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    wx = weight.to(x.dtype)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        grad_out.to(x.dtype).permute(0, 3, 1, 2), xn, wx, None,
        [_STRIDE, _STRIDE], [0, 0], [1, 1], False, [0, 0], 1,
        [need_dx, need_dw, False])
    if dx is not None:
        dx = dx[:, :, ph[0]:ph[0] + h, pw[0]:pw[0] + w].permute(0, 2, 3, 1)
    if dw is not None:
        dw = dw.to(weight.dtype)
    return dx, dw


class StemConvFunction(torch.autograd.Function):
    """The stem conv under autograd: the kernel forward (plain for a CPU
    tensor), the reference conv's VJP backward (`stem_conv_backward`)."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return _stem_forward(x, weight)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad
        return stem_conv_backward(x, weight, grad_out, need_dx, need_dw)
