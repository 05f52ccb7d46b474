"""The Inception-v1 stem conv (7x7, stride 2, 3 -> 64 channels, TF-'SAME')
as hand-written CUDA kernels, with its plain PyTorch version.

Replaces the TPU kernel `gvcnn_tf_tpu/ops/pallas_stem.py::_stem_fwd`.  The
kernels are in `csrc/stem_conv.cu` (its source notes say what bounds each
on the H100 and what its design does about it), one for each compute
dtype, picked by x's dtype:

  bfloat16  `stem_conv7x7s2_bf16`, an implicit GEMM on the tensor cores,
            bf16 NHWC in, fp32 accumulation, bf16 NHWC out;
  float32   `stem_conv7x7s2_f32`, an implicit GEMM on the tensor cores in
            3xTF32 (each operand split into two TF32 parts, three
            products accumulated in fp32: fp32 accuracy), fp32 NHWC in,
            fp32 NHWC out.

Any other dtype raises; neither falls back to `F.conv2d` on a card.  Both
functions take the input NHWC (N, H, W, 3) and the weight in the port's
OIHW layout (64, 3, 7, 7), and return NHWC (N, ceil(H/2), ceil(W/2), 64);
a `.permute(0, 3, 1, 2)` of the result is a channels-last NCHW tensor, with
no copy.

Optional epilogue: a per-channel fp32 `scale` and `shift` and a `relu`
flag, out = relu(conv * scale + shift).  With scale = 1 / sqrt(var + eps)
and shift = bias - mean * scale it is eval-mode BatchNorm and its ReLU
(`BatchNorm.scale_shift`); the kernel applies it to the fp32 accumulator
and rounds once.

`stem_conv` is the `torch.library` op `gvcnn::stem_conv7x7s2`
(`torch.ops.gvcnn.stem_conv7x7s2`).  Its implementation, `_stem_forward`,
runs the plain version for a CPU tensor and for a CUDA tensor launches the
kernel of x's dtype or raises: it never falls back.  Its fake (shape-only)
implementation, which a `meta` tensor reaches too, gives a contiguous
(N, ceil(H/2), ceil(W/2), 64) tensor in x's dtype, so that `torch.export`
traces the op and an exported artifact calls it.  The packed weight is made
inside the implementation, so an artifact packs it at its first call and
keeps it as an eager forward does (`_packed_weight`) when run with grad
mode off.

Gradients (counterpart of `stem_conv`'s custom VJP, `pallas_stem.py:
145-164`, which is XLA's conv VJP and no Pallas kernel), registered on the
op: the forward saves x and the weight, and the backward is cuDNN's (on the
CPU, PyTorch's) gradient of the same stride-2 conv on the explicitly padded
input, `stem_conv_backward`: dw always, dx only when x needs one (for a
data input it is dead, as in JAX).  The only full-size tensor the backward
reads is the incoming gradient, used in place as a channels-last NCHW view
of the NHWC output; the padded copy of x is the input's size (3 channels).
The epilogue is eval-only: `stem_conv` with scale/shift or `relu` refuses
an input that needs a gradient (`Stem` runs its train-mode BatchNorm as its
own pass), and the op's backward raises after such a forward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gvcnn_tf_tpu_torch.ops import _build, capturing
from gvcnn_tf_tpu_torch.ops.pool import same_pads

KERNEL_NAME = "stem_conv7x7s2_bf16"
KERNEL_NAME_F32 = "stem_conv7x7s2_f32"
_KSIZE, _STRIDE, _CIN, _COUT = 7, 2, 3, 64
# The kernels' K layout: row kh * 24 + 3 * kw + c; rows kh * 24 + 21..23 are
# zero, so K = 168 is 21 fp32 (TF32) k-steps of 8, and with 8 more zero
# rows K = 176 is 11 bf16 k-steps of 16.
K_ROW, K_F32, K_PADDED = 24, 168, 176
# Widest output row the bf16 kernel's shared memory holds (csrc/stem_conv.cu:
# two 7-row input buffers beside 80,384 fixed bytes, 227 KB a block); the
# fp32 kernel cuts wider rows into strips.
MAX_OUT_WIDTH = 900


def pack_stem_weight(weight: torch.Tensor) -> torch.Tensor:
    """(64, 3, 7, 7) OIHW -> (176, 64), the kernel's B operand: row
    kh * 24 + 3 * kw + c holds weight[:, c, kh, kw]; the 3 rows after each
    kernel row's 21 taps and the last 8 rows are zeros."""
    taps = weight.permute(2, 3, 1, 0).reshape(_KSIZE, _KSIZE * _CIN, _COUT)
    packed = weight.new_zeros((K_PADDED, _COUT))
    packed[:_KSIZE * K_ROW].view(_KSIZE, K_ROW, _COUT)[:, :_KSIZE * _CIN] = taps
    return packed


def pack_stem_weight_f32(weight: torch.Tensor) -> torch.Tensor:
    """(64, 3, 7, 7) OIHW -> (168, 64), the fp32 kernel's B operand:
    `pack_stem_weight`'s first 168 rows (row kh * 24 + 3 * kw + c holds
    weight[:, c, kh, kw], the 3 rows after each kernel row's 21 taps are
    zeros)."""
    return pack_stem_weight(weight)[:K_F32]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, the low 13 bits zero: the plain version of the fp32 kernel's
    `cvt.rna.tf32.f32`.  Finite x only (the bits' carry rounds to the next
    binade, as the hardware does)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _packed_weight(weight: torch.Tensor) -> torch.Tensor:
    """The weight in the layout of its dtype's kernel (`pack_stem_weight`
    for bf16, `pack_stem_weight_f32` for fp32), kept on the weight while
    its storage and version counter stay the same and grad mode is off, so
    a serving forward pays no packing launches.  (Inside the op grad mode
    is off too, and the pack stays out of the autograd graph.)  While a
    CUDA graph is captured the pack is computed, not looked up, so the
    graph packs the weight as it finds it at every replay."""
    pack = (pack_stem_weight_f32 if weight.dtype == torch.float32
            else pack_stem_weight)
    if torch.is_grad_enabled() or weight.is_inference() or capturing():
        return pack(weight).contiguous()
    key = (weight.data_ptr(), weight._version)
    hit = getattr(weight, "_stem_packed", None)
    if hit is None or hit[0] != key:
        hit = weight._stem_packed = (key, pack(weight).contiguous())
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


# The kernel of each compute dtype: x's dtype picks it.
KERNELS = {torch.bfloat16: KERNEL_NAME, torch.float32: KERNEL_NAME_F32}


def kernel_name(dtype: torch.dtype) -> str:
    """The name of the kernel that takes `dtype`; raises for any other."""
    if dtype not in KERNELS:
        raise TypeError(f"stem_conv7x7s2: takes bfloat16 ({KERNEL_NAME}) "
                        f"or float32 ({KERNEL_NAME_F32}), got {dtype}")
    return KERNELS[dtype]


def _check_cuda_args(x, weight, scale, shift) -> str:
    """Raise on what the kernels do not take; the kernel's name."""
    name = kernel_name(x.dtype)
    if x.dim() != 4 or x.shape[-1] != _CIN:
        raise ValueError(f"{name}: x must be (N, H, W, 3), got "
                         f"{tuple(x.shape)}")
    if tuple(weight.shape) != (_COUT, _CIN, _KSIZE, _KSIZE):
        raise ValueError(f"{name}: weight must be (64, 3, 7, 7), got "
                         f"{tuple(weight.shape)}")
    if weight.dtype != x.dtype:
        raise TypeError(f"{name}: weight must be {x.dtype} like x, got "
                        f"{weight.dtype}")
    if weight.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, weight on "
                         f"{weight.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous NHWC")
    if x.dtype == torch.bfloat16 and -(-x.shape[2] // _STRIDE) > (
            MAX_OUT_WIDTH):
        raise ValueError(f"{name}: W = {x.shape[2]} is wider than "
                         f"the kernel takes ({2 * MAX_OUT_WIDTH})")
    affine = (scale, shift)
    if (scale is None) != (shift is None):
        raise ValueError(f"{name}: give both scale and shift, or neither")
    if scale is not None:
        for t in affine:
            if (t.shape != (_COUT,) or t.dtype != torch.float32
                    or t.device != x.device or not t.is_contiguous()):
                raise ValueError(
                    f"{name}: scale and shift must be contiguous "
                    f"float32 (64,) on {x.device}, got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device}")
    return name


def stem_conv(x: torch.Tensor, weight: torch.Tensor,
              scale: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None,
              relu: bool = False) -> torch.Tensor:
    """x (N, H, W, 3), weight (64, 3, 7, 7) -> (N, Ho, Wo, 64), NHWC, with
    the optional epilogue relu(conv * scale + shift).

    `gvcnn::stem_conv7x7s2`.  CPU: the plain version, in x's dtype.
    CUDA: the kernel of x's dtype (bf16 or fp32; another dtype raises).
    Where an input needs a gradient, the epilogue is refused.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, scale, shift)):
        if scale is not None or shift is not None or relu:
            raise NotImplementedError(
                f"{KERNEL_NAME}: the scale/shift/ReLU epilogue is eval-only "
                "and has no gradient; run the conv alone and BatchNorm after "
                "it (Stem does so in train mode)")
    return torch.ops.gvcnn.stem_conv7x7s2(x, weight, scale, shift, relu)


def _stem_forward(x, weight, scale=None, shift=None, relu=False):
    """The forward with no autograd: plain on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return stem_conv_plain(x, weight, scale, shift, relu)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL_NAME}: unsupported device {x.device}")
    name = _check_cuda_args(x, weight, scale, shift)
    n, h, w, _ = x.shape
    ho, wo = -(-h // _STRIDE), -(-w // _STRIDE)
    out = _empty_output(x)
    if out.numel() == 0:
        return out
    packed = _packed_weight(weight)
    _build.launch(
        name, x.device, x.data_ptr(), packed.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), out.data_ptr(),
        n, h, w, ho, wo, same_pads(h, _KSIZE, _STRIDE)[0],
        same_pads(w, _KSIZE, _STRIDE)[0], int(relu))
    return out


def _empty_output(x: torch.Tensor) -> torch.Tensor:
    """The (N, ceil(H/2), ceil(W/2), 64) NHWC output in x's dtype."""
    n, h, w, _ = x.shape
    return x.new_empty((n, -(-h // _STRIDE), -(-w // _STRIDE), _COUT))


def _stem_conv_op(x, weight, scale=None, shift=None, relu=False):
    """`gvcnn::stem_conv7x7s2`: `_stem_forward` as an operator."""
    return _stem_forward(x, weight, scale, shift, relu)


def _stem_conv_fake(x, weight, scale=None, shift=None, relu=False):
    return _empty_output(x)


torch.library.define("gvcnn::stem_conv7x7s2",
                     "(Tensor x, Tensor weight, Tensor? scale=None, "
                     "Tensor? shift=None, bool relu=False) -> Tensor")
torch.library.impl("gvcnn::stem_conv7x7s2", "default", _stem_conv_op)
torch.library.register_fake("gvcnn::stem_conv7x7s2", _stem_conv_fake)


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


def _setup_context(ctx, inputs, output):
    x, weight, scale, shift, relu = inputs
    ctx.epilogue = scale is not None or shift is not None or relu
    ctx.save_for_backward(x, weight)


def _backward(ctx, grad_out):
    if ctx.epilogue:
        raise NotImplementedError(
            f"{KERNEL_NAME}: the scale/shift/ReLU epilogue has no gradient")
    x, weight = ctx.saved_tensors
    need_dx, need_dw = ctx.needs_input_grad[:2]
    return (*stem_conv_backward(x, weight, grad_out, need_dx, need_dw),
            None, None, None)


torch.library.register_autograd("gvcnn::stem_conv7x7s2", _backward,
                                setup_context=_setup_context)
