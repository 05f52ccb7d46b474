"""The Inception-v1 stem conv (7x7, stride 2, 3 -> 64 channels, TF-'SAME')
as a hand-written CUDA kernel, with its plain PyTorch version.

Replaces the TPU kernel `gvcnn_tf_tpu/ops/pallas_stem.py::_stem_fwd`.  The
kernel is `csrc/stem_conv.cu` (its source note says what bounds it on the
H100 and what the design does about it): bf16 NHWC in, fp32 accumulation,
bf16 NHWC out.  Both functions take the input NHWC (N, H, W, 3) and the
weight in the port's OIHW layout (64, 3, 7, 7), and return NHWC
(N, ceil(H/2), ceil(W/2), 64); a `.permute(0, 3, 1, 2)` of the result is a
channels-last NCHW tensor, with no copy.

`stem_conv` runs the plain version for a CPU tensor only.  For a CUDA tensor
it launches the kernel or raises: it never falls back.  The backward pass
is not ported (training comes later), so a CUDA call that would need a
gradient raises too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gvcnn_tf_tpu_torch.ops import _build
from gvcnn_tf_tpu_torch.ops.pool import same_pads

KERNEL_NAME = "stem_conv7x7s2_bf16"
_KSIZE, _STRIDE, _CIN, _COUT = 7, 2, 3, 64


def stem_conv_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """`F.conv2d` on explicitly TF-'SAME'-padded input, in x's dtype."""
    ph = same_pads(x.shape[1], _KSIZE, _STRIDE)
    pw = same_pads(x.shape[2], _KSIZE, _STRIDE)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xn, weight.to(x.dtype), stride=_STRIDE)
    return y.permute(0, 2, 3, 1)


def _check_cuda_args(x: torch.Tensor, weight: torch.Tensor):
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
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise NotImplementedError(
            f"{KERNEL_NAME}: the backward pass is not ported yet (ROADMAP "
            "§2, K2 backward); call it under torch.inference_mode()")


def stem_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, 3), weight (64, 3, 7, 7) -> (N, Ho, Wo, 64), NHWC.

    CPU: the plain version, in x's dtype.  CUDA: the kernel, bf16 only.
    """
    if x.device.type == "cpu":
        return stem_conv_plain(x, weight)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL_NAME}: unsupported device {x.device}")
    _check_cuda_args(x, weight)
    n, h, w, _ = x.shape
    ho, wo = -(-h // _STRIDE), -(-w // _STRIDE)
    out = torch.empty((n, ho, wo, _COUT), dtype=torch.bfloat16,
                      device=x.device)
    if out.numel() == 0:
        return out
    # (64, 3, 7, 7) -> (7, 7, 3, 64) -> (147, 64): row (kh * 7 + kw) * 3 + c.
    w147 = weight.permute(2, 3, 1, 0).reshape(_KSIZE * _KSIZE * _CIN, _COUT)
    w147 = w147.contiguous()
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.stem_conv7x7s2_bf16(
            x.data_ptr(), w147.data_ptr(), out.data_ptr(), n, h, w, ho, wo,
            same_pads(h, _KSIZE, _STRIDE)[0], same_pads(w, _KSIZE, _STRIDE)[0],
            stream)
    _build.check(code, KERNEL_NAME)
    stem_conv.launches += 1
    return out


stem_conv.launches = 0
