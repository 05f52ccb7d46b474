"""The GVCNN grouping head as a hand-written CUDA kernel, with its plain
PyTorch version.

Replaces the TPU kernel `gvcnn_tf_tpu/ops/pallas_grouping.py::
_pallas_forward`.  The kernel is `csrc/grouping.cu` (its source note says
what bounds it on the H100 and what the design does about it); the plain
version is `ops/grouping.py::group_and_fuse`.

`group_and_fuse` runs the plain version for CPU tensors only.  For CUDA
tensors it launches the kernel or raises: it never falls back.  The kernel
is forward-only; the backward pass comes with training, so a CUDA call that
would need a gradient raises.
"""

from __future__ import annotations

import torch

from gvcnn_tf_tpu_torch.ops import _build
from gvcnn_tf_tpu_torch.ops.grouping import group_and_fuse as group_and_fuse_plain

KERNEL_NAME = "group_and_fuse_f32"
MAX_VIEWS = 16
MAX_GROUPS = 16
_MODES = {"mean": 0, "ceil_sum": 1}

__all__ = ["group_and_fuse", "group_and_fuse_plain"]


def _check_cuda_args(scores, descs, num_group, weight_mode):
    if scores.dim() != 2 or descs.dim() != 3 or descs.shape[:2] != scores.shape:
        raise ValueError(f"{KERNEL_NAME}: scores (B, V) and descs (B, V, C) "
                         f"expected, got {tuple(scores.shape)} and "
                         f"{tuple(descs.shape)}")
    v = scores.shape[1]
    if not (1 <= v <= MAX_VIEWS and 1 <= num_group <= MAX_GROUPS):
        raise ValueError(f"{KERNEL_NAME}: needs 1 <= V <= {MAX_VIEWS} and "
                         f"1 <= M <= {MAX_GROUPS}, got V={v} M={num_group}")
    if weight_mode not in _MODES:
        raise ValueError(f"unknown group weight mode {weight_mode!r}")
    if scores.dtype != torch.float32 or descs.dtype != torch.float32:
        raise TypeError(f"{KERNEL_NAME}: takes float32, got {scores.dtype} "
                        f"and {descs.dtype}")
    if descs.device != scores.device:
        raise ValueError(f"{KERNEL_NAME}: scores on {scores.device}, descs "
                         f"on {descs.device}")
    if not (scores.is_contiguous() and descs.is_contiguous()):
        raise ValueError(f"{KERNEL_NAME}: inputs must be contiguous")
    if torch.is_grad_enabled() and (scores.requires_grad
                                    or descs.requires_grad):
        raise NotImplementedError(
            f"{KERNEL_NAME}: the backward pass is not ported yet (ROADMAP "
            "§2, K1 backward); call it under torch.inference_mode()")


def group_and_fuse(scores: torch.Tensor, descs: torch.Tensor, num_group: int,
                   weight_mode: str = "mean"):
    """scores (B, V), descs (B, V, C) -> (fused (B, C), weights (B, M),
    scheme (B, M, V)), all fp32 on CUDA.

    CPU: the plain version.  CUDA: the kernel.
    """
    if scores.device.type == "cpu":
        return group_and_fuse_plain(scores, descs, num_group, weight_mode)
    if scores.device.type != "cuda":
        raise ValueError(f"{KERNEL_NAME}: unsupported device {scores.device}")
    _check_cuda_args(scores, descs, num_group, weight_mode)
    b, v, c = descs.shape
    kw = dict(dtype=torch.float32, device=descs.device)
    fused = torch.empty((b, c), **kw)
    weights = torch.empty((b, num_group), **kw)
    scheme = torch.empty((b, num_group, v), **kw)
    if b == 0:
        return fused, weights, scheme
    lib = _build.library()
    with torch.cuda.device(descs.device):
        stream = torch.cuda.current_stream(descs.device).cuda_stream
        code = lib.group_and_fuse_f32(
            scores.data_ptr(), descs.data_ptr(), fused.data_ptr(),
            weights.data_ptr(), scheme.data_ptr(), b, v, c, num_group,
            _MODES[weight_mode], stream)
    _build.check(code, KERNEL_NAME)
    group_and_fuse.launches += 1
    return fused, weights, scheme


group_and_fuse.launches = 0
