"""The GVCNN grouping head as a hand-written CUDA kernel, with its plain
PyTorch version.

Replaces the TPU kernel `gvcnn_tf_tpu/ops/pallas_grouping.py::
_pallas_forward`.  The kernel is `csrc/grouping.cu` (its source note says
what bounds it on the H100 and what the design does about it); the plain
version is `ops/grouping.py::group_and_fuse`.

The kernel's grid is (B, ceil(C / 128)) blocks, one channel a thread.
`group_and_fuse` runs the plain version for CPU tensors only (and for
`meta` tensors, which have shapes and no data).  For CUDA tensors it
launches the kernel or raises: it never falls back.

Gradients: the kernel is forward-only, as the Pallas kernel is.  Where the
scores or the descriptors need a gradient, `group_and_fuse` goes through
`GroupAndFuseFunction`, the counterpart of `_make_fused_op`'s custom VJP
(`pallas_grouping.py:115-137`): the kernel forward (the plain version for a
CPU tensor), and a backward that replays the plain version's VJP from the
saved scores and descriptors.  That VJP keeps the scheme detached and the
straight-through ceil of `ceil_sum`; the scheme's cotangent is accepted
and is zero by construction.

As an operator: `gvcnn::group_and_fuse` (`torch.ops.gvcnn.group_and_fuse`)
is the same forward as a `torch.library` custom op, so that `torch.export`
can trace it (a traced tensor has no data pointer to launch with) and an
exported artifact calls it: its CPU and CUDA implementation is `_forward`,
its fake (shape-only) implementation gives three contiguous fp32 tensors
(B, C), (B, M), (B, M, V).  `group_and_fuse` reaches the op only while
tracing (`torch.compiler.is_compiling()`) or under a Python dispatch mode
(`ops.as_operator`; `GroupAndFuseFunction.forward` too); an eager call
goes to `_forward` directly and pays no dispatch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gvcnn_tf_tpu_torch.ops import _build, as_operator
from gvcnn_tf_tpu_torch.ops.grouping import group_and_fuse as group_and_fuse_plain

KERNEL_NAME = "group_and_fuse_f32"
MAX_VIEWS = 16
MAX_GROUPS = 16
_MODES = {"mean": 0, "ceil_sum": 1}

__all__ = ["GroupAndFuseFunction", "group_and_fuse", "group_and_fuse_plain"]


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


def group_and_fuse(scores: torch.Tensor, descs: torch.Tensor, num_group: int,
                   weight_mode: str = "mean"):
    """scores (B, V), descs (B, V, C) -> (fused (B, C), weights (B, M),
    scheme (B, M, V)), all fp32 on CUDA.

    CPU: the plain version.  CUDA: the kernel.  Where an input needs a
    gradient: `GroupAndFuseFunction`.
    """
    if torch.is_grad_enabled() and (scores.requires_grad
                                    or descs.requires_grad):
        return GroupAndFuseFunction.apply(scores, descs, num_group,
                                          weight_mode)
    if as_operator():
        return torch.ops.gvcnn.group_and_fuse(scores, descs, num_group,
                                              weight_mode)
    return _forward(scores, descs, num_group, weight_mode)


def _forward(scores, descs, num_group, weight_mode):
    """The forward with no autograd: plain on the CPU, the kernel on CUDA;
    three contiguous outputs that share no memory."""
    if scores.device.type in ("cpu", "meta"):
        fused, weights, scheme = group_and_fuse_plain(scores, descs,
                                                      num_group, weight_mode)
        return fused, weights, scheme.contiguous()
    if scores.device.type != "cuda":
        raise ValueError(f"{KERNEL_NAME}: unsupported device {scores.device}")
    if scores.device.index != torch.cuda.current_device():
        with torch.cuda.device(scores.device):
            return _forward(scores, descs, num_group, weight_mode)
    _check_cuda_args(scores, descs, num_group, weight_mode)
    fused, weights, scheme = _empty_outputs(scores, descs, num_group)
    b, v, c = descs.shape
    m = num_group
    if b == 0:
        return fused, weights, scheme
    code = _build.library().group_and_fuse_f32(
        scores.data_ptr(), descs.data_ptr(), fused.data_ptr(),
        weights.data_ptr(), scheme.data_ptr(), b, v, c, m,
        _MODES[weight_mode], torch.cuda.current_stream().cuda_stream)
    _build.check(code, KERNEL_NAME)
    group_and_fuse.launches += 1
    return fused, weights, scheme


group_and_fuse.launches = 0


def _empty_outputs(scores, descs, num_group):
    """fused (B, C), weights (B, M), scheme (B, M, V): fp32, contiguous,
    each its own allocation (an operator's outputs may not alias)."""
    b, v, c = descs.shape
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=descs.device)
    return new(b, c), new(b, num_group), new(b, num_group, v)


@torch.library.custom_op("gvcnn::group_and_fuse", mutates_args=())
def group_and_fuse_op(scores: torch.Tensor, descs: torch.Tensor,
                      num_group: int, weight_mode: str
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`gvcnn::group_and_fuse`: `_forward` as an operator (no autograd)."""
    return _forward(scores, descs, num_group, weight_mode)


@group_and_fuse_op.register_fake
def _group_and_fuse_fake(scores, descs, num_group, weight_mode):
    return _empty_outputs(scores, descs, num_group)


class GroupAndFuseFunction(torch.autograd.Function):
    """The grouping head under autograd: the kernel forward (plain for a CPU
    tensor), the plain version's VJP as the backward."""

    @staticmethod
    def forward(ctx, scores, descs, num_group, weight_mode):
        ctx.save_for_backward(scores, descs)
        ctx.num_group, ctx.weight_mode = num_group, weight_mode
        if as_operator():
            fused, weights, scheme = torch.ops.gvcnn.group_and_fuse(
                scores, descs, num_group, weight_mode)
        else:
            fused, weights, scheme = _forward(scores, descs, num_group,
                                              weight_mode)
        ctx.mark_non_differentiable(scheme)
        return fused, weights, scheme

    @staticmethod
    def backward(ctx, d_fused, d_weights, d_scheme):
        scores, descs = ctx.saved_tensors
        with torch.enable_grad():
            s = scores.detach().requires_grad_()
            d = descs.detach().requires_grad_()
            fused, weights, _ = group_and_fuse_plain(s, d, ctx.num_group,
                                                     ctx.weight_mode)
            ds, dd = torch.autograd.grad((fused, weights),
                                         (s, d), (d_fused, d_weights))
        return ds, dd, None, None
