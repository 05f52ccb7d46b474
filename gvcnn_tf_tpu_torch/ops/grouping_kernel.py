"""The GVCNN grouping head as a hand-written CUDA kernel, with its plain
PyTorch version.

Replaces the TPU kernel `gvcnn_tf_tpu/ops/pallas_grouping.py::
_pallas_forward`.  The kernel is `csrc/grouping.cu` (its source note says
what bounds it on the H100 and what the design does about it); the plain
version is `ops/grouping.py::group_and_fuse`.

The kernel's grid is (B, ceil(C / 128)) blocks, one channel a thread.

`group_and_fuse` is the `torch.library` op `gvcnn::group_and_fuse`
(`torch.ops.gvcnn.group_and_fuse`).  Its implementation, `_forward`, runs
the plain version for CPU tensors and for CUDA tensors launches the kernel
or raises: it never falls back.  Its fake (shape-only) implementation, which
`meta` tensors reach too, gives three contiguous fp32 tensors (B, C),
(B, M), (B, M, V), so that `torch.export` traces the op and an exported
artifact calls it.  Its gradient, registered on the op, is
the counterpart of `_make_fused_op`'s custom VJP (`pallas_grouping.py:
115-137`): the kernel is forward-only, as the Pallas kernel is, and the
backward replays the plain version's VJP from the saved scores and
descriptors.  That VJP keeps the scheme detached (it is marked
non-differentiable) and the straight-through ceil of `ceil_sum`.
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


def group_and_fuse(scores: torch.Tensor, descs: torch.Tensor, num_group: int,
                   weight_mode: str = "mean"):
    """scores (B, V), descs (B, V, C) -> (fused (B, C), weights (B, M),
    scheme (B, M, V)), all fp32: `gvcnn::group_and_fuse`, the plain version
    on the CPU, the kernel on CUDA."""
    return torch.ops.gvcnn.group_and_fuse(scores, descs, num_group,
                                          weight_mode)


def _forward(scores, descs, num_group, weight_mode):
    """The forward with no autograd: plain on the CPU, the kernel on CUDA;
    three contiguous outputs that share no memory."""
    if scores.device.type == "cpu":
        fused, weights, scheme = group_and_fuse_plain(scores, descs,
                                                      num_group, weight_mode)
        return fused, weights, scheme.contiguous()
    if scores.device.type != "cuda":
        raise ValueError(f"{KERNEL_NAME}: unsupported device {scores.device}")
    _check_cuda_args(scores, descs, num_group, weight_mode)
    fused, weights, scheme = _empty_outputs(scores, descs, num_group)
    b, v, c = descs.shape
    m = num_group
    if b == 0:
        return fused, weights, scheme
    _build.launch(KERNEL_NAME, scores.device, scores.data_ptr(),
                  descs.data_ptr(), fused.data_ptr(), weights.data_ptr(),
                  scheme.data_ptr(), b, v, c, m, _MODES[weight_mode])
    return fused, weights, scheme


def _empty_outputs(scores, descs, num_group):
    """fused (B, C), weights (B, M), scheme (B, M, V): fp32, contiguous,
    each its own allocation (an operator's outputs may not alias)."""
    b, v, c = descs.shape
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=descs.device)
    return new(b, c), new(b, num_group), new(b, num_group, v)


def _group_and_fuse_op(scores, descs, num_group, weight_mode):
    """`gvcnn::group_and_fuse`: `_forward` as an operator."""
    return _forward(scores, descs, num_group, weight_mode)


def _group_and_fuse_fake(scores, descs, num_group, weight_mode):
    return _empty_outputs(scores, descs, num_group)


torch.library.define("gvcnn::group_and_fuse",
                     "(Tensor scores, Tensor descs, SymInt num_group, "
                     "str weight_mode) -> (Tensor, Tensor, Tensor)")
torch.library.impl("gvcnn::group_and_fuse", "default", _group_and_fuse_op)
torch.library.register_fake("gvcnn::group_and_fuse", _group_and_fuse_fake)


def _setup_context(ctx, inputs, output):
    scores, descs, ctx.num_group, ctx.weight_mode = inputs
    ctx.save_for_backward(scores, descs)
    ctx.mark_non_differentiable(output[2])


def _backward(ctx, d_fused, d_weights, d_scheme):
    """The plain version's VJP at the saved scores and descriptors; the
    scheme's cotangent is accepted and is zero by construction."""
    scores, descs = ctx.saved_tensors
    with torch.enable_grad():
        s = scores.detach().requires_grad_()
        d = descs.detach().requires_grad_()
        fused, weights, _ = group_and_fuse_plain(s, d, ctx.num_group,
                                                 ctx.weight_mode)
        ds, dd = torch.autograd.grad((fused, weights), (s, d),
                                     (d_fused, d_weights))
    return ds, dd, None, None


torch.library.register_autograd("gvcnn::group_and_fuse", _backward,
                                setup_context=_setup_context)
