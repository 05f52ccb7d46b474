"""The residual join of Inception-ResNet-v2's blocks as hand-written CUDA
kernels, with their plain PyTorch versions.

Replaces no TPU kernel: the JAX package has no Inception-ResNet-v2.  A
block of that backbone (slim's block35, block17 and block8) ends in

    net = act(net + scale * (W . concat(branches) + b))

where `W` is a 1x1 "up" conv with a bias `b` and no BatchNorm and `act` a
ReLU (none for the last block8).  The conv runs without its bias
(`layers.ConvBias`); the bias, the scale, the residual add and the ReLU
are this one op:

  `residual_join(x, u, bias, scale, relu)` -> y = relu?(x + scale * (u +
  bias)), x the block's input and u the conv's output (NCHW in shape, one
  dtype), bias per channel.

It is `gvcnn::residual_join`, with its fake and its gradient registered:
`gvcnn::residual_join_backward` (dy, y, scale, relu) -> (dx, du, dbias).
With the ReLU the forward saves y alone: its mask is y > 0, dx = dy where
it holds and 0 elsewhere, du = scale * dx, dbias = the sum of du over (N,
H, W).  Without the ReLU nothing is saved, dx is dy itself and the backward
op returns an empty dx.  Arithmetic in fp32 (in float64 for float64
tensors on the CPU): t = u + bias, v = x + scale * t, each rounded, then
the ReLU and one rounding into x's dtype; du = scale * dx rounded once,
dbias summed from the unrounded fp32 du (autograd's gradient through the
plain version).  The tensors are in the compute dtype, the bias and its
gradient fp32.

By x's device:

  CPU   the plain versions, `residual_join_plain` and
        `residual_join_backward_plain`, in x's layout;
  CUDA  the kernels (`csrc/residual_join.cu`), by x's dtype:
        bfloat16  `residual_join_fwd_bf16`, `residual_join_bwd_bf16`;
        float32   the same names ending in `_f32`;
        and `residual_join_bias_grad`, which sums the backward's
        per-block partials into dbias.

Any other dtype raises on a card.  There the kernels read and write
channels-last (NHWC in memory), which is how the port keeps its
activations, so making x, u, dy and y channels-last copies nothing on the
main path; the outputs keep x's (dy's) layout, channels-last or
contiguous, as train-mode BatchNorm's do.  A thread moves 16 bytes of
channels where C and every address allow it, one channel otherwise.  The
kernels compute the plain versions' y, dx and du bit for bit (the same fp32
operations, no fma contraction); dbias sums in another order.  It never
falls back to PyTorch's elementwise ops on a card.  The backward takes the
train-mode BatchNorm's plan (`batch_norm_kernel.plan`, at BLOCKS_AN_SM
blocks an SM): tiles of channel vectors by chunks of rows, a row of fp32
partials a block, summed in a fixed order by the bias-gradient kernel;
nothing is zeroed between launches, so a CUDA graph replays the join as it
is.
"""

from __future__ import annotations

from typing import Optional

import torch

from gvcnn_tf_tpu_torch.ops import _build
# The launch plan and the layout and dtype rules of train-mode BatchNorm's
# wrappers, which the join's kernels share.
from gvcnn_tf_tpu_torch.ops.batch_norm_kernel import (
    _channels_last,
    _layout,
    _suffix,
    plan,
)

# The backward's blocks an SM in `plan` (train-mode BatchNorm's kernels
# take 2); its blocks are the plan's 256 threads (`THREADS` in
# `csrc/residual_join.cu`, `MAX_THREADS` in the plan).
BLOCKS_AN_SM = 4


# ---------------------------------------------------------------------------
# The plain versions (CPU)
# ---------------------------------------------------------------------------


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def residual_join_plain(x: torch.Tensor, u: torch.Tensor,
                        bias: torch.Tensor, scale: float,
                        relu: bool) -> torch.Tensor:
    """relu?(x + scale * (u + bias)) in fp32 (float64 for float64 x), each
    operation rounded there, then one rounding into x's dtype: the forward
    kernel's plain version."""
    ct = _compute_dtype(x)
    t = u.to(ct) + bias.to(ct)[:, None, None]
    y = (x.to(ct) + scale * t).to(x.dtype)
    return torch.relu(y) if relu else y


def residual_join_backward_plain(dy: torch.Tensor, y: Optional[torch.Tensor],
                                 scale: float, relu: bool):
    """(dx, du, dbias): dx = dy where y > 0 and 0 elsewhere (`relu`; else
    None, dx being dy), du = scale * dx in fp32 rounded to dy's dtype,
    dbias its fp32 sum over (N, H, W) before that rounding: the backward
    kernels' plain version."""
    dx = torch.where(y > 0, dy, dy.new_zeros(())) if relu else None
    du = scale * (dy if dx is None else dx).to(_compute_dtype(dy))
    return dx, du.to(dy.dtype), du.sum((0, 2, 3))


# ---------------------------------------------------------------------------
# The kernels (CUDA)
# ---------------------------------------------------------------------------


def _like(name: str, x: torch.Tensor, t: torch.Tensor, what: str) -> None:
    if t.dtype != x.dtype or t.shape != x.shape or t.device != x.device:
        raise ValueError(f"{name}: {what} {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} against {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


def _empty(t: torch.Tensor, layout=torch.channels_last) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=t.device,
                       memory_format=layout)


def _lanes(x: torch.Tensor, *tensors) -> int:
    """16 bytes' worth of x's channels where C and every address allow it,
    else 1."""
    vec = 16 // x.element_size()
    if x.shape[1] % vec or any(t.data_ptr() % 16 for t in tensors):
        return 1
    return vec


def _forward(x, u, bias, scale, relu):
    """y in x's layout (`_layout`): the plain version on the CPU, the
    forward kernel on CUDA (on channels-last copies where x or u is not
    channels-last, and back)."""
    layout = _layout(x)
    if x.device.type == "cpu":
        return residual_join_plain(x, u, bias, scale, relu).contiguous(
            memory_format=layout)
    name = "residual_join_fwd_" + _suffix("residual_join", x)
    _like(name, x, u, "u")
    c = x.shape[1]
    if (bias.dtype != torch.float32 or bias.shape != (c,)
            or not bias.is_contiguous() or bias.device != x.device):
        raise ValueError(f"{name}: the bias must be float32 ({c},) "
                         f"contiguous on {x.device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    x, u = _channels_last(x), _channels_last(u)
    y = _empty(x)
    lanes = _lanes(x, x, u, y)
    _build.launch(name, x.device, x.data_ptr(), u.data_ptr(),
                  bias.data_ptr(), y.data_ptr(),
                  x.shape[0] * x.shape[2] * x.shape[3], c, lanes, scale,
                  int(relu))
    return y.contiguous(memory_format=layout)


def _backward(dy, y, scale, relu):
    """(dx or an empty tensor without the ReLU, du, dbias fp32), dx and du
    in dy's layout: the plain version on the CPU, the backward and
    bias-gradient kernels on CUDA."""
    layout = _layout(dy)
    if dy.device.type == "cpu":
        dx, du, db = residual_join_backward_plain(dy, y, scale, relu)
        return (dy.new_empty((0,)) if dx is None
                else dx.contiguous(memory_format=layout),
                du.contiguous(memory_format=layout), db)
    sfx = _suffix("residual_join_backward", dy)
    if relu:
        if y is None:
            raise ValueError("residual_join_backward: the ReLU's mask needs "
                             "the saved y")
        _like("residual_join_backward", dy, y, "y")
        y = _channels_last(y)
    dy = _channels_last(dy)
    n, c, h, w = dy.shape
    rows = n * h * w
    dx = _empty(dy) if relu else dy.new_empty((0,))
    du = _empty(dy)
    p = plan(rows, c, _lanes(dy, *((dy, du, dx, y) if relu else (dy, du))),
             torch.cuda.get_device_properties(
                 dy.device).multi_processor_count, BLOCKS_AN_SM)
    part = torch.empty(p.chunks * c, dtype=torch.float32, device=dy.device)
    db = torch.empty(c, dtype=torch.float32, device=dy.device)
    _build.launch("residual_join_bwd_" + sfx, dy.device, dy.data_ptr(),
                  y.data_ptr() if relu else None,
                  dx.data_ptr() if relu else None, du.data_ptr(),
                  part.data_ptr(), rows, c, p.lanes, p.tile_vectors,
                  p.chunk_rows, p.chunks, p.tiles, scale, int(relu))
    _build.launch("residual_join_bias_grad", dy.device, part.data_ptr(),
                  db.data_ptr(), c, p.chunks)
    return (dx.contiguous(memory_format=layout) if relu else dx,
            du.contiguous(memory_format=layout), db)


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------


def residual_join(x: torch.Tensor, u: torch.Tensor, bias: torch.Tensor,
                  scale: float, relu: bool) -> torch.Tensor:
    """relu?(x + scale * (u + bias)) of NCHW x and u: `gvcnn::residual_join`
    (see the module docstring)."""
    return torch.ops.gvcnn.residual_join(x, u, bias, scale, relu)


def _forward_fake(x, u, bias, scale, relu):
    return _empty(x, _layout(x))


def _backward_fake(dy, y, scale, relu):
    layout = _layout(dy)
    return (_empty(dy, layout) if relu else dy.new_empty((0,)),
            _empty(dy, layout),
            dy.new_empty((dy.shape[1],), dtype=_compute_dtype(dy)))


torch.library.define(
    "gvcnn::residual_join",
    "(Tensor x, Tensor u, Tensor bias, float scale, bool relu) -> Tensor")
torch.library.impl("gvcnn::residual_join", "default", _forward)
torch.library.register_fake("gvcnn::residual_join", _forward_fake)
torch.library.define(
    "gvcnn::residual_join_backward",
    "(Tensor dy, Tensor? y, float scale, bool relu) -> "
    "(Tensor, Tensor, Tensor)")
torch.library.impl("gvcnn::residual_join_backward", "default", _backward)
torch.library.register_fake("gvcnn::residual_join_backward", _backward_fake)


def _setup_context(ctx, inputs, output):
    _, _, _, scale, relu = inputs
    ctx.scale, ctx.relu = scale, relu
    if relu:
        ctx.save_for_backward(output)


def _join_backward(ctx, dy):
    """dx, du and dbias from dy and, with the ReLU, the saved y."""
    y = ctx.saved_tensors[0] if ctx.relu else None
    dx, du, db = torch.ops.gvcnn.residual_join_backward(dy, y, ctx.scale,
                                                        ctx.relu)
    return (dx if ctx.relu else dy), du, db, None, None


torch.library.register_autograd("gvcnn::residual_join", _join_backward,
                                setup_context=_setup_context)


def _no_second_derivative(ctx, *grads):
    raise NotImplementedError("gvcnn::residual_join_backward has no "
                              "gradient: the port takes no second derivative")


# Registered so that the backward op runs below autograd, as the forward
# does, and refuses a gradient instead of recording its plain version's ops.
torch.library.register_autograd(
    "gvcnn::residual_join_backward", _no_second_derivative,
    setup_context=lambda ctx, inputs, output: None)

