"""The TF-'SAME' / 'VALID' max pool and the 3x3/1 'SAME' average pool as
hand-written CUDA kernels, with their plain PyTorch versions.

Replace no TPU kernel: the JAX package leaves pooling to XLA
(`flax.linen.max_pool` / `avg_pool`, reduce_window; the max pool's gradient
select_and_scatter).  The average pool is at the end of this docstring.
The kernels are in `csrc/max_pool.cu` (its source note says what bounds
them on the H100 and what their design does about it); x's dtype picks
them:

  bfloat16  `max_pool_same_fwd_bf16`, `max_pool_same_bwd_bf16`;
  float32   `max_pool_same_fwd_f32`, `max_pool_same_bwd_f32`.

Any other dtype raises.  They take k x k windows at stride s with (k, s) in
{(3, 2), (3, 1), (2, 2)}, every pool of the port's backbones, and any
other geometry raises on a card.  Tensors are NCHW in shape; on the card
the kernels read and write them channels-last (NHWC in memory), which is
how the port keeps its activations, so the `.contiguous(memory_format=
torch.channels_last)` of x and dy copies nothing on the main paths.  A
thread moves 16 bytes of channels at a time, so on a card C has to be a
multiple of 8 (bfloat16) or 4 (float32) and the data 16-byte aligned;
every pool of the backbones has C a multiple of 64 and its input from the
allocator, and anything else raises.

`max_pool_same(x, kernel, strides, pads)`, pads ((top, bottom), (left,
right)) as `pool._pads` gives them:

  CPU (and `meta`)  `max_pool_plain`, `F.pad` with -inf where the pads are
                    asymmetric and `F.max_pool2d`, under autograd;
  CUDA              the forward kernel, which pads inside itself (a tap
                    outside the image is no candidate).  Where x needs a
                    gradient (grad mode on), through `MaxPoolFunction`: the
                    forward also writes a one-byte record, the window slot
                    (0 .. k*k-1, row-major) of each output's first maximum,
                    and the backward kernel gathers dy into dx from it.
                    Nothing else is saved for the backward: neither x nor
                    a padded copy.  Under `no_grad` (eval, serving, their
                    graphs) the forward writes the output alone.

It never falls back to `F.max_pool2d` on a card.  `max_pool_same.launches`
counts the forward kernel's launches, `max_pool_same.launches_bwd` the
backward's.

Ties go to the first maximum in row-major window order and a window that
holds a NaN gives NaN, its first NaN winning, as `F.max_pool2d` and XLA's
select-and-scatter do; a window whose taps are all -inf credits its first
in-image tap.  The kernel's output equals `F.max_pool2d`'s value for value
(where -0.0 and +0.0 tie for the maximum it may give either zero).
`max_pool_record_plain` and `max_pool_backward_plain` are the kernels'
plain versions under the same rules (the backward sums in fp32 and rounds
once, as the kernel does, in another order).

As operators: `gvcnn::max_pool_same` (x, kernel, strides, pads as [top,
bottom, left, right], record) -> (y, slot; an empty uint8 tensor without
the record) and `gvcnn::max_pool_same_backward`, so that `torch.export`
traces them (a traced tensor has no data pointer to launch with) and an
artifact calls them, and a dispatch mode sees them as one op each
(`ops.as_operator`, as for `gvcnn::stem_conv7x7s2`).  Their CPU and CUDA
implementation is `_forward` / `_backward`; their outputs are
channels-last on every device, and so are their fake (shape-only) ones.
An eager call reaches neither op and pays no dispatch.

The average pool, `avg_pool_same(x)`: the one geometry of the port's
backbones, a 3x3 window at stride 1 with TF-'SAME' pads (1, 1) on both
dims, as Flax's `avg_pool` with `count_include_pad=True` (the padded zeros
count in every window's mean), which the port follows.  The kernels
(`csrc/avg_pool.cu`: `avg_pool_same_fwd_{bf16,f32}` and
`avg_pool_same_bwd_{bf16,f32}`) take the same dtypes, layout and 16-byte
channel vectors as the max pool's; anything else raises on a card.

  CPU (and `meta`)  `avg_pool_plain`: `F.avg_pool2d` counting the pads,
                    under autograd;
  CUDA              the forward kernel, or where x needs a gradient
                    `AvgPoolFunction`, whose backward is the same box mean
                    over dy (`avg_pool_backward_plain` is its plain
                    version): at stride 1 with symmetric pads the windows
                    that hold an input are the outputs around it, so dx =
                    boxsum3x3(dy) / 9 with zero padding, and nothing is
                    saved for the backward.

Both sum in fp32, divide by 9 and round once (as PyTorch's kernel does, in
another order).  It never falls back to `F.avg_pool2d` on a card.
`avg_pool_same.launches` counts the forward kernel's launches,
`avg_pool_same.launches_bwd` the backward's.  The operators
`gvcnn::avg_pool_same` (x) and `gvcnn::avg_pool_same_backward` (dy) are
the 3x3/1 'SAME' pool and its backward, for `torch.export` and dispatch
modes as above, with channels-last outputs and fake outputs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from gvcnn_tf_tpu_torch.ops import _build, as_operator

# (kernel, stride) of one dim that the kernels take.
GEOMETRIES = ((3, 2), (3, 1), (2, 2))
KERNELS = {
    torch.bfloat16: ("max_pool_same_fwd_bf16", "max_pool_same_bwd_bf16"),
    torch.float32: ("max_pool_same_fwd_f32", "max_pool_same_bwd_f32"),
}
AVG_KERNELS = {
    torch.bfloat16: ("avg_pool_same_fwd_bf16", "avg_pool_same_bwd_bf16"),
    torch.float32: ("avg_pool_same_fwd_f32", "avg_pool_same_bwd_f32"),
}

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def out_size(size: int, k: int, s: int, pad: Tuple[int, int]) -> int:
    """Windows along one dim of `size` padded by `pad`."""
    return (size + pad[0] + pad[1] - k) // s + 1


def max_pool_plain(x: torch.Tensor, kernel: Sequence[int],
                   strides: Sequence[int], pads: Pads) -> torch.Tensor:
    """`F.max_pool2d` on x padded by `pads`: an asymmetric pad applied
    explicitly with -inf before a padding-free pool (`F.max_pool2d`'s own
    padding is symmetric).  Gradients are autograd's."""
    ph, pw = pads
    if ph[0] == ph[1] and pw[0] == pw[1]:
        # Symmetric: max_pool2d's implicit padding never wins the max.
        return F.max_pool2d(x, kernel, strides, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=-torch.inf)
    return F.max_pool2d(x, kernel, strides)


def _taps(x: torch.Tensor, kernel, strides, pads):
    """(slot, tap values (N, C, Ho, Wo), in-image mask (Ho, Wo)) for every
    window slot in row-major order; out-of-image taps read -inf."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, strides, pads
    h, w = x.shape[2], x.shape[3]
    ho, wo = out_size(h, kh, sh, ph), out_size(w, kw, sw, pw)
    # Pad far enough for every window, whatever `pads` says after.
    bottom = max((ho - 1) * sh + kh - h - ph[0], 0)
    right = max((wo - 1) * sw + kw - w - pw[0], 0)
    xp = F.pad(x, (pw[0], right, ph[0], bottom), value=-torch.inf)
    inside = F.pad(torch.ones((h, w), dtype=torch.bool, device=x.device),
                   (pw[0], right, ph[0], bottom), value=False)
    rows, cols = (ho - 1) * sh + 1, (wo - 1) * sw + 1
    for dr in range(kh):
        for dc in range(kw):
            yield (dr * kw + dc, xp[:, :, dr:dr + rows:sh, dc:dc + cols:sw],
                   inside[dr:dr + rows:sh, dc:dc + cols:sw])


def max_pool_record_plain(x: torch.Tensor, kernel: Sequence[int],
                          strides: Sequence[int], pads: Pads
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, slot): the pool and, as uint8, the window slot of each output's
    first maximum (the first NaN where the window holds one; the first
    in-image tap where every tap is -inf): the forward kernel's plain
    version with its record."""
    kernel, strides = tuple(kernel), tuple(strides)
    taps = list(_taps(x, kernel, strides, pads))
    first = torch.full(taps[0][2].shape, -1, dtype=torch.int64,
                       device=x.device)
    for s, _, inside in taps:
        first = torch.where((first < 0) & inside, s, first)
    best = torch.full_like(taps[0][1], -torch.inf)
    slot = first.expand(best.shape)
    for s, v, inside in taps:
        take = inside & ((v > best) | (v.isnan() & ~best.isnan()))
        best = torch.where(take, v, best)
        slot = torch.where(take, s, slot)
    return best, slot.to(torch.uint8)


def max_pool_backward_plain(dy: torch.Tensor, slot: torch.Tensor,
                            hw: Sequence[int], kernel: Sequence[int],
                            strides: Sequence[int], pads: Pads
                            ) -> torch.Tensor:
    """dx (N, C, H, W) in dy's dtype: each output's dy added, in fp32, at
    the input its record names; the backward kernel's plain version."""
    (kh, kw), (sh, sw), (ph, pw) = tuple(kernel), tuple(strides), pads
    (h, w), (ho, wo) = hw, dy.shape[2:]
    rows, cols = (ho - 1) * sh + 1, (wo - 1) * sw + 1
    dxp = dy.new_zeros((dy.shape[0], dy.shape[1],
                        max(ph[0] + h, rows + kh - 1),
                        max(pw[0] + w, cols + kw - 1)), dtype=torch.float32)
    g = dy.float()
    for dr in range(kh):
        for dc in range(kw):
            dxp[:, :, dr:dr + rows:sh, dc:dc + cols:sw] += torch.where(
                slot == dr * kw + dc, g, 0.0)
    return dxp[:, :, ph[0]:ph[0] + h, pw[0]:pw[0] + w].to(dy.dtype)


def kernel_names(dtype: torch.dtype) -> Tuple[str, str]:
    """(forward, backward) kernel names for `dtype`; raises for another."""
    if dtype not in KERNELS:
        raise TypeError(f"max_pool_same: takes bfloat16 or float32, got "
                        f"{dtype}")
    return KERNELS[dtype]


def _check_geometry(kernel, strides, pads):
    """Raise on a window the kernels do not take; its (k, s)."""
    (kh, kw), (sh, sw) = kernel, strides
    if kh != kw or sh != sw or (kh, sh) not in GEOMETRIES:
        raise ValueError(f"max_pool_same: takes k x k windows at stride s "
                         f"with (k, s) in {GEOMETRIES}, got kernel "
                         f"{kernel}, strides {strides}")
    if not all(0 <= p < kh for p in (*pads[0], *pads[1])):
        raise ValueError(f"max_pool_same: pads {pads} outside [0, {kh})")
    return kh, sh


def _check_vectors(name: str, data: torch.Tensor,
                   record: torch.Tensor = None) -> None:
    """Raise unless the kernels' 16-byte channel vectors fit `data` (x or
    dy, NCHW): C a multiple of 16 bytes' channels and the data 16-byte
    aligned, the record's aligned to a vector's bytes."""
    vec = 16 // data.element_size()
    if data.shape[1] % vec:
        raise ValueError(f"{name}: takes C a multiple of {vec} for "
                         f"{data.dtype}, got {data.shape[1]}")
    if data.data_ptr() % 16 or (record is not None
                                and record.data_ptr() % vec):
        raise ValueError(f"{name}: takes data aligned to 16 bytes and a "
                         f"record aligned to {vec}, got addresses "
                         f"{data.data_ptr():#x} and "
                         f"{0 if record is None else record.data_ptr():#x}")


def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device,
                       memory_format=torch.channels_last)


def _forward(x, kernel, strides, pads, record: bool):
    """(y, slot or an empty uint8 tensor) with no autograd: the plain
    versions on the CPU, the forward kernel on CUDA; channels-last."""
    if x.device.type in ("cpu", "meta"):
        if record:
            y, slot = max_pool_record_plain(x, kernel, strides, pads)
        else:
            y = max_pool_plain(x, kernel, strides, pads)
            slot = x.new_empty((0,), dtype=torch.uint8)
        cl = torch.channels_last
        return (y.contiguous(memory_format=cl),
                slot.contiguous(memory_format=cl) if record else slot)
    if x.device.type != "cuda":
        raise ValueError(f"max_pool_same: unsupported device {x.device}")
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _forward(x, kernel, strides, pads, record)
    name = kernel_names(x.dtype)[0]
    k, s = _check_geometry(kernel, strides, pads)
    x = x.contiguous(memory_format=torch.channels_last)
    _check_vectors(name, x)
    n, c, h, w = x.shape
    ho, wo = out_size(h, k, s, pads[0]), out_size(w, k, s, pads[1])
    y = _empty((n, c, ho, wo), x.dtype, x.device)
    slot = (_empty((n, c, ho, wo), torch.uint8, x.device) if record
            else x.new_empty((0,), dtype=torch.uint8))
    if y.numel() == 0:
        return y, slot
    code = getattr(_build.library(), name)(
        x.data_ptr(), y.data_ptr(), slot.data_ptr() if record else None,
        n, h, w, c, ho, wo, k, s, pads[0][0], pads[1][0],
        torch.cuda.current_stream().cuda_stream)
    _build.check(code, name)
    max_pool_same.launches += 1
    return y, slot


def _backward(dy, slot, hw, kernel, strides, pads):
    """dx with no autograd: the plain version on the CPU, the backward
    kernel on CUDA; channels-last."""
    if dy.device.type in ("cpu", "meta"):
        return max_pool_backward_plain(dy, slot, hw, kernel, strides,
                                       pads).contiguous(
            memory_format=torch.channels_last)
    if dy.device.type != "cuda":
        raise ValueError(f"max_pool_same: unsupported device {dy.device}")
    if dy.device.index != torch.cuda.current_device():
        with torch.cuda.device(dy.device):
            return _backward(dy, slot, hw, kernel, strides, pads)
    name = kernel_names(dy.dtype)[1]
    k, s = _check_geometry(kernel, strides, pads)
    dy = dy.contiguous(memory_format=torch.channels_last)
    n, c, ho, wo = dy.shape
    h, w = hw
    if (slot.dtype != torch.uint8 or slot.shape != dy.shape
            or slot.device != dy.device
            or not slot.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"{name}: the record must be channels-last uint8 "
                         f"{tuple(dy.shape)} on {dy.device}, got "
                         f"{slot.dtype} {tuple(slot.shape)} on {slot.device}")
    _check_vectors(name, dy, slot)
    dx = _empty((n, c, h, w), dy.dtype, dy.device)
    if dx.numel() == 0:
        return dx
    code = getattr(_build.library(), name)(
        dy.data_ptr(), slot.data_ptr(), dx.data_ptr(), n, h, w, c, ho, wo,
        k, s, pads[0][0], pads[1][0], torch.cuda.current_stream().cuda_stream)
    _build.check(code, name)
    max_pool_same.launches_bwd += 1
    return dx


def _flat(pads: Pads) -> List[int]:
    return [pads[0][0], pads[0][1], pads[1][0], pads[1][1]]


def _nested(pads: Sequence[int]) -> Pads:
    return (pads[0], pads[1]), (pads[2], pads[3])


def max_pool_same(x: torch.Tensor, kernel: Sequence[int],
                  strides: Sequence[int], pads: Pads) -> torch.Tensor:
    """Max pool of NCHW x by `kernel` windows at `strides` over x padded by
    `pads` ((top, bottom), (left, right)): the plain version on the CPU,
    the kernels on CUDA (see the module docstring)."""
    kernel, strides = tuple(kernel), tuple(strides)
    if x.device.type != "cuda" and not as_operator():
        return max_pool_plain(x, kernel, strides, pads)
    if torch.is_grad_enabled() and x.requires_grad:
        return MaxPoolFunction.apply(x, kernel, strides, pads)
    if as_operator():
        return torch.ops.gvcnn.max_pool_same(x, list(kernel), list(strides),
                                             _flat(pads), False)[0]
    return _forward(x, kernel, strides, pads, False)[0]


max_pool_same.launches = 0
max_pool_same.launches_bwd = 0


@torch.library.custom_op("gvcnn::max_pool_same", mutates_args=())
def max_pool_same_op(x: torch.Tensor, kernel: List[int], strides: List[int],
                     pads: List[int], record: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`gvcnn::max_pool_same`: `_forward` as an operator (no autograd)."""
    return _forward(x, tuple(kernel), tuple(strides), _nested(pads), record)


@max_pool_same_op.register_fake
def _max_pool_same_fake(x, kernel, strides, pads, record):
    n, c, h, w = x.shape
    shape = (n, c, out_size(h, kernel[0], strides[0], pads[:2]),
             out_size(w, kernel[1], strides[1], pads[2:]))
    return (_empty(shape, x.dtype, x.device),
            _empty(shape, torch.uint8, x.device) if record
            else x.new_empty((0,), dtype=torch.uint8))


@torch.library.custom_op("gvcnn::max_pool_same_backward", mutates_args=())
def max_pool_same_backward_op(dy: torch.Tensor, slot: torch.Tensor,
                              hw: List[int], kernel: List[int],
                              strides: List[int], pads: List[int]
                              ) -> torch.Tensor:
    """`gvcnn::max_pool_same_backward`: `_backward` as an operator."""
    return _backward(dy, slot, tuple(hw), tuple(kernel), tuple(strides),
                     _nested(pads))


@max_pool_same_backward_op.register_fake
def _max_pool_same_backward_fake(dy, slot, hw, kernel, strides, pads):
    return _empty((dy.shape[0], dy.shape[1], hw[0], hw[1]), dy.dtype,
                  dy.device)


class MaxPoolFunction(torch.autograd.Function):
    """The pool under autograd: the forward with its record (the kernel on
    CUDA, `max_pool_record_plain` on the CPU), the gather backward from the
    record alone (`max_pool_backward_plain` on the CPU)."""

    @staticmethod
    def forward(ctx, x, kernel, strides, pads):
        if as_operator():
            y, slot = torch.ops.gvcnn.max_pool_same(
                x, list(kernel), list(strides), _flat(pads), True)
        else:
            y, slot = _forward(x, kernel, strides, pads, True)
        ctx.save_for_backward(slot)
        ctx.geometry = ((x.shape[2], x.shape[3]), kernel, strides, pads)
        return y

    @staticmethod
    def backward(ctx, dy):
        (slot,) = ctx.saved_tensors
        hw, kernel, strides, pads = ctx.geometry
        if as_operator():
            dx = torch.ops.gvcnn.max_pool_same_backward(
                dy, slot, list(hw), list(kernel), list(strides), _flat(pads))
        else:
            dx = _backward(dy, slot, hw, kernel, strides, pads)
        return dx, None, None, None


# ---------------------------------------------------------------------------
# The 3x3/1 'SAME' average pool (csrc/avg_pool.cu)
# ---------------------------------------------------------------------------


def avg_pool_plain(x: torch.Tensor) -> torch.Tensor:
    """The 3x3/1 'SAME' pool of x as `F.avg_pool2d`, the pads counted in
    each window's mean.  Gradients are autograd's."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def avg_pool_backward_plain(dy: torch.Tensor) -> torch.Tensor:
    """dx of the 3x3/1 'SAME' average pool from dy alone, in dy's dtype:
    the sum of each 3x3 window of dy padded by one zero on every side, in
    fp32, over 9, rounded once; the backward kernel's plain version."""
    h, w = dy.shape[2:]
    g = F.pad(dy.float(), (1, 1, 1, 1))
    s = sum(g[:, :, i:i + h, j:j + w] for i in range(3) for j in range(3))
    return (s / 9).to(dy.dtype)


def _box(t: torch.Tensor, backward: bool) -> torch.Tensor:
    """The 3x3/1 'SAME' pool of x, or its backward from dy, with no
    autograd: the plain versions on the CPU, a kernel on CUDA;
    channels-last."""
    if t.device.type in ("cpu", "meta"):
        out = avg_pool_backward_plain(t) if backward else avg_pool_plain(t)
        return out.contiguous(memory_format=torch.channels_last)
    if t.device.type != "cuda":
        raise ValueError(f"avg_pool_same: unsupported device {t.device}")
    if t.device.index != torch.cuda.current_device():
        with torch.cuda.device(t.device):
            return _box(t, backward)
    if t.dtype not in AVG_KERNELS:
        raise TypeError(f"avg_pool_same: takes bfloat16 or float32, got "
                        f"{t.dtype}")
    name = AVG_KERNELS[t.dtype][backward]
    t = t.contiguous(memory_format=torch.channels_last)
    _check_vectors(name, t)
    out = _empty(t.shape, t.dtype, t.device)
    if out.numel() == 0:
        return out
    n, c, h, w = t.shape
    code = getattr(_build.library(), name)(
        t.data_ptr(), out.data_ptr(), n, h, w, c,
        torch.cuda.current_stream().cuda_stream)
    _build.check(code, name)
    if backward:
        avg_pool_same.launches_bwd += 1
    else:
        avg_pool_same.launches += 1
    return out


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """The 3x3/1 'SAME' average pool of NCHW x, the padded zeros counted:
    the plain version on the CPU, the kernels on CUDA (see the module
    docstring)."""
    if x.device.type != "cuda" and not as_operator():
        return avg_pool_plain(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return AvgPoolFunction.apply(x)
    if as_operator():
        return torch.ops.gvcnn.avg_pool_same(x)
    return _box(x, False)


avg_pool_same.launches = 0
avg_pool_same.launches_bwd = 0


@torch.library.custom_op("gvcnn::avg_pool_same", mutates_args=())
def avg_pool_same_op(x: torch.Tensor) -> torch.Tensor:
    """`gvcnn::avg_pool_same`: the 3x3/1 'SAME' pool as an operator (no
    autograd)."""
    return _box(x, False)


@avg_pool_same_op.register_fake
def _avg_pool_same_fake(x):
    return _empty(x.shape, x.dtype, x.device)


@torch.library.custom_op("gvcnn::avg_pool_same_backward", mutates_args=())
def avg_pool_same_backward_op(dy: torch.Tensor) -> torch.Tensor:
    """`gvcnn::avg_pool_same_backward`: dx from dy as an operator."""
    return _box(dy, True)


@avg_pool_same_backward_op.register_fake
def _avg_pool_same_backward_fake(dy):
    return _empty(dy.shape, dy.dtype, dy.device)


class AvgPoolFunction(torch.autograd.Function):
    """The 3x3/1 'SAME' pool under autograd: the forward kernel, and the
    same box mean over dy as the backward (the plain versions on the CPU).
    Nothing is saved."""

    @staticmethod
    def forward(ctx, x):
        if as_operator():
            return torch.ops.gvcnn.avg_pool_same(x)
        return _box(x, False)

    @staticmethod
    def backward(ctx, dy):
        if as_operator():
            return torch.ops.gvcnn.avg_pool_same_backward(dy)
        return _box(dy, True)
