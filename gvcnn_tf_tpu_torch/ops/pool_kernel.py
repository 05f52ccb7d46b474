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
right)) as `pool._pads` gives them, is the op `gvcnn::max_pool_same`.
Where x needs a gradient (grad mode on) the forward also writes a one-byte
record, the window slot (0 .. k*k-1, row-major) of each output's first
maximum, and the backward (`gvcnn::max_pool_same_backward`) gathers dy into
dx from it.  Nothing else is saved for the backward: neither x nor a padded
copy.  Under `no_grad` (eval, serving, their graphs) the forward writes the
output alone.  By x's device:

  CPU   the plain versions: `max_pool_plain` (`F.pad` with -inf where the
        pads are asymmetric and `F.max_pool2d`), or `max_pool_record_plain`
        with the record, and `max_pool_backward_plain`;
  CUDA  the kernels; the forward pads inside itself (a tap outside the
        image is no candidate).

It never falls back to `F.max_pool2d` on a card.

Ties go to the first maximum in row-major window order and a window that
holds a NaN gives NaN, its first NaN winning, as `F.max_pool2d` and XLA's
select-and-scatter do; a window whose taps are all -inf credits its first
in-image tap.  The kernel's output equals `F.max_pool2d`'s value for value
(where -0.0 and +0.0 tie for the maximum it may give either zero).
`max_pool_record_plain` and `max_pool_backward_plain` are the kernels'
plain versions under the same rules (the backward sums in fp32 and rounds
once, as the kernel does, in another order).

The ops: `gvcnn::max_pool_same` (x, kernel, strides, pads as [top,
bottom, left, right], record) -> (y, slot; an empty uint8 tensor without
the record) and `gvcnn::max_pool_same_backward`, so that `torch.export`
traces them (a traced tensor has no data pointer to launch with) and an
artifact calls them, and a dispatch mode sees them as one op each.  Their
implementations are `_forward` / `_backward`; their outputs are
channels-last on every device, and so are their fake (shape-only) ones.

The average pool, `avg_pool_same(x)`: the one geometry of the port's
backbones, a 3x3 window at stride 1 with TF-'SAME' pads (1, 1) on both
dims, as Flax's `avg_pool` with `count_include_pad=True` (the padded zeros
count in every window's mean), which the port follows.  The kernels
(`csrc/avg_pool.cu`: `avg_pool_same_fwd_{bf16,f32}` and
`avg_pool_same_bwd_{bf16,f32}`) take the same dtypes, layout and 16-byte
channel vectors as the max pool's; anything else raises on a card.

It is the op `gvcnn::avg_pool_same` (x), whose backward
`gvcnn::avg_pool_same_backward` (dy) is the same box mean over dy: at
stride 1 with symmetric pads the windows that hold an input are the
outputs around it, so dx = boxsum3x3(dy) / 9 with zero padding, and nothing
is saved for the backward.  Both ops give channels-last outputs and fake
outputs; by x's device:

  CPU   `avg_pool_plain` (`F.avg_pool2d` counting the pads) and
        `avg_pool_backward_plain`;
  CUDA  the kernels.

Both sum in fp32, divide by 9 and round once (as PyTorch's kernel does, in
another order).  It never falls back to `F.avg_pool2d` on a card.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from gvcnn_tf_tpu_torch.ops import _build

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
    the input its record names; the backward kernel's plain version.  An
    input's terms are added in the outputs' row-major order (the slots in
    reverse), as autograd through `F.max_pool2d` and XLA's
    select-and-scatter add them on the CPU, so the sums are theirs bit for
    bit."""
    (kh, kw), (sh, sw), (ph, pw) = tuple(kernel), tuple(strides), pads
    (h, w), (ho, wo) = hw, dy.shape[2:]
    rows, cols = (ho - 1) * sh + 1, (wo - 1) * sw + 1
    dxp = dy.new_zeros((dy.shape[0], dy.shape[1],
                        max(ph[0] + h, rows + kh - 1),
                        max(pw[0] + w, cols + kw - 1)), dtype=torch.float32)
    g = dy.float()
    for dr in reversed(range(kh)):
        for dc in reversed(range(kw)):
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
    if x.device.type == "cpu":
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
    _build.launch(name, x.device, x.data_ptr(), y.data_ptr(),
                  slot.data_ptr() if record else None, n, h, w, c, ho, wo,
                  k, s, pads[0][0], pads[1][0])
    return y, slot


def _backward(dy, slot, hw, kernel, strides, pads):
    """dx with no autograd: the plain version on the CPU, the backward
    kernel on CUDA; channels-last."""
    if dy.device.type == "cpu":
        return max_pool_backward_plain(dy, slot, hw, kernel, strides,
                                       pads).contiguous(
            memory_format=torch.channels_last)
    if dy.device.type != "cuda":
        raise ValueError(f"max_pool_same: unsupported device {dy.device}")
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
    _build.launch(name, dy.device, dy.data_ptr(), slot.data_ptr(),
                  dx.data_ptr(), n, h, w, c, ho, wo, k, s, pads[0][0],
                  pads[1][0])
    return dx


def _flat(pads: Pads) -> List[int]:
    return [pads[0][0], pads[0][1], pads[1][0], pads[1][1]]


def _nested(pads: Sequence[int]) -> Pads:
    return (pads[0], pads[1]), (pads[2], pads[3])


def max_pool_same(x: torch.Tensor, kernel: Sequence[int],
                  strides: Sequence[int], pads: Pads) -> torch.Tensor:
    """Max pool of NCHW x by `kernel` windows at `strides` over x padded by
    `pads` ((top, bottom), (left, right)): `gvcnn::max_pool_same`, with the
    record where x needs a gradient (see the module docstring)."""
    record = torch.is_grad_enabled() and x.requires_grad
    return torch.ops.gvcnn.max_pool_same(x, list(kernel), list(strides),
                                         _flat(pads), record)[0]


def _max_pool_same_op(x, kernel, strides, pads, record):
    """`gvcnn::max_pool_same`: `_forward` as an operator."""
    return _forward(x, tuple(kernel), tuple(strides), _nested(pads), record)


def _max_pool_same_fake(x, kernel, strides, pads, record):
    n, c, h, w = x.shape
    shape = (n, c, out_size(h, kernel[0], strides[0], pads[:2]),
             out_size(w, kernel[1], strides[1], pads[2:]))
    return (_empty(shape, x.dtype, x.device),
            _empty(shape, torch.uint8, x.device) if record
            else x.new_empty((0,), dtype=torch.uint8))


def _max_pool_same_backward_op(dy, slot, hw, kernel, strides, pads):
    """`gvcnn::max_pool_same_backward`: `_backward` as an operator."""
    return _backward(dy, slot, tuple(hw), tuple(kernel), tuple(strides),
                     _nested(pads))


def _max_pool_same_backward_fake(dy, slot, hw, kernel, strides, pads):
    return _empty((dy.shape[0], dy.shape[1], hw[0], hw[1]), dy.dtype,
                  dy.device)


torch.library.define("gvcnn::max_pool_same",
                     "(Tensor x, SymInt[] kernel, SymInt[] strides, "
                     "SymInt[] pads, bool record) -> (Tensor, Tensor)")
torch.library.impl("gvcnn::max_pool_same", "default", _max_pool_same_op)
torch.library.register_fake("gvcnn::max_pool_same", _max_pool_same_fake)
torch.library.define("gvcnn::max_pool_same_backward",
                     "(Tensor dy, Tensor slot, SymInt[] hw, SymInt[] kernel, "
                     "SymInt[] strides, SymInt[] pads) -> Tensor")
torch.library.impl("gvcnn::max_pool_same_backward", "default",
                   _max_pool_same_backward_op)
torch.library.register_fake("gvcnn::max_pool_same_backward",
                            _max_pool_same_backward_fake)


def _max_pool_setup_context(ctx, inputs, output):
    x, kernel, strides, pads, _ = inputs
    ctx.save_for_backward(output[1])
    ctx.geometry = ([x.shape[2], x.shape[3]], kernel, strides, pads)


def _max_pool_backward(ctx, dy, _):
    """The gather of dy into dx from the saved record."""
    (slot,) = ctx.saved_tensors
    if slot.numel() == 0 and dy.numel():
        raise RuntimeError("max_pool_same: a forward without its record has "
                           "no gradient")
    dx = torch.ops.gvcnn.max_pool_same_backward(dy, slot, *ctx.geometry)
    return dx, None, None, None, None


torch.library.register_autograd("gvcnn::max_pool_same", _max_pool_backward,
                                setup_context=_max_pool_setup_context)


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
    if t.device.type == "cpu":
        out = avg_pool_backward_plain(t) if backward else avg_pool_plain(t)
        return out.contiguous(memory_format=torch.channels_last)
    if t.device.type != "cuda":
        raise ValueError(f"avg_pool_same: unsupported device {t.device}")
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
    _build.launch(name, t.device, t.data_ptr(), out.data_ptr(), n, h, w, c)
    return out


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """The 3x3/1 'SAME' average pool of NCHW x, the padded zeros counted:
    `gvcnn::avg_pool_same` (see the module docstring)."""
    return torch.ops.gvcnn.avg_pool_same(x)


def _box_fake(t):
    return _empty(t.shape, t.dtype, t.device)


torch.library.define("gvcnn::avg_pool_same", "(Tensor x) -> Tensor")
torch.library.impl("gvcnn::avg_pool_same", "default",
                   lambda x: _box(x, False))
torch.library.register_fake("gvcnn::avg_pool_same", _box_fake)
torch.library.define("gvcnn::avg_pool_same_backward", "(Tensor dy) -> Tensor")
torch.library.impl("gvcnn::avg_pool_same_backward", "default",
                   lambda dy: _box(dy, True))
torch.library.register_fake("gvcnn::avg_pool_same_backward", _box_fake)
torch.library.register_autograd(
    "gvcnn::avg_pool_same",
    lambda ctx, dy: torch.ops.gvcnn.avg_pool_same_backward(dy),
    setup_context=lambda ctx, inputs, output: None)


def _no_second_derivative(ctx, grad):
    raise NotImplementedError("the pools' backward ops have no gradient: "
                              "the port takes no second derivative")


# Registered so that the backward ops run below autograd, as the forwards
# do, and refuse a gradient instead of recording their plain versions' ops.
for _op in ("gvcnn::max_pool_same_backward", "gvcnn::avg_pool_same_backward"):
    torch.library.register_autograd(
        _op, _no_second_derivative,
        setup_context=lambda ctx, inputs, output: None)
