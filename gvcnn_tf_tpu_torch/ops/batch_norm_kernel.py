"""Train-mode BatchNorm (+ ReLU) as hand-written CUDA kernels, with their
plain PyTorch versions.

Replace no TPU kernel: the JAX package leaves BatchNorm to XLA (Flax's
`BatchNorm`).  The kernels are in `csrc/batch_norm.cu` (its source note
says what bounds them on the H100 and what their design does about it);
x's dtype picks them:

  bfloat16  `batch_norm_stats_bf16`, `batch_norm_apply_bf16`,
            `batch_norm_bwd_reduce_bf16`, `batch_norm_bwd_elemt_bf16`,
            and the residual variants `batch_norm_apply_residual_bf16`,
            `batch_norm_bwd_reduce_residual_bf16`;
  float32   the same names ending in `_f32`.

Any other dtype raises on a card.  Tensors are NCHW in shape; on the card
the kernels read and write them channels-last (NHWC in memory), which is
how the port keeps its activations: x is made channels-last (a copy only
where it is not), dy may also be a channel slice of a wider channels-last
tensor (a concat's backward hands those over), and the outputs are
channels-last (an x that is not gets its output back in its own layout, a
copy each way; on the CPU the outputs keep x's layout).  A thread moves 16 bytes of channels at a time where C and
the addresses allow it, one channel otherwise.  Statistics, parameters and
the running statistics are float32.

`batch_norm_train(x, weight, bias, running_mean, running_var, momentum,
eps, relu, update)` is `BatchNorm`'s train-mode forward: y normalized with
the batch's mean and biased variance over (N, H, W), y = (x - mean) *
invstd * weight + bias (weight None: 1), and max(y, 0) where `relu`; where
`update`, the running statistics move in place, r <- r * momentum + stat *
(1 - momentum), the variance biased, as Flax moves `batch_stats`.  It is
two ops:

  `gvcnn::batch_norm_stats` (x, running_mean!, running_var!, momentum, eps,
      update) -> (mean, invstd): the statistics and the running update, on
      x detached.  It mutates its inputs, and PyTorch registers no gradient
      on an op that does (`torch.library.register_autograd` refuses a
      schema that is not functional), so it takes no part in autograd;
  `gvcnn::batch_norm_apply` (x, weight, bias, mean, invstd, relu) -> y,
      with its gradient registered: `gvcnn::batch_norm_backward` (dy, x,
      weight, bias, mean, invstd, relu, output_mask) -> (dx, dweight,
      dbias), BatchNorm's whole gradient through the batch statistics (so
      mean and invstd get none).  Nothing is saved but x, the parameters
      and the two statistics: the ReLU's mask is x's own, recomputed.

With a `residual` r (ResNet's bottleneck hands its shortcut to conv3's
BatchNorm), the apply is instead

  `gvcnn::batch_norm_apply_residual` (x, weight, bias, mean, invstd,
      residual) -> out = relu(fma(x, a, b) + r), the sum and the ReLU in
      fp32 and out rounded once, with its gradient registered:
      `gvcnn::batch_norm_backward_residual` (dy, out, x, weight, bias, mean,
      invstd, output_mask) -> (dx, dweight, dbias, dresidual): g = dy where
      out > 0 (threshold_backward's mask, from the saved out, which is the
      next block's input and kept by autograd anyway) is r's gradient, and
      BatchNorm's gradient is taken from g without the ReLU.

By x's device:

  CPU   the plain versions, which compute today's math bit for bit:
        `stats_plain` (`torch.native_batch_norm`'s mean and invstd),
        `update_plain` (the EMA, of the variance 1 / invstd^2 - eps
        floored at 0: `var_plain`), `apply_plain` and `backward_plain`
        (`native_batch_norm_backward` after the ReLU's `threshold_backward`
        where `relu`);
  CUDA  the kernels: stats (one launch: Welford a thread, Chan's merge
        across threads and blocks; the block that finishes last writes the
        statistics and moves the running ones), apply (one), backward (two:
        reduce, then elementwise); with a residual the apply and the reduce
        are their residual variants (the reduce also writes g), and the
        elementwise kernel reads g without the ReLU.

It never falls back to `native_batch_norm` on a card.  The affine is
computed as the kernel computes it, a = invstd * weight, b = fma(-mean, a,
bias), v = fma(x, a, b), which is also how PyTorch's CPU kernel rounds it,
so the plain forward equals `native_batch_norm` + `F.relu` bit for bit.
The kernels' statistics are taken in another order than PyTorch's, and
the running variance is M2 / n where the plain update takes 1 / invstd^2 -
eps: equal to fp32 rounding.

The stats and backward-reduce kernels of a device share one array of
tickets, from offset 0, so they run on one stream of a device at a time:
two of them in flight at once on two streams would draw each other's
tickets and merge each other's partials.  The port launches every kernel
on the current stream, and a CUDA graph replays its launches in order on
one stream.
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from gvcnn_tf_tpu_torch.ops import _build

SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}

# The launch plan (`plan`): a block is at most MAX_THREADS threads (the
# kernels' compile-time block size, `csrc/batch_norm.cu`), a tile
# at most MAX_TILE_VECTORS lane groups; BLOCKS_AN_SM blocks an SM where
# each thread then still owns at least MIN_ROWS_A_THREAD rows; the
# reductions merge GROUP chunks' partials at a time.
MAX_THREADS = 256
MAX_TILE_VECTORS = 32
BLOCKS_AN_SM = 2
MIN_ROWS_A_THREAD = 16
GROUP = 16
# Tickets a device holds (a plan takes tiles * (groups + 1) of them).
TICKETS = 4096


class Plan(NamedTuple):
    """How a kernel covers rows x C: `lanes` channels a thread (a 16-byte
    vector or 1), `tile_vectors` lane groups a block by MAX_THREADS //
    tile_vectors rows at a time, `tiles` tiles across C, `chunks` blocks
    down the rows of `chunk_rows` rows each (the last may hold fewer),
    whose partials the reductions merge in `groups` groups of GROUP."""
    lanes: int
    tile_vectors: int
    tiles: int
    chunk_rows: int
    chunks: int
    groups: int


def plan(rows: int, c: int, lanes: int, sms: int,
         blocks_an_sm: int = BLOCKS_AN_SM) -> Plan:
    """The launch plan for rows x c at `lanes` channels a thread on a card
    of `sms` SMs: equal tiles of at most MAX_TILE_VECTORS lane groups, and
    as many equal chunks of rows as give `blocks_an_sm` blocks an SM
    without a thread owning fewer than MIN_ROWS_A_THREAD rows (one chunk at
    least).  The residual join's backward (`ops/residual_join.py`) takes
    the same plan, with blocks of the same size, and ignores `groups`."""
    cv = c // lanes
    tiles = -(-cv // MAX_TILE_VECTORS)
    tv = -(-cv // tiles)
    by = MAX_THREADS // tv
    most = max(1, rows // (by * MIN_ROWS_A_THREAD))
    chunks = min(max(1, -(-blocks_an_sm * sms // tiles)), most)
    chunk_rows = -(-rows // chunks)
    chunks = -(-rows // chunk_rows)
    return Plan(lanes, tv, tiles, chunk_rows, chunks, -(-chunks // GROUP))


# ---------------------------------------------------------------------------
# The plain versions (CPU)
# ---------------------------------------------------------------------------


def _c(t: torch.Tensor) -> torch.Tensor:
    """A per-channel vector as (C, 1, 1), to broadcast over NCHW."""
    return t[:, None, None]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in a's dtype; of fp32 operands as an fma rounds it: the
    product is exact in float64, the sum rounded there and then to fp32
    (two roundings, which differ from one only where the first lands on an
    fp32 tie)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _affine(weight, bias, mean, invstd):
    """(a, b) with BN(x) = fma(x, a, b): a = invstd * weight (invstd where
    weight is None), b = fma(-mean, a, bias)."""
    a = invstd if weight is None else invstd * weight
    return a, _fma(-mean, a, bias)


def stats_plain(x: torch.Tensor, eps: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, invstd) of NCHW x over (N, H, W), fp32 (float64 for a
    float64 x): those of `torch.native_batch_norm` in training mode (given
    parameters of that dtype, so that a bf16 x gets fp32 statistics)."""
    one = torch.ones(x.shape[1], device=x.device,
                     dtype=torch.promote_types(x.dtype, torch.float32))
    _, mean, invstd = torch.native_batch_norm(
        x, one, torch.zeros_like(one), None, None, True, 0.0, eps)
    return mean, invstd


def var_plain(invstd: torch.Tensor, eps: float) -> torch.Tensor:
    """The biased variance of the statistics: 1 / invstd^2 - eps, floored
    at 0."""
    return torch.clamp(invstd.square().reciprocal() - eps, min=0.0)


@torch.no_grad()
def update_plain(running_mean: torch.Tensor, running_var: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor,
                 momentum: float) -> None:
    """In place: r <- r * momentum + stat * (1 - momentum) for the mean and
    the biased variance (also `BatchNorm`'s update of its summed
    statistics, `bn_sync="global"`)."""
    running_mean.mul_(momentum).add_(mean * (1.0 - momentum))
    running_var.mul_(momentum).add_(var * (1.0 - momentum))


def apply_plain(x: torch.Tensor, weight: Optional[torch.Tensor],
                bias: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor,
                relu: bool) -> torch.Tensor:
    """y = fma(x, a, b) in fp32 (`_affine`), rounded to x's dtype, and
    `torch.relu` of it where `relu`: the apply kernel's plain version."""
    a, b = _affine(weight, bias, mean, invstd)
    y = _fma(x.to(a.dtype), _c(a), _c(b)).to(x.dtype)
    return torch.relu(y) if relu else y


def apply_residual_plain(x: torch.Tensor, weight: Optional[torch.Tensor],
                         bias: torch.Tensor, mean: torch.Tensor,
                         invstd: torch.Tensor,
                         residual: torch.Tensor) -> torch.Tensor:
    """out = relu(fma(x, a, b) + residual) in fp32, rounded once to x's
    dtype: the residual apply kernel's plain version (in fp32, `apply_plain`
    without the ReLU, + residual, `torch.relu`, bit for bit)."""
    a, b = _affine(weight, bias, mean, invstd)
    v = _fma(x.to(a.dtype), _c(a), _c(b))
    return torch.relu(v + residual.to(v.dtype)).to(x.dtype)


def backward_plain(dy: torch.Tensor, x: torch.Tensor,
                   weight: Optional[torch.Tensor], bias: torch.Tensor,
                   mean: torch.Tensor, invstd: torch.Tensor, relu: bool,
                   output_mask: Sequence[bool]):
    """(dx, dweight, dbias): where `relu`, dy through the ReLU's
    `threshold_backward` on the recomputed y, then
    `native_batch_norm_backward` in training mode with the saved mean and
    invstd (dweight None where weight is; an output not asked for None):
    the gradient autograd takes through `native_batch_norm` + `F.relu`."""
    if relu:
        y = apply_plain(x, weight, bias, mean, invstd, True)
        dy = torch.ops.aten.threshold_backward(dy, y, 0)
    gamma = torch.ones_like(mean) if weight is None else weight
    mask = [bool(output_mask[0]), weight is not None and bool(output_mask[1]),
            bool(output_mask[2])]
    dx, dw, db = torch.ops.aten.native_batch_norm_backward(
        dy, x, gamma, None, None, mean, invstd, True, 0.0, mask)
    return (dx if mask[0] else None, dw if mask[1] else None,
            db if mask[2] else None)


def backward_residual_plain(dy: torch.Tensor, out: torch.Tensor,
                            x: torch.Tensor, weight: Optional[torch.Tensor],
                            bias: torch.Tensor, mean: torch.Tensor,
                            invstd: torch.Tensor,
                            output_mask: Sequence[bool]):
    """(dx, dweight, dbias, dresidual): g = `threshold_backward`(dy, out,
    0), the residual's gradient, and `backward_plain` of g without the
    ReLU: the gradient autograd takes through BatchNorm + add + `F.relu`."""
    g = torch.ops.aten.threshold_backward(dy, out, 0)
    return backward_plain(g, x, weight, bias, mean, invstd, False,
                          output_mask) + (g,)


# ---------------------------------------------------------------------------
# The kernels (CUDA)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
# device index -> (int32 tickets (TICKETS,), zero between launches; SMs)
_devices = {}


def _device(device: torch.device) -> Tuple[torch.Tensor, int]:
    """(the device's tile tickets, its SM count).  The tickets are zeroed
    once, outside any graph capture (where the fill would not run before
    eager use); each kernel that draws them leaves them at 0 (`csrc/
    batch_norm.cu`), so a graph that replays the launches needs no
    memset."""
    with _lock:
        if device.index not in _devices:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "batch_norm: the first launch on a device was inside a "
                    "CUDA graph capture; run the step eagerly first, as "
                    "`utils/graphs.CapturedCall` does")
            _devices[device.index] = (
                torch.zeros(TICKETS, dtype=torch.int32, device=device),
                torch.cuda.get_device_properties(
                    device).multi_processor_count)
        return _devices[device.index]


def _pitch(t: torch.Tensor) -> Optional[int]:
    """The row pitch in elements when NCHW t holds its N*H*W rows of C
    contiguous channels at one pitch (channels-last, or a channel slice of
    a channels-last tensor); else None."""
    n, c, h, w = t.shape
    s = t.stride()
    # (size, stride, rows a step of the dim moves)
    dims = ((w, s[3], 1), (h, s[2], w), (n, s[0], h * w))
    ld = next((stride // rows for size, stride, rows in dims if size > 1), c)
    if ld < c or (c > 1 and s[1] != 1) or any(
            size > 1 and stride != rows * ld for size, stride, rows in dims):
        return None
    return ld


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """x channels-last: x itself where it is, else a copy (the one place
    the kernels' wrappers copy an x)."""
    return x.contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(t, its row pitch), t made channels-last where it has no pitch."""
    ld = _pitch(t)
    if ld is None:
        t = t.contiguous(memory_format=torch.channels_last)
        ld = t.shape[1]
    return t, ld


def _lanes(x: torch.Tensor, pitches: Sequence[int],
           tensors: Sequence[torch.Tensor]) -> int:
    """16 bytes' worth of x's channels where C, every pitch and every
    address allow it, else 1."""
    vec = 16 // x.element_size()
    if x.shape[1] % vec or any(ld % vec for ld in pitches) or any(
            t.data_ptr() % 16 for t in tensors):
        return 1
    return vec


def _suffix(name: str, x: torch.Tensor) -> str:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in SUFFIX:
        raise TypeError(f"{name}: takes bfloat16 or float32, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{name}: takes a non-empty NCHW tensor, got shape "
                         f"{tuple(x.shape)}")
    return SUFFIX[x.dtype]


def _check_vectors(name: str, x: torch.Tensor, *vectors) -> None:
    """Raise unless each per-channel tensor (or None) is fp32, contiguous,
    of C elements and on x's device."""
    c = x.shape[1]
    for v in vectors:
        if v is not None and (v.dtype != torch.float32 or v.shape != (c,)
                              or not v.is_contiguous()
                              or v.device != x.device):
            raise ValueError(f"{name}: per-channel tensors must be float32 "
                             f"({c},) contiguous on {x.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _plan_for(x: torch.Tensor, lanes: int) -> Tuple[torch.Tensor, Plan]:
    """(the device's tickets, the plan for x at `lanes`); raises where the
    plan needs more tickets than the device holds."""
    tickets, sms = _device(x.device)
    n, c, h, w = x.shape
    p = plan(n * h * w, c, lanes, sms)
    if p.tiles * (p.groups + 1) > TICKETS:
        raise ValueError(f"batch_norm: {tuple(x.shape)} needs "
                         f"{p.tiles * (p.groups + 1)} tickets, more than the "
                         f"{TICKETS} a device holds")
    return tickets, p


def _stats(x, running_mean, running_var, momentum, eps, update):
    """(mean, invstd) and, where `update`, the running statistics moved:
    the plain versions on the CPU, the stats kernel on CUDA."""
    if x.device.type == "cpu":
        mean, invstd = stats_plain(x, eps)
        if update:
            update_plain(running_mean, running_var, mean,
                         var_plain(invstd, eps), momentum)
        return mean, invstd
    name = "batch_norm_stats_" + _suffix("batch_norm_stats", x)
    _check_vectors(name, x, running_mean, running_var)
    x = _channels_last(x)
    rows, c = x.shape[0] * x.shape[2] * x.shape[3], x.shape[1]
    tickets, p = _plan_for(x, _lanes(x, (), (x,)))
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    invstd = torch.empty_like(mean)
    part = torch.empty((p.chunks + p.groups) * 2 * c, dtype=torch.float32,
                       device=x.device)
    _build.launch(name, x.device, x.data_ptr(), part.data_ptr(),
                  tickets.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
                  running_mean.data_ptr(), running_var.data_ptr(), rows, c,
                  p.lanes, p.tile_vectors, p.chunk_rows, p.chunks, p.tiles,
                  GROUP, eps, momentum, 1.0 - momentum, int(update))
    if update:
        # The kernel's writes move no version counter; the eval affine's
        # cache (`BatchNorm.scale_shift`) keys on them.
        torch.autograd.graph.increment_version(running_mean)
        torch.autograd.graph.increment_version(running_var)
    return mean, invstd


def _layout(x: torch.Tensor) -> torch.memory_format:
    """The layout of the ops' outputs: x's own, channels-last or
    contiguous."""
    return (torch.channels_last
            if x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def _empty(x: torch.Tensor) -> torch.Tensor:
    """An uninitialized tensor like x in `_layout(x)`."""
    return torch.empty(x.shape, dtype=x.dtype, device=x.device,
                       memory_format=_layout(x))


def _check_like(name: str, x: torch.Tensor, t: torch.Tensor) -> None:
    """Raise unless t (a residual, a saved out or a dy) has x's dtype and
    shape."""
    if t.dtype != x.dtype or t.shape != x.shape:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} against x "
                         f"{x.dtype} {tuple(x.shape)}")


def _apply(x, weight, bias, mean, invstd, relu, residual=None):
    """y in x's layout (`_layout`): the plain version on the CPU, the
    apply kernel on CUDA (on a channels-last copy of x and back where x is
    not channels-last); with a residual, out = relu(BN(x) + residual) by
    the residual apply kernel (`relu` is then True)."""
    if x.device.type == "cpu":
        y = (apply_plain(x, weight, bias, mean, invstd, relu)
             if residual is None else
             apply_residual_plain(x, weight, bias, mean, invstd, residual))
        return y.contiguous(memory_format=_layout(x))
    kind = "apply" if residual is None else "apply_residual"
    name = f"batch_norm_{kind}_" + _suffix("batch_norm_" + kind, x)
    _check_vectors(name, x, weight, bias, mean, invstd)
    layout = _layout(x)
    x = _channels_last(x)
    y = _empty(x)
    rows, c = x.shape[0] * x.shape[2] * x.shape[3], x.shape[1]
    if residual is None:
        _, p = _plan_for(x, _lanes(x, (), (x, y)))
        _build.launch(name, x.device, x.data_ptr(), y.data_ptr(),
                      mean.data_ptr(), invstd.data_ptr(), _ptr(weight),
                      bias.data_ptr(), rows, c, p.lanes, p.tile_vectors,
                      p.chunk_rows, p.chunks, p.tiles, int(relu))
    else:
        _check_like(name, x, residual)
        residual = _channels_last(residual)
        _, p = _plan_for(x, _lanes(x, (), (x, residual, y)))
        _build.launch(name, x.device, x.data_ptr(), residual.data_ptr(),
                      y.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
                      _ptr(weight), bias.data_ptr(), rows, c, p.lanes,
                      p.tile_vectors, p.chunk_rows, p.chunks, p.tiles)
    return y.contiguous(memory_format=layout)


def _apply_residual(x, weight, bias, mean, invstd, residual):
    return _apply(x, weight, bias, mean, invstd, True, residual)


def _backward(dy, x, weight, bias, mean, invstd, relu, output_mask,
              out=None):
    """(dx in x's layout or an empty tensor, dweight or an empty tensor,
    dbias), and with the forward's `out` of a residual apply, dresidual
    (g) in x's layout after them: the plain versions on the CPU, the two
    backward kernels on CUDA (with `out`, the residual reduce, which
    writes g, then the elementwise kernel on g without the ReLU)."""
    c = x.shape[1]
    if dy.device.type == "cpu":
        grads = (backward_plain(dy, x, weight, bias, mean, invstd, relu,
                                output_mask) if out is None else
                 backward_residual_plain(dy, out, x, weight, bias, mean,
                                         invstd, output_mask))
        dx, dw, db = grads[:3]
        layout = _layout(x)
        return (x.new_empty((0,)) if dx is None
                else dx.contiguous(memory_format=layout),
                mean.new_empty((0,)) if dw is None else dw,
                db if db is not None else mean.new_empty((c,))) + tuple(
                    g.contiguous(memory_format=layout) for g in grads[3:])
    sfx = _suffix("batch_norm_backward", x)
    _check_like("batch_norm_backward", x, dy)
    _check_vectors("batch_norm_backward", x, weight, bias, mean, invstd)
    layout = _layout(x)
    x = _channels_last(x)
    dy, ldg = _nhwc(dy)
    rows = x.shape[0] * x.shape[2] * x.shape[3]
    dx = _empty(x) if output_mask[0] else x.new_empty((0,))
    extra = ()
    if out is not None:
        _check_like("batch_norm_backward", x, out)
        out, g = _channels_last(out), _empty(x)
        extra = (out, g)
    tickets, p = _plan_for(x, _lanes(
        x, (ldg,), (x, dy) + ((dx,) if output_mask[0] else ()) + extra))
    part = torch.empty((p.chunks + p.groups) * 2 * c, dtype=torch.float32,
                       device=x.device)
    coef = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    db = torch.empty(c, dtype=torch.float32, device=x.device)
    dw = mean.new_empty((0,)) if weight is None else torch.empty_like(db)
    if out is None:
        _build.launch("batch_norm_bwd_reduce_" + sfx, x.device,
                      dy.data_ptr(), x.data_ptr(), mean.data_ptr(),
                      invstd.data_ptr(), _ptr(weight), bias.data_ptr(),
                      part.data_ptr(), tickets.data_ptr(),
                      _ptr(None if weight is None else dw), db.data_ptr(),
                      coef.data_ptr(), rows, c, ldg, p.lanes,
                      p.tile_vectors, p.chunk_rows, p.chunks, p.tiles, GROUP,
                      int(relu))
    else:
        _build.launch("batch_norm_bwd_reduce_residual_" + sfx, x.device,
                      dy.data_ptr(), out.data_ptr(), x.data_ptr(),
                      g.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
                      _ptr(weight), bias.data_ptr(), part.data_ptr(),
                      tickets.data_ptr(),
                      _ptr(None if weight is None else dw), db.data_ptr(),
                      coef.data_ptr(), rows, c, ldg, p.lanes,
                      p.tile_vectors, p.chunk_rows, p.chunks, p.tiles, GROUP)
        # The elementwise pass reads g (rows c apart) where it read dy.
        dy, ldg, relu = g, c, False
    if output_mask[0]:
        _build.launch("batch_norm_bwd_elemt_" + sfx, x.device, dy.data_ptr(),
                      x.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
                      _ptr(weight), bias.data_ptr(), coef.data_ptr(),
                      dx.data_ptr(), rows, c, ldg, p.lanes, p.tile_vectors,
                      p.chunk_rows, p.chunks, p.tiles, int(relu))
        dx = dx.contiguous(memory_format=layout)
    return (dx, dw, db) + tuple(
        t.contiguous(memory_format=layout) for t in extra[1:])


def _backward_residual(dy, out, x, weight, bias, mean, invstd, output_mask):
    return _backward(dy, x, weight, bias, mean, invstd, True, output_mask,
                     out)


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------


def batch_norm_train(x: torch.Tensor, weight: Optional[torch.Tensor],
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, momentum: float, eps: float,
                     relu: bool, update: bool,
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BatchNorm's train-mode forward of NCHW x, and the ReLU where `relu`;
    with a `residual` of x's shape and dtype (taken with `relu` only),
    relu(BN(x) + residual); the running statistics moved where `update`
    (see the module docstring)."""
    if residual is not None and not relu:
        raise ValueError("batch_norm_train: a residual is added before the "
                         "ReLU; pass relu=True")
    mean, invstd = torch.ops.gvcnn.batch_norm_stats(
        x.detach(), running_mean, running_var, momentum, eps, update)
    if residual is not None:
        return torch.ops.gvcnn.batch_norm_apply_residual(
            x, weight, bias, mean, invstd, residual)
    return torch.ops.gvcnn.batch_norm_apply(x, weight, bias, mean, invstd,
                                            relu)


def _stats_fake(x, running_mean, running_var, momentum, eps, update):
    c = x.shape[1]
    return (x.new_empty((c,), dtype=torch.float32),
            x.new_empty((c,), dtype=torch.float32))


def _apply_fake(x, weight, bias, mean, invstd, relu):
    return _empty(x)


def _backward_fake(dy, x, weight, bias, mean, invstd, relu, output_mask):
    c = x.shape[1]
    return (_empty(x) if output_mask[0] else x.new_empty((0,)),
            mean.new_empty((0,) if weight is None else (c,)),
            mean.new_empty((c,)))


def _apply_residual_fake(x, weight, bias, mean, invstd, residual):
    return _empty(x)


def _backward_residual_fake(dy, out, x, weight, bias, mean, invstd,
                            output_mask):
    return _backward_fake(dy, x, weight, bias, mean, invstd, True,
                          output_mask) + (_empty(x),)


torch.library.define(
    "gvcnn::batch_norm_stats",
    "(Tensor x, Tensor(a!) running_mean, Tensor(b!) running_var, "
    "float momentum, float eps, bool update) -> (Tensor, Tensor)")
torch.library.impl("gvcnn::batch_norm_stats", "default", _stats)
torch.library.register_fake("gvcnn::batch_norm_stats", _stats_fake)
torch.library.define(
    "gvcnn::batch_norm_apply",
    "(Tensor x, Tensor? weight, Tensor bias, Tensor mean, Tensor invstd, "
    "bool relu) -> Tensor")
torch.library.impl("gvcnn::batch_norm_apply", "default", _apply)
torch.library.register_fake("gvcnn::batch_norm_apply", _apply_fake)
torch.library.define(
    "gvcnn::batch_norm_backward",
    "(Tensor dy, Tensor x, Tensor? weight, Tensor bias, Tensor mean, "
    "Tensor invstd, bool relu, bool[3] output_mask) -> "
    "(Tensor, Tensor, Tensor)")
torch.library.impl("gvcnn::batch_norm_backward", "default", _backward)
torch.library.register_fake("gvcnn::batch_norm_backward", _backward_fake)
torch.library.define(
    "gvcnn::batch_norm_apply_residual",
    "(Tensor x, Tensor? weight, Tensor bias, Tensor mean, Tensor invstd, "
    "Tensor residual) -> Tensor")
torch.library.impl("gvcnn::batch_norm_apply_residual", "default",
                   _apply_residual)
torch.library.register_fake("gvcnn::batch_norm_apply_residual",
                            _apply_residual_fake)
torch.library.define(
    "gvcnn::batch_norm_backward_residual",
    "(Tensor dy, Tensor out, Tensor x, Tensor? weight, Tensor bias, "
    "Tensor mean, Tensor invstd, bool[3] output_mask) -> "
    "(Tensor, Tensor, Tensor, Tensor)")
torch.library.impl("gvcnn::batch_norm_backward_residual", "default",
                   _backward_residual)
torch.library.register_fake("gvcnn::batch_norm_backward_residual",
                            _backward_residual_fake)


def _apply_setup_context(ctx, inputs, output):
    x, weight, bias, mean, invstd, relu = inputs
    ctx.save_for_backward(x, weight, bias, mean, invstd)
    ctx.relu = relu


def _apply_backward(ctx, dy):
    """BatchNorm's whole gradient (through the batch statistics) from the
    saved x and statistics; mean and invstd get none."""
    x, weight, bias, mean, invstd = ctx.saved_tensors
    need = ctx.needs_input_grad
    mask: List[bool] = [need[0], weight is not None and need[1], need[2]]
    dx, dw, db = torch.ops.gvcnn.batch_norm_backward(
        dy, x, weight, bias, mean, invstd, ctx.relu, mask)
    return (dx if mask[0] else None, dw if mask[1] else None,
            db if mask[2] else None, None, None, None)


torch.library.register_autograd("gvcnn::batch_norm_apply", _apply_backward,
                                setup_context=_apply_setup_context)


def _apply_residual_setup_context(ctx, inputs, output):
    x, weight, bias, mean, invstd, _ = inputs
    ctx.save_for_backward(x, weight, bias, mean, invstd, output)


def _apply_residual_backward(ctx, dout):
    """BatchNorm's whole gradient and the residual's (g, the ReLU's
    gradient) from the saved x, statistics and out."""
    x, weight, bias, mean, invstd, out = ctx.saved_tensors
    need = ctx.needs_input_grad
    mask: List[bool] = [need[0], weight is not None and need[1], need[2]]
    dx, dw, db, dr = torch.ops.gvcnn.batch_norm_backward_residual(
        dout, out, x, weight, bias, mean, invstd, mask)
    return (dx if mask[0] else None, dw if mask[1] else None,
            db if mask[2] else None, None, None, dr if need[5] else None)


torch.library.register_autograd("gvcnn::batch_norm_apply_residual",
                                _apply_residual_backward,
                                setup_context=_apply_residual_setup_context)


def _no_second_derivative(ctx, *grads):
    raise NotImplementedError("the BatchNorm backward ops have no gradient: "
                              "the port takes no second derivative")


# Registered so that the backward ops run below autograd, as the forwards
# do, and refuse a gradient instead of recording their plain versions' ops.
for _op in ("gvcnn::batch_norm_backward",
            "gvcnn::batch_norm_backward_residual"):
    torch.library.register_autograd(
        _op, _no_second_derivative,
        setup_context=lambda ctx, inputs, output: None)
