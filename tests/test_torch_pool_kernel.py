"""The max pool's plain versions, its autograd Function, its ops and its
export on the CPU (`gvcnn_tf_tpu_torch/ops/pool_kernel.py`).  The CUDA
kernels are held to these plain versions on the card, in
tests/test_torch_cuda_kernels.py.

Every pool geometry of Inception-v1 (13) and ResNet-50 (1), cut to N = 2
and to H = W = 12 where the published size is larger (12 keeps the parity
of 112, 56 and 28, so each TF-'SAME' pad is the published one), with the
published channels.  Tolerances: values, records and single-window
gradients exact; a gradient summed over several windows in fp32 in another
order than autograd's, rtol = atol = 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import (  # noqa: E402
    InceptionV1Base,
)
from gvcnn_tf_tpu_torch.models.backbones.layers import remat  # noqa: E402
from gvcnn_tf_tpu_torch.ops import pool_kernel as pk  # noqa: E402
from gvcnn_tf_tpu_torch.ops.pool import _pads, max_pool  # noqa: E402

# (pool, H = W, C, k, s) of every max pool of Inception-v1 and ResNet-50 at
# 224x224.
POOLS = [
    ("MaxPool_2a_3x3", 112, 64, 3, 2), ("MaxPool_3a_3x3", 56, 192, 3, 2),
    ("Mixed_3b", 28, 192, 3, 1), ("Mixed_3c", 28, 256, 3, 1),
    ("MaxPool_4a_3x3", 28, 480, 3, 2), ("Mixed_4b", 14, 480, 3, 1),
    ("Mixed_4c", 14, 512, 3, 1), ("Mixed_4d", 14, 512, 3, 1),
    ("Mixed_4e", 14, 512, 3, 1), ("Mixed_4f", 14, 528, 3, 1),
    ("MaxPool_5a_2x2", 14, 832, 2, 2), ("Mixed_5b", 7, 832, 3, 1),
    ("Mixed_5c", 7, 832, 3, 1), ("resnet50_pool1", 112, 64, 3, 2)]


def _case(h, c, k, s, seed=0, ties=False):
    """(x, (kernel, strides, pads)) of one pool, cut to size."""
    small = h if h <= 14 else 12
    rs = np.random.RandomState(seed + h + c + k + s)
    x = rs.randn(2, c, small, small).astype(np.float32)
    if ties:
        x = np.round(x)
    x = torch.from_numpy(x)
    pads = _pads(x, (k, k), (s, s), "SAME")
    assert pads == _pads(torch.empty(1, 1, h, h), (k, k), (s, s), "SAME")
    return x, ((k, k), (s, s), pads)


def _padded(x, pads):
    (pt, pb), (pl, pr) = pads
    return F.pad(x, (pl, pr, pt, pb), value=-torch.inf)


@pytest.mark.parametrize("name,h,c,k,s", POOLS)
def test_plain_is_the_padded_pool(name, h, c, k, s):
    """The CPU path is `F.max_pool2d` over the TF-'SAME'-padded input, and
    launches nothing; the plain record's values are the same."""
    x, geo = _case(h, c, k, s)
    want = F.max_pool2d(_padded(x, geo[2]), geo[0], geo[1])
    launches = (pk.max_pool_same.launches, pk.max_pool_same.launches_bwd)
    assert torch.equal(pk.max_pool_plain(x, *geo), want)
    assert torch.equal(max_pool(x, geo[0], geo[1]), want)
    assert torch.equal(pk.max_pool_record_plain(x, *geo)[0], want)
    assert (pk.max_pool_same.launches,
            pk.max_pool_same.launches_bwd) == launches


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("name,h,c,k,s", POOLS)
def test_plain_record_is_max_pool2d_indices(name, h, c, k, s, ties):
    """The plain record is `F.max_pool2d`'s int64 indices into the padded
    plane, mapped to window slots; with ties (rounded draws) both credit
    the first maximum in row-major order."""
    x, geo = _case(h, c, k, s, ties=ties)
    xp = _padded(x, geo[2])
    _, idx = F.max_pool2d(xp, geo[0], geo[1], return_indices=True)
    ho, wo = idx.shape[2:]
    oh = torch.arange(ho).view(-1, 1) * s
    ow = torch.arange(wo).view(1, -1) * s
    want = (idx // xp.shape[3] - oh) * k + (idx % xp.shape[3] - ow)
    _, slot = pk.max_pool_record_plain(x, *geo)
    assert slot.dtype == torch.uint8
    assert torch.equal(slot.long(), want)


def test_ties_neg_inf_and_nan_follow_the_first_maximum():
    """A 2x2/2 window with a tie takes its first maximum; a 3x3/1 window
    at the corner whose in-image taps are all -inf credits its first
    in-image tap; a window with two NaNs gives NaN and credits the first,
    and the gradient goes there."""
    x = torch.zeros(1, 1, 4, 4)
    x[0, 0, 0, 1] = x[0, 0, 1, 0] = 5.0          # tie in window (0, 0)
    geo = ((2, 2), (2, 2), ((0, 0), (0, 0)))
    y, slot = pk.max_pool_record_plain(x, *geo)
    assert y[0, 0, 0, 0] == 5.0 and slot[0, 0, 0, 0] == 1

    x = torch.full((1, 1, 3, 3), -torch.inf)
    geo = ((3, 3), (1, 1), ((1, 1), (1, 1)))
    y, slot = pk.max_pool_record_plain(x, *geo)
    assert torch.equal(y, F.max_pool2d(x, 3, 1, padding=1))
    assert slot[0, 0, 0, 0] == 4 and slot[0, 0, 2, 2] == 0
    assert slot[0, 0, 1, 1] == 0

    x = torch.arange(16.0).view(1, 1, 4, 4)
    x[0, 0, 2, 1] = x[0, 0, 3, 0] = torch.nan    # window (1, 0): slots 1, 2
    geo = ((2, 2), (2, 2), ((0, 0), (0, 0)))
    y, slot = pk.max_pool_record_plain(x, *geo)
    assert y[0, 0, 1, 0].isnan() and slot[0, 0, 1, 0] == 1
    assert F.max_pool2d(x, 2, 2)[0, 0, 1, 0].isnan()
    xg = x.clone().requires_grad_()
    pk.MaxPoolFunction.apply(xg, *geo).sum().backward()
    assert xg.grad[0, 0, 2, 1] == 1 and xg.grad[0, 0, 3, 0] == 0


@pytest.mark.parametrize("name,h,c,k,s", POOLS)
def test_function_backward_is_autograds(name, h, c, k, s):
    """The Function on the CPU (the plain record, the plain gather) against
    autograd through `F.pad` + `F.max_pool2d`: the same output, dx equal
    where an input wins one window or none, within rtol 1e-6 where it wins
    several; the only tensor saved for the backward is the uint8 record."""
    x, geo = _case(h, c, k, s, seed=1)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = pk.MaxPoolFunction.apply(xa, *geo)
    want = pk.max_pool_plain(xb, *geo)
    assert torch.equal(y, want)
    assert saved == [(torch.uint8, tuple(y.shape))]
    dy = torch.from_numpy(np.random.RandomState(2).randn(
        *y.shape).astype(np.float32))
    y.backward(dy)
    want.backward(dy)
    _, slot = pk.max_pool_record_plain(x, *geo)
    wins = pk.max_pool_backward_plain(torch.ones_like(dy), slot,
                                      x.shape[2:], *geo)
    once = wins <= 1
    assert torch.equal(xa.grad[once], xb.grad[once])
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-6, atol=1e-6)


def test_remat_writes_the_record_again():
    """Under `layers.remat` the Function's forward runs again in the
    backward (its record is not kept) and the gradient is the same."""
    x, geo = _case(28, 16, 3, 2)
    calls = []
    real = pk._forward

    def counted(*a):
        calls.append(a[-1])
        return real(*a)

    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    pk.MaxPoolFunction.apply(xb, *geo).square().sum().backward()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pk, "_forward", counted)
        remat(lambda t: pk.MaxPoolFunction.apply(t, *geo).square(),
              xa).sum().backward()
    assert calls == [True, True]
    assert torch.equal(xa.grad, xb.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["forward", "forward_record", "backward"])
def test_opcheck_pool_ops(dtype, which):
    """`torch.library.opcheck` of `gvcnn::max_pool_same` (with and without
    the record) and `gvcnn::max_pool_same_backward` on CPU tensors: schema,
    fake implementation (channels-last shapes and dtypes), AOT dispatch."""
    x, (kernel, strides, pads) = _case(12, 16, 3, 2)
    x = x.to(dtype)
    flat = [pads[0][0], pads[0][1], pads[1][0], pads[1][1]]
    if which.startswith("forward"):
        torch.library.opcheck(torch.ops.gvcnn.max_pool_same.default, (
            x, list(kernel), list(strides), flat, which == "forward_record"))
        return
    y, slot = torch.ops.gvcnn.max_pool_same(x, list(kernel), list(strides),
                                            flat, True)
    torch.library.opcheck(torch.ops.gvcnn.max_pool_same_backward.default, (
        torch.randn_like(y), slot, [12, 12], list(kernel), list(strides),
        flat))


def test_fake_gives_the_outputs_shape_and_dtype():
    """Under fake tensors the ops give channels-last outputs of the pool's
    shape in x's dtype (the record uint8, empty without it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(2, 64, 112, 112, dtype=torch.bfloat16)
        y, slot = torch.ops.gvcnn.max_pool_same(x, [3, 3], [2, 2],
                                                [0, 1, 0, 1], True)
        _, none = torch.ops.gvcnn.max_pool_same(x, [2, 2], [2, 2],
                                                [0, 0, 0, 0], False)
        dx = torch.ops.gvcnn.max_pool_same_backward(
            y, slot, [112, 112], [3, 3], [2, 2], [0, 1, 0, 1])
    assert (tuple(y.shape), y.dtype) == ((2, 64, 56, 56), torch.bfloat16)
    assert (tuple(slot.shape), slot.dtype) == ((2, 64, 56, 56), torch.uint8)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert (tuple(none.shape), none.dtype) == ((0,), torch.uint8)
    assert (tuple(dx.shape), dx.dtype) == ((2, 64, 112, 112),
                                           torch.bfloat16)


def test_export_traces_the_backbone_through_the_op():
    """`torch.export` of Inception-v1 (eval, 64x64) holds its 13 pools as
    `gvcnn::max_pool_same` without the record, and the artifact gives the
    eager model's features exactly."""
    torch.manual_seed(0)
    model = InceptionV1Base().eval().requires_grad_(False)
    x = torch.rand(2, 64, 64, 3) * 2 - 1
    ep = torch.export.export(model, (x,))
    pools = [n for n in ep.graph.nodes
             if str(n.target) == "gvcnn.max_pool_same.default"]
    assert len(pools) == 13
    assert not any(n.args[4] for n in pools)
    assert not any("max_pool2d" in str(n.target) for n in ep.graph.nodes)
    got, want = ep.module()(x)[0], model(x)[0]
    assert torch.equal(got, want)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def test_a_dispatch_mode_sees_one_op_each_way():
    """Under a dispatch mode (the per-layer tools' counters) a pool that
    takes a gradient is `gvcnn::max_pool_same` forward and
    `gvcnn::max_pool_same_backward` backward, with autograd's gradient."""
    x, geo = _case(56, 8, 3, 2)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    with _Ops() as ops:
        max_pool(xa, geo[0], geo[1]).sum().backward()
    pk.max_pool_plain(xb, *geo).sum().backward()
    assert "gvcnn::max_pool_same" in ops.names
    assert "gvcnn::max_pool_same_backward" in ops.names
    assert not any("max_pool2d" in n for n in ops.names)
    assert torch.equal(xa.grad, xb.grad)


def test_refuses_what_the_kernels_do_not_take():
    """Only bf16 and fp32 have kernels, and only the backbones' windows."""
    assert pk.kernel_names(torch.bfloat16) == ("max_pool_same_fwd_bf16",
                                               "max_pool_same_bwd_bf16")
    assert pk.kernel_names(torch.float32) == ("max_pool_same_fwd_f32",
                                              "max_pool_same_bwd_f32")
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError):
            pk.kernel_names(dtype)
    for kernel, strides, pads in [((5, 5), (2, 2), ((2, 2), (2, 2))),
                                  ((3, 3), (1, 2), ((1, 1), (0, 1))),
                                  ((3, 2), (2, 2), ((0, 1), (0, 0))),
                                  ((3, 3), (2, 2), ((3, 0), (0, 1)))]:
        with pytest.raises(ValueError):
            pk._check_geometry(kernel, strides, pads)
    assert pk._check_geometry((3, 3), (2, 2), ((0, 1), (0, 1))) == (3, 2)


@pytest.mark.parametrize("dtype,c,offset,record_offset,fits", [
    (torch.bfloat16, 64, 0, 0, True), (torch.float32, 4, 0, 0, True),
    (torch.bfloat16, 3, 0, 0, False), (torch.bfloat16, 4, 0, 0, False),
    (torch.float32, 6, 0, 0, False), (torch.bfloat16, 8, 1, 0, False),
    (torch.float32, 8, 2, 0, False), (torch.bfloat16, 8, 0, 4, False),
    (torch.float32, 8, 0, 4, True)])
def test_the_kernels_take_whole_aligned_channel_vectors(dtype, c, offset,
                                                        record_offset, fits):
    """A thread of the kernels moves 16 bytes of channels: C a multiple of
    8 (bf16) or 4 (fp32), the data 16-byte aligned and the record aligned
    to a vector's bytes (8 or 4); anything else raises before a launch."""
    n = 2 * c * 6 * 6
    data = torch.zeros(offset + n, dtype=dtype)[offset:]
    data = data.view(2, 6, 6, c).permute(0, 3, 1, 2)
    record = torch.zeros(record_offset + n, dtype=torch.uint8)[record_offset:]
    record = record.view(2, 6, 6, c).permute(0, 3, 1, 2)
    assert data.is_contiguous(memory_format=torch.channels_last)
    if fits:
        pk._check_vectors("pool", data, record)
    else:
        with pytest.raises(ValueError):
            pk._check_vectors("pool", data, record)
