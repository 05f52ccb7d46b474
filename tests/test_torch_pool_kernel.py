"""The max and average pools' plain versions, their ops with their
registered gradients, and their export on the CPU (`gvcnn_tf_tpu_torch/ops/
pool_kernel.py`).  The CUDA kernels are held to these plain versions on the
card, in tests/test_torch_cuda_kernels.py.

Max pools: every pool geometry of Inception-v1 (13) and ResNet-50 (1),
cut to N = 2 and to H = W = 12 where the published size is larger (12
keeps the parity of 112, 56 and 28, so each TF-'SAME' pad is the published
one), with the published channels.  Tolerances: values, records and
single-window gradients exact; a gradient summed over several windows in
fp32 in another order than autograd's, rtol = atol = 1e-6.  Average pools:
every 3x3/1 'SAME' pool of Inception-v2, v3 and v4 (`AVG_POOLS`), the
forward equal to `F.avg_pool2d` counting the pads, the backward's box sum
within rtol = atol = 1e-6 of autograd's gradient.
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
from gvcnn_tf_tpu_torch.ops import launched  # noqa: E402
from gvcnn_tf_tpu_torch.ops import pool_kernel as pk  # noqa: E402
from gvcnn_tf_tpu_torch.ops.pool import (  # noqa: E402
    _pads,
    avg_pool,
    max_pool,
)

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
    launches = launched()
    assert torch.equal(pk.max_pool_plain(x, *geo), want)
    assert torch.equal(max_pool(x, geo[0], geo[1]), want)
    assert torch.equal(pk.max_pool_record_plain(x, *geo)[0], want)
    assert launched() == launches


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
    pk.max_pool_same(xg, *geo).sum().backward()
    assert xg.grad[0, 0, 2, 1] == 1 and xg.grad[0, 0, 3, 0] == 0


@pytest.mark.parametrize("name,h,c,k,s", POOLS)
def test_function_backward_is_autograds(name, h, c, k, s):
    """The op on the CPU (the plain record, the plain gather) against
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
        y = pk.max_pool_same(xa, *geo)
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
    """Under `layers.remat` the op's forward runs again in the backward
    (its record is not kept) and the gradient is the same."""
    x, geo = _case(28, 16, 3, 2)
    calls = []
    real = pk._forward

    def counted(*a):
        calls.append(a[-1])
        return real(*a)

    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    pk.max_pool_same(xb, *geo).square().sum().backward()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pk, "_forward", counted)
        remat(lambda t: pk.max_pool_same(t, *geo).square(),
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


# ---------------------------------------------------------------------------
# The 3x3/1 'SAME' average pool (csrc/avg_pool.cu): plain versions, the
# ops with their gradient, and the export, on the CPU.
# ---------------------------------------------------------------------------

# (pool, H = W, C) of every average pool of the backbones: Inception-v4's 14
# at 299x299 (N cut to 2), Inception-v2's 7 at 224 and v3's 9 at 299, cut
# to H = W = 12 where the published size is larger than 14 (the pads of a
# 3x3/1 'SAME' pool are (1, 1) at every size).
AVG_POOLS = (
    [(f"v4_Mixed_5{b}", 35, 384) for b in "bcde"]
    + [(f"v4_Mixed_6{b}", 17, 1024) for b in "bcdefgh"]
    + [(f"v4_Mixed_7{b}", 8, 1536) for b in "bcd"]
    + [("v2_Mixed_3b", 28, 192), ("v2_Mixed_3c", 28, 256)]
    + [(f"v2_Mixed_4{b}", 14, 576) for b in "bcde"]
    + [("v2_Mixed_5b", 7, 1024)]
    + [("v3_Mixed_5b", 35, 192), ("v3_Mixed_5c", 35, 256),
       ("v3_Mixed_5d", 35, 288)]
    + [(f"v3_Mixed_6{b}", 17, 768) for b in "bcde"]
    + [("v3_Mixed_7b", 8, 1280), ("v3_Mixed_7c", 8, 2048)])


def _avg_case(name, h, c, seed=0):
    """(x, dy) of one average pool, cut to size."""
    small = h if name.startswith("v4") or h <= 14 else 12
    rs = np.random.RandomState(seed + h + c)
    x, dy = rs.randn(2, 2, c, small, small).astype(np.float32)
    assert _pads(torch.empty(1, 1, h, h), (3, 3), (1, 1), "SAME") == (
        (1, 1), (1, 1))
    return torch.from_numpy(x), torch.from_numpy(dy)


@pytest.mark.parametrize("name,h,c", AVG_POOLS)
def test_avg_plain_is_avg_pool2d_counting_the_pads(name, h, c):
    """The CPU path is `F.avg_pool2d` with `count_include_pad=True`, the
    same through `pool.avg_pool` and the op's implementation (channels-last
    there), and launches nothing."""
    x, _ = _avg_case(name, h, c)
    want = F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)
    launches = launched()
    assert torch.equal(pk.avg_pool_plain(x), want)
    assert torch.equal(avg_pool(x, (3, 3), (1, 1)), want)
    got = pk._box(x, False)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    assert launched() == launches


@pytest.mark.parametrize("name,h,c", AVG_POOLS)
def test_avg_backward_plain_is_autograds(name, h, c):
    """`avg_pool_backward_plain(dy)`, the zero-padded box sum of dy over 9,
    is autograd's gradient through `F.avg_pool2d` (rtol = atol = 1e-6: the
    sums run in another order); the op gives the plain forward and that
    backward, and saves no tensor."""
    x, dy = _avg_case(name, h, c, seed=1)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = pk.avg_pool_same(xa)
    want = F.avg_pool2d(xb, 3, 1, padding=1, count_include_pad=True)
    assert saved == []
    assert torch.equal(y, want)
    y.backward(dy)
    want.backward(dy)
    plain = pk.avg_pool_backward_plain(dy)
    assert torch.equal(xa.grad, plain)
    torch.testing.assert_close(plain, xb.grad, rtol=1e-6, atol=1e-6)


def test_avg_backward_plain_rounds_once_in_dy_dtype():
    """In bf16 the plain backward sums in fp32, divides by 9 and rounds
    once: the fp32 result rounded to bf16, exactly."""
    _, dy = _avg_case("v4_Mixed_6b", 17, 64, seed=2)
    got = pk.avg_pool_backward_plain(dy.to(torch.bfloat16))
    want = pk.avg_pool_backward_plain(dy.to(torch.bfloat16).float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_avg_remat_saves_nothing_and_gives_the_gradient():
    """Under `layers.remat` the op's forward runs again in the backward
    and the gradient is the same."""
    x, _ = _avg_case("v2_Mixed_4b", 14, 32)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    pk.avg_pool_same(xb).square().sum().backward()
    calls = []
    real = pk._box

    def counted(t, backward):
        calls.append(backward)
        return real(t, backward)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pk, "_box", counted)
        remat(lambda t: pk.avg_pool_same(t).square(),
              xa).sum().backward()
    assert calls == [False, False, True]
    assert torch.equal(xa.grad, xb.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_opcheck_avg_pool_ops(dtype, which):
    """`torch.library.opcheck` of `gvcnn::avg_pool_same` and
    `gvcnn::avg_pool_same_backward` on CPU tensors: schema, fake
    implementation (channels-last outputs), AOT dispatch."""
    x, dy = _avg_case("v2_Mixed_3b", 28, 16)
    op = (torch.ops.gvcnn.avg_pool_same if which == "forward"
          else torch.ops.gvcnn.avg_pool_same_backward)
    torch.library.opcheck(op.default, ((x if which == "forward"
                                        else dy).to(dtype),))


def test_avg_fake_gives_channels_last_outputs_of_the_input_shape():
    """Under fake tensors both ops give a channels-last tensor of their
    input's shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(2, 384, 35, 35, dtype=torch.bfloat16)
        y = torch.ops.gvcnn.avg_pool_same(x)
        dx = torch.ops.gvcnn.avg_pool_same_backward(y)
    for t in (y, dx):
        assert (tuple(t.shape), t.dtype) == ((2, 384, 35, 35),
                                             torch.bfloat16)
        assert t.is_contiguous(memory_format=torch.channels_last)


def test_export_traces_inception_v4_through_the_avg_op():
    """`torch.export` of Inception-v4 (eval, 80x80) holds its 14 average
    pools as `gvcnn::avg_pool_same` and no `avg_pool2d`, and the artifact
    gives the eager model's features."""
    from gvcnn_tf_tpu_torch.models.backbones.inception_v4 import (
        InceptionV4Base,
    )

    torch.manual_seed(0)
    model = InceptionV4Base().eval().requires_grad_(False)
    x = torch.rand(1, 80, 80, 3) * 2 - 1
    ep = torch.export.export(model, (x,))
    targets = [str(n.target) for n in ep.graph.nodes]
    assert targets.count("gvcnn.avg_pool_same.default") == 14
    assert not any("avg_pool2d" in t for t in targets)
    torch.testing.assert_close(ep.module()(x)[0], model(x)[0], rtol=1e-5,
                               atol=1e-5)


def test_a_dispatch_mode_sees_one_avg_op_each_way():
    """Under a dispatch mode a pool that takes a gradient is
    `gvcnn::avg_pool_same` forward and `gvcnn::avg_pool_same_backward`
    backward, with autograd's gradient."""
    x, dy = _avg_case("v3_Mixed_6b", 17, 16)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    with _Ops() as ops:
        avg_pool(xa, (3, 3), (1, 1)).backward(dy)
    F.avg_pool2d(xb, 3, 1, padding=1).backward(dy)
    assert "gvcnn::avg_pool_same" in ops.names
    assert "gvcnn::avg_pool_same_backward" in ops.names
    assert not any("avg_pool2d" in n for n in ops.names)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel,strides,padding", [
    ((3, 3), (2, 2), "SAME"), ((3, 3), (1, 1), "VALID"),
    ((2, 2), (1, 1), "SAME"), ((5, 5), (1, 1), "SAME"),
    ((3, 1), (1, 1), "SAME")])
def test_avg_pool_refuses_another_geometry(kernel, strides, padding):
    """`pool.avg_pool` takes the backbones' 3x3/1 'SAME' window alone:
    another raises on the CPU as on a card, and under a dispatch mode,
    before any pooling."""
    x, _ = _avg_case("v2_Mixed_4b", 14, 16)
    with pytest.raises(ValueError, match="3x3 window at stride 1"):
        avg_pool(x, kernel, strides, padding)
    with _Ops() as ops, pytest.raises(ValueError,
                                      match="3x3 window at stride 1"):
        avg_pool(x, kernel, strides, padding)
    assert not any("avg_pool" in n for n in ops.names)


def test_avg_pool_refuses_what_the_kernels_do_not_take():
    """Only bf16 and fp32 have kernels (another dtype raises on a card:
    `test_avg_pool_refuses_on_the_card_without_launching`), and C has to
    fill 16-byte channel vectors: a multiple of 8 in bf16 (4 in fp32)."""
    assert pk.AVG_KERNELS == {
        torch.bfloat16: ("avg_pool_same_fwd_bf16", "avg_pool_same_bwd_bf16"),
        torch.float32: ("avg_pool_same_fwd_f32", "avg_pool_same_bwd_f32")}
    for dtype, c, fits in [(torch.bfloat16, 384, True),
                           (torch.bfloat16, 12, False),
                           (torch.float32, 12, True),
                           (torch.float32, 6, False)]:
        data = torch.zeros(2, c, 5, 5, dtype=dtype).contiguous(
            memory_format=torch.channels_last)
        if fits:
            pk._check_vectors("avg_pool_same_fwd", data)
        else:
            with pytest.raises(ValueError, match="multiple"):
                pk._check_vectors("avg_pool_same_fwd", data)
