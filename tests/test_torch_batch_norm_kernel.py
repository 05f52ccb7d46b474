"""Train-mode BatchNorm (+ ReLU) on the CPU: the ops' plain route
(`gvcnn_tf_tpu_torch/ops/batch_norm_kernel.py`), its fakes and registered
gradient, the launch plan, and where `BatchNorm` reaches the ops.  The
CUDA kernels are held to these plain versions on the card, in
tests/test_torch_cuda_kernels.py.

The plain route computes what the port computed before the ops existed,
`torch.native_batch_norm` in training mode, then `F.relu`, then the
running statistics' EMA of the biased variance 1 / invstd^2 - eps: y, the
statistics, the running statistics and the gradients of x, scale and bias
are compared with that bit for bit.  The gradient check runs in float64
(finite differences of the whole train-mode forward, through the batch
statistics).

The residual op (ResNet's relu(shortcut + BN(conv3)) in one apply) is held
to the unfused route it replaced, the train-mode op without the ReLU, the
add and `torch.relu` under autograd: bit for bit in fp32; in bf16, where
the fused op rounds the fp32 sum once, out equals the fp32 result rounded
(so within one bf16 ulp of it) and the gradients are the unfused
backward's given that out's mask.
"""

import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

import torch.nn as nn  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from gvcnn_tf_tpu_torch.models.backbones import layers  # noqa: E402
from gvcnn_tf_tpu_torch.models.backbones.layers import (  # noqa: E402
    BatchNorm,
    ConvBN,
    remat,
)
from gvcnn_tf_tpu_torch.ops import batch_norm_kernel as bk  # noqa: E402

EPS, MOMENTUM = 1e-3, 0.9
BN_OPS = {"gvcnn::batch_norm_stats", "gvcnn::batch_norm_apply",
          "gvcnn::batch_norm_backward"}
RESIDUAL_OPS = {"gvcnn::batch_norm_apply_residual",
                "gvcnn::batch_norm_backward_residual"}


class _Ops(TorchDispatchMode):
    """Counts the ops dispatched under it by name (an op's own inner ops
    run below it and are not seen)."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen[func._schema.name] += 1
        return func(*args, **(kwargs or {}))


def _case(dtype, channels_last, scale, seed=0, shape=(4, 24, 6, 5)):
    """(x, dy, BatchNorm): x with a mean and a spread of its own a channel;
    the module's bias (and scale) drawn, so the ReLU cuts some of y."""
    rs = np.random.RandomState(seed)
    n, c, h, w = shape
    x = (rs.randn(n, c, h, w) * rs.uniform(0.2, 3.0, (1, c, 1, 1))
         + rs.randn(1, c, 1, 1))
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rs.randn(n, c, h, w).astype(np.float32)).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    bn = BatchNorm(c, EPS, MOMENTUM, use_scale=scale).train()
    with torch.no_grad():
        bn.bias.copy_(torch.from_numpy(rs.randn(c).astype(np.float32)) / 2)
        bn.running_mean.copy_(torch.from_numpy(rs.randn(c).astype(
            np.float32)))
        if scale:
            bn.scale.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, c).astype(
                np.float32)))
    return x, dy, bn


def _todays(bn: BatchNorm, x, relu):
    """The train-mode forward as the port ran it before the ops:
    `native_batch_norm` (a unit weight where there is no scale), `F.relu`,
    the EMA of the biased variance; (y, mean, invstd)."""
    gamma = bn.scale if bn.scale is not None else torch.ones_like(bn.bias)
    y, mean, invstd = torch.native_batch_norm(x, gamma, bn.bias, None, None,
                                              True, 0.0, bn.eps)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(m).add_(mean * (1.0 - m))
        bn.running_var.mul_(m).add_(torch.clamp(
            invstd.square().reciprocal() - bn.eps, min=0.0) * (1.0 - m))
    return (F.relu(y) if relu else y), mean, invstd


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_route_is_todays_batch_norm_bit_for_bit(dtype, relu, scale,
                                                      channels_last):
    """y, the statistics, the running mean and biased variance, and the
    gradients of x, scale and bias equal today's `native_batch_norm` +
    `F.relu` + EMA exactly, in x's layout."""
    x, dy, bn = _case(dtype, channels_last, scale)
    ref = BatchNorm(x.shape[1], EPS, MOMENTUM, use_scale=scale).train()
    ref.load_state_dict(bn.state_dict())
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    y = bn(xa, relu=relu)
    want, mean, invstd = _todays(ref, xb, relu)
    assert torch.equal(y, want)
    assert y.stride() == want.stride()
    got_mean, got_invstd = bk.stats_plain(x, EPS)
    assert torch.equal(got_mean, mean) and torch.equal(got_invstd, invstd)
    assert torch.equal(bn.running_mean, ref.running_mean)
    assert torch.equal(bn.running_var, ref.running_var)
    y.backward(dy)
    want.backward(dy)
    assert torch.equal(xa.grad, xb.grad)
    assert torch.equal(bn.bias.grad, ref.bias.grad)
    if scale:
        assert torch.equal(bn.scale.grad, ref.scale.grad)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("op", ["stats", "apply", "backward"])
def test_fakes_match_the_real_outputs(op, dtype, channels_last):
    """Each op's fake gives its real outputs' shapes, dtypes and strides
    (the statistics fp32, y and dx in x's dtype and layout; dweight empty
    without a scale), and `torch.library.opcheck` passes (schema, fake,
    registered gradient)."""
    x, dy, bn = _case(dtype, channels_last, True)
    mean, invstd = bk.stats_plain(x, EPS)
    args = {"stats": (x, bn.running_mean.clone(), bn.running_var.clone(),
                      MOMENTUM, EPS, True),
            "apply": (x.clone().requires_grad_(),
                      bn.scale.detach().clone().requires_grad_(),
                      bn.bias.detach().clone().requires_grad_(), mean,
                      invstd, True),
            "backward": (dy, x, None, bn.bias.detach(), mean, invstd, True,
                         [True, False, True])}[op]
    fn = getattr(torch.ops.gvcnn, f"batch_norm_{op}").default
    real = fn(*args)
    fake = getattr(bk, f"_{op}_fake")(*args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(t.shape, t.dtype, t.stride()) for t in real] == [
        (t.shape, t.dtype, t.stride()) for t in fake]
    torch.library.opcheck(fn, args)


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_gradcheck_of_the_plain_backward_in_float64(relu, scale):
    """The registered gradient of the train-mode forward (through the batch
    statistics, and the ReLU's mask) against finite differences, in
    float64."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(3, 5, 4, 3)).requires_grad_()
    w = torch.from_numpy(rs.uniform(0.5, 1.5, 5)).requires_grad_()
    b = torch.from_numpy(rs.randn(5) * 0.3).requires_grad_()

    def forward(x, *params):
        weight, bias = params if scale else (None, params[0])
        rm, rv = torch.zeros(5, dtype=x.dtype), torch.ones(5, dtype=x.dtype)
        return bk.batch_norm_train(x, weight, bias, rm, rv, MOMENTUM, EPS,
                                   relu, True)

    assert torch.autograd.gradcheck(forward, (x, w, b) if scale else (x, b))


class _Pair(nn.Module):
    """Two ConvBNs (ReLU, then none) as one remat region or plainly."""

    def __init__(self, use_remat):
        super().__init__()
        self.use_remat = use_remat
        self.a = ConvBN(8, 16, (3, 3), momentum=MOMENTUM)
        self.b = ConvBN(16, 16, (1, 1), relu=False, momentum=MOMENTUM)

    def forward(self, x):
        fn = lambda t: self.b(self.a(t))  # noqa: E731
        return remat(fn, x) if self.use_remat else fn(x)


def test_remat_moves_the_running_statistics_once():
    """Under `remat` the backward's recompute runs the stats op again
    without the update: the running statistics and every gradient equal
    the plain region's bit for bit, though the ops ran twice."""
    torch.manual_seed(0)
    plain, rematted = _Pair(False).train(), _Pair(True).train()
    rematted.load_state_dict(plain.state_dict())
    x = torch.randn(2, 8, 9, 9)
    seen = []
    for model in (plain, rematted):
        with _Ops() as ops:
            model(x.clone().requires_grad_()).square().sum().backward()
        seen.append(ops.seen["gvcnn::batch_norm_stats"])
    assert seen == [2, 4]
    for name, t in plain.state_dict().items():
        assert torch.equal(t, rematted.state_dict()[name]), name
    for (name, p), q in zip(plain.named_parameters(),
                            rematted.parameters()):
        assert torch.equal(p.grad, q.grad), name


@pytest.mark.parametrize("mode", ["eval", "global"])
def test_eval_and_global_statistics_never_reach_the_ops(mode, monkeypatch):
    """Eval mode runs `F.batch_norm` and `bn_sync="global"` its summed
    statistics (`_global_forward`), each then `F.relu`: neither reaches
    the train-mode ops, and both give what they gave before."""
    from gvcnn_tf_tpu_torch.parallel import collectives

    x, _, bn = _case(torch.float32, True, True)
    if mode == "eval":
        bn.eval()
        want = F.relu(F.batch_norm(x, bn.running_mean, bn.running_var,
                                   bn.scale, bn.bias, False, 0.0, EPS))
    else:
        monkeypatch.setattr(collectives, "sum_across_ranks",
                            lambda t, group: t)
        bn.sync_group = object()
        want = F.relu(bn._global_forward(x))
    with _Ops() as ops:
        y = bn(x, relu=True)
    assert not set(ops.seen) & BN_OPS
    assert torch.equal(y, want)


# (rows, C, lanes, SMs) -> (tile_vectors, tiles): Inception-v1's Conv2d_1a
# and Inception-v4's Conv2d_2a at 384 images, ResNet-50's block4, a small
# layer, and C = 37 one channel a thread.
PLANS = [((384 * 112 * 112, 64, 8, 132), (8, 1)),
         ((384 * 147 * 147, 32, 8, 132), (4, 1)),
         ((384 * 7 * 7, 2048, 8, 132), (32, 8)),
         ((384 * 8 * 8, 1536, 8, 132), (32, 6)),
         ((384 * 35 * 35, 384, 4, 132), (32, 3)),
         ((6 * 9 * 11, 37, 1, 132), (19, 2)),
         ((1, 8, 8, 132), (1, 1))]


@pytest.mark.parametrize("args,tiles", PLANS)
def test_the_plan_adapts_to_rows_and_channels(args, tiles):
    """The plan covers rows x C once: equal tiles of at most 32 lane
    groups across C, blocks of at most 256 threads, chunks of rows that
    cover every row once, a few blocks an SM, and at least 16 rows a
    thread wherever there is more than one chunk; groups of GROUP chunks
    whose tickets the device holds."""
    rows, c, lanes, sms = args
    p = bk.plan(rows, c, lanes, sms)
    assert (p.tile_vectors, p.tiles) == tiles
    assert p.lanes == lanes
    assert p.tile_vectors * p.tiles >= c // lanes > p.tile_vectors * (
        p.tiles - 1)
    by = bk.MAX_THREADS // p.tile_vectors
    assert p.tile_vectors * by <= bk.MAX_THREADS and by >= lanes
    assert p.chunks * p.chunk_rows >= rows > (p.chunks - 1) * p.chunk_rows
    assert p.chunks * p.tiles <= bk.BLOCKS_AN_SM * sms + p.tiles
    assert p.groups * bk.GROUP >= p.chunks > (p.groups - 1) * bk.GROUP
    assert p.tiles * (p.groups + 1) <= bk.TICKETS
    if p.chunks > 1:
        assert p.chunk_rows >= by * bk.MIN_ROWS_A_THREAD


@pytest.mark.parametrize("case,pitch", [
    ("channels_last", 24), ("slice", 40), ("nchw", None),
    ("one_pixel", 24), ("one_channel_nchw", 1)])
def test_row_pitch_of_what_the_backward_is_handed(case, pitch):
    """dy is read where it lies when its rows of C channels sit at one
    pitch: a channels-last tensor (C), a channel slice of a wider one (the
    wider C), a tensor whose H = W = 1 or C = 1 in either layout; an NCHW
    tensor with H * W > 1 and C > 1 has none and is copied."""
    cl = torch.channels_last
    t = {"channels_last": torch.empty(2, 24, 3, 5, memory_format=cl),
         "slice": torch.empty(2, 40, 3, 5, memory_format=cl)[:, 8:32],
         "nchw": torch.empty(2, 24, 3, 5),
         "one_pixel": torch.empty(2, 24, 1, 1),
         "one_channel_nchw": torch.empty(2, 1, 3, 5)}[case]
    assert bk._pitch(t) == pitch


def test_an_inception_v1_train_step_runs_no_native_batch_norm():
    """A B = 2 GVCNN (Inception-v1) train step reaches each train-mode op
    once for every BatchNorm, its ReLU inside them: no `native_batch_norm`,
    no separate ReLU and no `threshold_backward` is left."""
    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    base = get_config("mn40_12view")
    cfg = base.replace(data=dataclasses.replace(
        base.data, height=64, width=64, num_views=2, batch_size=2,
        transfer_dtype="uint8"))
    state = create_train_state(cfg, torch.device("cpu"))
    n_bn = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    rs = np.random.RandomState(0)
    batch = {"views": torch.from_numpy(rs.randint(
        0, 256, (2, 2, 64, 64, 3)).astype(np.uint8)),
             "label": torch.tensor([1, 2])}
    with _Ops() as ops:
        train_step(state, batch, cfg)
    assert n_bn == 58
    assert {k: ops.seen[k] for k in BN_OPS} == {k: n_bn for k in BN_OPS}
    assert not set(ops.seen) & {
        "aten::native_batch_norm", "aten::native_batch_norm_backward",
        "aten::relu", "aten::relu_", "aten::threshold_backward"}
    assert not layers.recomputing()


# ---------------------------------------------------------------------------
# The residual op: relu(BN(x) + r)
# ---------------------------------------------------------------------------


def _residual(x, seed=1):
    """A residual like x (dtype, layout), of a spread that puts about half
    of BN(x) + r below 0."""
    rs = np.random.RandomState(seed)
    r = torch.from_numpy(rs.randn(*x.shape).astype(np.float32)).to(x.dtype)
    return r.contiguous(memory_format=torch.channels_last
                        if x.is_contiguous(memory_format=torch.channels_last)
                        and not x.is_contiguous() else torch.contiguous_format)


def _grads(bn, *tensors):
    return [t.grad for t in tensors] + [bn.bias.grad] + (
        [bn.scale.grad] if bn.scale is not None else [])


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_residual_route_is_the_unfused_composition(dtype, scale,
                                                   channels_last):
    """`BatchNorm(x, relu=True, residual=r)` in train mode against the
    route it replaced, BatchNorm without the ReLU, + r, `torch.relu`,
    under autograd: out, the running statistics and the gradients of x,
    r, scale and bias bit for bit in fp32.  In bf16 out is the fp32 sum
    rounded once (within one bf16 ulp of the fp32 result), r's gradient
    is `threshold_backward` at that out, and the rest is the unfused
    backward of that gradient."""
    x, dy, bn = _case(dtype, channels_last, scale)
    r = _residual(x)
    ref = BatchNorm(x.shape[1], EPS, MOMENTUM, use_scale=scale).train()
    ref.load_state_dict(bn.state_dict())
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ra, rb = r.clone().requires_grad_(), r.clone().requires_grad_()
    with _Ops() as ops:
        out = bn(xa, relu=True, residual=ra)
        out.backward(dy)
    assert {k: ops.seen[k] for k in RESIDUAL_OPS} == dict.fromkeys(
        RESIDUAL_OPS, 1)
    assert not ops.seen["gvcnn::batch_norm_apply"]
    assert out.dtype == dtype and out.stride() == x.stride()
    assert ra.grad.stride() == x.stride()
    want = torch.relu(ref(xb) + rb)
    assert torch.equal(bn.running_mean, ref.running_mean)
    assert torch.equal(bn.running_var, ref.running_var)
    if dtype == torch.float32:
        assert torch.equal(out, want)
        want.backward(dy)
        for got, exp in zip(_grads(bn, xa, ra), _grads(ref, xb, rb)):
            assert torch.equal(got, exp)
        return
    mean, invstd = bk.stats_plain(x, EPS)
    weight = None if bn.scale is None else bn.scale.detach()
    exact = torch.relu(bk.apply_plain(x.float(), weight, bn.bias.detach(),
                                      mean, invstd, False) + r.float())
    assert torch.equal(out, exact.to(dtype))
    ulp = torch.exp2(torch.floor(torch.log2(
        exact.abs().clamp_min(2.0 ** -126))) - 7)
    assert ((out.float() - exact).abs() <= ulp).all()
    g = torch.ops.aten.threshold_backward(dy, out.detach(), 0)
    assert torch.equal(ra.grad, g)
    dx, dw, db = bk.backward_plain(g, x, weight, bn.bias.detach(), mean,
                                   invstd, False, [True, scale, True])
    assert torch.equal(xa.grad, dx) and torch.equal(bn.bias.grad, db)
    if scale:
        assert torch.equal(bn.scale.grad, dw)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("op", ["apply_residual", "backward_residual"])
def test_residual_fakes_match_the_real_outputs(op, dtype, channels_last):
    """The residual ops' fakes give their real outputs' shapes, dtypes and
    strides (out, dx and dresidual in x's dtype and layout), and
    `torch.library.opcheck` passes (schema, fake, registered gradient)."""
    x, dy, bn = _case(dtype, channels_last, True)
    r = _residual(x)
    mean, invstd = bk.stats_plain(x, EPS)
    out = bk.apply_residual_plain(x, bn.scale.detach(), bn.bias.detach(),
                                  mean, invstd, r)
    args = {"apply_residual": (
                x.clone().requires_grad_(),
                bn.scale.detach().clone().requires_grad_(),
                bn.bias.detach().clone().requires_grad_(), mean, invstd,
                r.clone().requires_grad_()),
            "backward_residual": (dy, out, x, None, bn.bias.detach(), mean,
                                  invstd, [True, False, True])}[op]
    fn = getattr(torch.ops.gvcnn, f"batch_norm_{op}").default
    real = fn(*args)
    fake = getattr(bk, f"_{op}_fake")(*args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(t.shape, t.dtype, t.stride()) for t in real] == [
        (t.shape, t.dtype, t.stride()) for t in fake]
    torch.library.opcheck(fn, args)


@pytest.mark.parametrize("scale", [False, True])
def test_gradcheck_of_the_residual_backward_in_float64(scale):
    """The residual op's registered gradient (through the batch statistics,
    the ReLU's mask from the saved out, and the residual) against finite
    differences, in float64."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(3, 5, 4, 3)).requires_grad_()
    r = torch.from_numpy(rs.randn(3, 5, 4, 3)).requires_grad_()
    w = torch.from_numpy(rs.uniform(0.5, 1.5, 5)).requires_grad_()
    b = torch.from_numpy(rs.randn(5) * 0.3).requires_grad_()

    def forward(x, r, *params):
        weight, bias = params if scale else (None, params[0])
        rm, rv = torch.zeros(5, dtype=x.dtype), torch.ones(5, dtype=x.dtype)
        return bk.batch_norm_train(x, weight, bias, rm, rv, MOMENTUM, EPS,
                                   True, True, residual=r)

    assert torch.autograd.gradcheck(
        forward, (x, r, w, b) if scale else (x, r, b))


@pytest.mark.parametrize("mode", ["eval", "global"])
def test_eval_and_global_statistics_never_reach_the_residual_op(
        mode, monkeypatch):
    """With a residual, eval mode runs `F.batch_norm` and `bn_sync="global"`
    its summed statistics, each then the add and `F.relu`, as the
    bottleneck ran them before the residual op: no train-mode op is
    reached."""
    from gvcnn_tf_tpu_torch.parallel import collectives

    x, _, bn = _case(torch.float32, True, True)
    r = _residual(x)
    if mode == "eval":
        bn.eval()
        y = F.batch_norm(x, bn.running_mean, bn.running_var, bn.scale,
                         bn.bias, False, 0.0, EPS)
    else:
        monkeypatch.setattr(collectives, "sum_across_ranks",
                            lambda t, group: t)
        bn.sync_group = object()
        y = bn._global_forward(x)
    want = F.relu(r + y)
    with _Ops() as ops:
        out = bn(x, relu=True, residual=r)
    assert not set(ops.seen) & (BN_OPS | RESIDUAL_OPS)
    assert torch.equal(out, want)


def test_a_residual_needs_the_relu():
    """A residual is added before the ReLU: `BatchNorm` and
    `batch_norm_train` refuse one without `relu`, in train and eval mode."""
    x, _, bn = _case(torch.float32, False, True)
    r = _residual(x)
    with pytest.raises(ValueError):
        bn(x, residual=r)
    with pytest.raises(ValueError):
        bn.eval()(x, residual=r)
    with pytest.raises(ValueError):
        bk.batch_norm_train(x, None, bn.bias, bn.running_mean,
                            bn.running_var, MOMENTUM, EPS, False, True, r)


def test_a_resnet50_train_step_reaches_the_residual_op_once_a_block():
    """A B = 2 GVCNN (ResNet-50) train step reaches the residual op and its
    backward once for each of the 16 bottlenecks, the plain apply and
    backward for the other 41 BatchNorms, the stats op for all 57, and no
    `native_batch_norm`, separate ReLU or `threshold_backward`."""
    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    base = get_config("mn40_12view_resnet50")
    cfg = base.replace(data=dataclasses.replace(
        base.data, height=64, width=64, num_views=2, batch_size=2,
        transfer_dtype="uint8"))
    state = create_train_state(cfg, torch.device("cpu"))
    rs = np.random.RandomState(0)
    batch = {"views": torch.from_numpy(rs.randint(
        0, 256, (2, 2, 64, 64, 3)).astype(np.uint8)),
             "label": torch.tensor([1, 2])}
    with _Ops() as ops:
        train_step(state, batch, cfg)
    assert {k: ops.seen[k] for k in sorted(BN_OPS | RESIDUAL_OPS)} == {
        "gvcnn::batch_norm_apply": 41, "gvcnn::batch_norm_apply_residual": 16,
        "gvcnn::batch_norm_backward": 41,
        "gvcnn::batch_norm_backward_residual": 16,
        "gvcnn::batch_norm_stats": 57}
    assert not set(ops.seen) & {
        "aten::native_batch_norm", "aten::native_batch_norm_backward",
        "aten::relu", "aten::relu_", "aten::threshold_backward"}
