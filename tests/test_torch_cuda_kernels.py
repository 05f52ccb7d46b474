"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc: it is marked `cuda` and skips
where `torch.cuda.is_available()` is false.  The file imports no JAX, so it
runs on a machine that has only PyTorch (tests/conftest.py imports JAX, so
skip it there):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py

Tolerances: the stem (bf16 out, both sides accumulate in fp32) rtol = atol
= 1e-2, one bf16 rounding apart; with the epilogue, the bound stated in
`test_stem_epilogue_matches_plain`; the grouping head (fp32) scheme exact,
weights rtol 1e-6, fused rtol 1e-5 / atol 1e-6.  TF32 is turned off for the
fp32 comparisons, so the plain version's einsums run in full fp32.

Gradients: the stem op's gradient against autograd through the plain
version (both end in cuDNN's conv gradient, fp32 accumulation, in whatever
order cuDNN picks) within 1% of max|dw| and max|dx| in bf16, 1e-4 in fp32;
the grouping op's gradient against autograd through its plain version,
rtol 1e-5 / atol 1e-6.  One mn40_12view train step at 64x64, 4 views,
B = 2, bf16 on the card against the same step in fp32 on the CPU: loss within
5%, grad norm within 10% (bf16 through ~60 layers with batch statistics).

Evaluation: `--eval_every` on a 10-shape procedural split at 64x64, 4
views, B = 4 (`test_eval_on_the_card`, its bounds in its docstring).

Data parallelism: a world of one rank over NCCL takes three steps equal to
the plain step's bit for bit (`test_world_of_one_over_nccl_is_the_plain_step`).

Export: `torch.library.opcheck` of both ops on CUDA tensors, and an
mn40_12view artifact exported on the card (64x64, 4 views, B = 2, bf16):
one launch of each kernel a forward, logits within 1e-2 of max|logit| of
the eager model's (expected equal: the same kernels and convs).

File loaders: the decoded loader's on-card flip equals the host's flip of
the same mask exactly, and a train step of the decoded loader on the card
runs it; `train()` from a rendered PNG tree through the native decode pool
(64x64, 4 views, B = 2; where libjpeg or libpng is missing, the refusal
that names it) and through the TFRecord reader launches each kernel once a
step.

The card-resident split: a step on a resident batch equals the streaming
step bit for bit (cuDNN deterministic), and `train(profile_steps=...)`
writes a trace with one launch of each kernel a profiled step.

CUDA graphs (`utils/graphs.py`): the optimizer's device scalars give the
Python floats' bits on the card; the compiled step equals the eager step
bit for bit over 3 steps (64x64, 4 views, B = 2, dropout, the on-card flip,
accumulate_steps = 2, cuDNN deterministic) with the eager launches;
`train()` replays its step; an engine bucket's replay is its eager forward
bit for bit, and a weight reload changes it; eval through its graph
counts and scores as eager.

Max pools (`csrc/max_pool.cu`), at every pool shape of Inception-v1 and
ResNet-50 at N = 8 in bf16 and fp32: the forward equal to `F.pad` +
`F.max_pool2d` and its record to the plain record, exactly; dx equal to
autograd's through `F.max_pool2d` where an input wins one window, within
one bf16 ulp (fp32: rtol 1e-6) where it wins several (fp32 sums in another
order); ties, -inf windows, NaN, forward and backward; a C or an address
that does not fill 16-byte channel vectors raising; a captured and replayed
train step runs 13 forward and 13 backward pool kernels and none of
PyTorch's, and three fewer fills than the same step on `F.max_pool2d`.

Average pools (`csrc/avg_pool.cu`), at Inception-v4's three shapes at 384
images in bf16 and fp32: the forward within one bf16 ulp (plus 1e-6 where a
window cancels; fp32: 1e-6) of `F.avg_pool2d` counting the pads; dx within
the same of the plain box sum and of autograd's through `F.avg_pool2d` on
fp32 NCHW copies, rounded once (PyTorch's channels-last `avg_pool2d`
backward on the card gave dx displaced by the pad, one row and one column,
in torch 2.11.0+cu128; its NCHW backward gives the CPU's gradient); a
captured and replayed Inception-v4 step runs 14
forward and 14 backward average-pool kernels and none of PyTorch's; what
the kernels do not take raises before a launch.

Train-mode BatchNorm (`csrc/batch_norm.cu`), at the cells' real shapes
(Inception-v1's Conv2d_1a, Inception-v4's Conv2d_2a, ResNet-50's block4 at
384 images) and a C that is not a multiple of 8, bf16 and fp32, ReLU on and
off, with and without a scale, against the plain versions on fp32 copies:
the statistics and the running update within 1e-4, y within one ulp of the
plain apply given the kernels' statistics, the gradients within one bf16
ulp plus 1e-4 of their largest (bounds in the test's docstring); dy read
in place from a channel slice; no running update in a remat recompute; the
same bits under CUDA-graph replay; a replayed Inception-v1 step launching
each of the four kernels once a BatchNorm and none of PyTorch's.

The residual join (`csrc/residual_join.cu`), at Inception-ResNet-v2's
block35, block17 and block8 shapes at 384 images and a C that is not a
multiple of 8, bf16 and fp32, with the ReLU and without it (the last
block8): y, dx and du equal to the plain versions bit for bit, dbias
within 1e-4 of the channel's sum of |du| and the same from launch to
launch; what the op does not take raising before a launch; the same bits
under CUDA-graph replay; a replayed Inception-ResNet-v2 forward launching
its 40 joins, and a replayed train step 40 forward, 40 backward and 40
bias-gradient kernels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from gvcnn_tf_tpu_torch.ops import launched  # noqa: E402
from gvcnn_tf_tpu_torch.ops.grouping_kernel import (  # noqa: E402
    group_and_fuse,
    group_and_fuse_plain,
)
from gvcnn_tf_tpu_torch.ops.stem_kernel import (  # noqa: E402
    stem_conv,
    stem_conv_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


# (12, 224, 224): the B=1 serving shape; (5, 224, 224): 140 tiles, not a
# multiple of a persistent grid of 132 blocks; W = 224 and 32 take the
# 16-byte cp.async row path, W = 30, 130 (W % 8 != 0) and 33 (odd) the
# 2-byte one; H = 30 has H % 4 == 2.
STEM_SHAPES = [(12, 224, 224, 3), (2, 30, 30, 3), (1, 31, 33, 3),
               (3, 8, 130, 3), (5, 224, 224, 3), (2, 32, 32, 3)]


@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_kernel_matches_plain(cuda, shape):
    rs = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(np.float32))
    xd, wd = x.to(cuda, torch.bfloat16), w.to(cuda, torch.bfloat16)
    before = launched("stem_conv7x7s2")
    with torch.inference_mode():
        got = stem_conv(xd, wd)
        torch.cuda.synchronize()
        want = stem_conv_plain(xd, wd)
    assert launched("stem_conv7x7s2") == before + 1
    assert got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


def _bf16_ulp(t):
    """Spacing of bf16 numbers at |t| (t float32)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("shape", STEM_SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_stem_epilogue_matches_plain(cuda, shape, relu):
    """Kernel: relu(acc * scale + shift) from the fp32 accumulator, rounded
    to bf16 once.  Plain: the conv rounded to bf16, then the affine in fp32,
    then the ReLU, rounded again.  So they may differ by |scale| x one bf16
    ulp of the conv output, plus one bf16 ulp of the result, plus
    |scale| x 1e-5 for the two fp32 sums taken in another order."""
    rs = np.random.RandomState(sum(shape) + relu)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(np.float32))
    scale = torch.from_numpy(rs.uniform(0.5, 2.0, 64).astype(np.float32))
    shift = torch.from_numpy(rs.uniform(-1.0, 1.0, 64).astype(np.float32))
    xd, wd = x.to(cuda, torch.bfloat16), w.to(cuda, torch.bfloat16)
    sd, hd = scale.to(cuda), shift.to(cuda)
    before = launched("stem_conv7x7s2")
    with torch.inference_mode():
        got = stem_conv(xd, wd, sd, hd, relu=relu)
        torch.cuda.synchronize()
        want = stem_conv_plain(xd, wd, sd, hd, relu=relu).float()
        conv = stem_conv_plain(xd, wd).float()
    assert launched("stem_conv7x7s2") == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    bound = sd.abs() * (_bf16_ulp(conv) + 1e-5) + _bf16_ulp(want)
    err = (got.float() - want).abs()
    assert bool((err <= bound).all()), float((err - bound).max())
    if relu:
        assert bool((got >= 0).all()) and bool((got == 0).any())
    else:
        assert bool((got < 0).any())


def test_stem_module_runs_the_epilogue_in_the_kernel(cuda):
    """Stem.forward in eval mode: one stem launch with the BatchNorm and
    ReLU as its epilogue, and no batch_norm or relu kernel after it."""
    from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import Stem

    rs = np.random.RandomState(3)
    stem = Stem().eval()
    with torch.no_grad():
        stem.conv.weight.copy_(torch.from_numpy(
            (rs.randn(64, 3, 7, 7) * 0.1).astype(np.float32)))
        stem.BatchNorm.bias.copy_(torch.from_numpy(
            rs.randn(64).astype(np.float32)))
        stem.BatchNorm.running_mean.copy_(torch.from_numpy(
            rs.randn(64).astype(np.float32)))
        stem.BatchNorm.running_var.copy_(torch.from_numpy(
            rs.uniform(0.25, 4.0, 64).astype(np.float32)))
    stem.conv.to(torch.bfloat16)
    stem.to(cuda)
    x = torch.from_numpy(rs.randn(2, 64, 64, 3).astype(np.float32))
    xd = x.to(cuda, torch.bfloat16)
    launches = launched("stem_conv7x7s2")
    with torch.inference_mode():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got = stem(xd)
        torch.cuda.synchronize()
        y = stem_conv_plain(xd, stem.conv.weight).permute(0, 3, 1, 2)
        want = F.relu(stem.BatchNorm(y))
    assert launched("stem_conv7x7s2") == launches + 1
    ops = {e.key for e in prof.key_averages()}
    assert not ops & {"aten::batch_norm", "aten::relu", "aten::relu_"}, ops
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=5e-2)


# The fp32 kernel (mn10_single_view's stem, B = 8), odd sizes, an unaligned
# width with a ragged band (1, 18, 226, 3: W % 4 != 0, 9 output rows), a
# batch of many tiles a block (96 images), and rows wider than one strip
# (150 and 151 outputs: two strips, aligned and not).
STEM_F32_SHAPES = [(8, 224, 224, 3), (2, 30, 30, 3), (1, 31, 33, 3),
                   (3, 8, 130, 3), (1, 18, 226, 3), (96, 224, 224, 3),
                   (2, 20, 300, 3), (1, 9, 301, 3)]


@pytest.mark.parametrize("shape", STEM_F32_SHAPES)
@pytest.mark.parametrize("epilogue", [None, "affine", "relu"])
def test_stem_f32_kernel_matches_plain(cuda, shape, epilogue):
    """fp32 in and out; the kernel in 3xTF32, the plain version's cuDNN
    conv in fp32 (TF32 off): max|err| <= 1e-5 x max|ref|, which one TF32
    product misses (tests/test_torch_stem.py)."""
    rs = np.random.RandomState(sum(shape) + len(epilogue or ""))
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(
        np.float32)).to(cuda)
    affine = ()
    if epilogue:
        affine = tuple(torch.from_numpy(a.astype(np.float32)).to(cuda)
                       for a in (rs.uniform(0.5, 2.0, 64),
                                 rs.uniform(-1.0, 1.0, 64)))
    relu = epilogue == "relu"
    before = (launched("stem_conv7x7s2"), launched("stem_conv7x7s2_f32"))
    with torch.inference_mode():
        got = stem_conv(x, w, *affine, relu=relu)
        torch.cuda.synchronize()
        want = stem_conv_plain(x, w, *affine, relu=relu)
    assert (launched("stem_conv7x7s2"), launched("stem_conv7x7s2_f32")) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


def test_stem_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 16, 16, 3), device=cuda)
    w = torch.zeros((64, 3, 7, 7), device=cuda)
    with pytest.raises(TypeError):
        stem_conv(x.half(), w.half())                         # fp16
    with pytest.raises(TypeError):
        stem_conv(x, w.bfloat16())                            # mixed
    with pytest.raises(ValueError):
        stem_conv(x.bfloat16().permute(0, 2, 1, 3), w.bfloat16())
    wg = w.bfloat16().requires_grad_()
    one = torch.ones(64, device=cuda)
    with pytest.raises(NotImplementedError):                  # epilogue
        stem_conv(x.bfloat16(), wg, one, one, relu=True)
    y = stem_conv(x.bfloat16(), wg)                 # the op's gradient
    y.float().sum().backward()
    assert wg.grad is not None and wg.grad.shape == w.shape


def _scores_clear_of_edges(rs, b, v, m):
    while True:
        s = rs.dirichlet(np.ones(v) * 0.7, size=b).astype(np.float32)
        edges = np.arange(1, m) / m
        if m == 1 or np.abs(s[..., None] - edges).min() > 1e-5:
            return s


def _edge_scores(b, v, m):
    grid = np.arange(0, m + 1, dtype=np.float32) / np.float32(m)
    return grid[np.arange(b * v).reshape(b, v) * 3 % (m + 1)]


@pytest.mark.parametrize("mode", ["mean", "ceil_sum"])
# B = 1 at C = 1024 (8 channel tiles), a ragged last tile (C = 300), C <
# 128 (64, 100: one tile), M in {1, 8, 16}.
# C = 1536 (Inception-v4's Mixed_7d) and 2048 (ResNet-50's block4,
# Inception-v3's Mixed_7c).
@pytest.mark.parametrize("b,v,c,m", [(8, 12, 1024, 8), (3, 1, 64, 1),
                                     (2, 8, 1024, 16), (1, 12, 300, 8),
                                     (1, 12, 1024, 8), (1, 12, 100, 16),
                                     (4, 16, 300, 1), (1, 12, 300, 16),
                                     (8, 12, 1536, 8), (8, 12, 2048, 8)])
@pytest.mark.parametrize("edges", [False, True])
def test_grouping_kernel_matches_plain(cuda, mode, b, v, c, m, edges):
    rs = np.random.RandomState(b * v + m)
    scores = (_edge_scores(b, v, m) if edges
              else _scores_clear_of_edges(rs, b, v, m))
    s = torch.from_numpy(scores).to(cuda)
    d = torch.from_numpy(rs.randn(b, v, c).astype(np.float32)).to(cuda)
    before = launched("group_and_fuse")
    with torch.inference_mode():
        got = group_and_fuse(s, d, m, mode)
        torch.cuda.synchronize()
        want = group_and_fuse_plain(s, d, m, mode)
    assert launched("group_and_fuse") == before + 1
    (fused, weights, scheme), (wf, ww, ws) = ([t.cpu().numpy() for t in r]
                                              for r in (got, want))
    np.testing.assert_array_equal(scheme, ws)
    np.testing.assert_allclose(weights, ww, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(fused, wf, rtol=1e-5, atol=1e-6)


def test_grouping_kernel_refuses_what_it_does_not_take(cuda):
    s = torch.full((1, 17), 1 / 17, device=cuda)
    with pytest.raises(ValueError):
        group_and_fuse(s, torch.zeros((1, 17, 8), device=cuda), 8)   # V > 16
    s = torch.full((1, 4), 0.25, device=cuda)
    with pytest.raises(TypeError):
        group_and_fuse(s, torch.zeros((1, 4, 8), device=cuda,
                                      dtype=torch.float64), 8)
    sg = s.clone().requires_grad_()
    fused, _, _ = group_and_fuse(sg, torch.ones((1, 4, 8), device=cuda), 8)
    fused.sum().backward()                          # the op's gradient
    assert sg.grad is not None and torch.isfinite(sg.grad).all()


@pytest.mark.parametrize("dtype,shape",
                         [("bfloat16", s) for s in STEM_SHAPES]
                         + [("float32", s) for s in STEM_F32_SHAPES])
@pytest.mark.parametrize("need_dx", [False, True])
def test_stem_function_gradients_match_plain(cuda, dtype, shape, need_dx):
    """bf16: within 1% of max|dw| and max|dx|.  fp32 (the fp32 kernel's
    op, TF32 off on both sides by the `cuda` fixture): within 1e-4
    of max, cuDNN's fp32 gradients summed in another order."""
    dt = getattr(torch, dtype)
    rs = np.random.RandomState(sum(shape) + need_dx)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(np.float32))
    n, h, wd, _ = shape
    g = torch.from_numpy(rs.randn(n, -(-h // 2), -(-wd // 2), 64).astype(
        np.float32)).to(cuda, dt)
    grads = []
    for fn in (stem_conv, stem_conv_plain):
        xd = x.to(cuda, dt).requires_grad_(need_dx)
        wd32 = w.to(cuda).requires_grad_()
        before = (launched("stem_conv7x7s2"), launched("stem_conv7x7s2_f32"))
        fn(xd, wd32.to(dt)).backward(g)
        ran = int(fn is stem_conv)
        assert (launched("stem_conv7x7s2"),
                launched("stem_conv7x7s2_f32")) == (
            before[0] + ran, before[1] + ran * (dt == torch.float32))
        grads.append((wd32.grad, xd.grad))
    (dw, dx), (dw_ref, dx_ref) = grads
    rel = 1e-2 if dt == torch.bfloat16 else 1e-4
    assert dw.dtype == torch.float32
    torch.testing.assert_close(dw, dw_ref, rtol=0,
                               atol=rel * dw_ref.abs().max().item())
    assert (dx is None) == (not need_dx)
    if need_dx:
        assert dx.dtype == dt
        torch.testing.assert_close(dx.float(), dx_ref.float(), rtol=0,
                                   atol=rel * dx_ref.abs().max().item())


@pytest.mark.parametrize("mode", ["mean", "ceil_sum"])
@pytest.mark.parametrize("b,v,c,m", [(8, 12, 1024, 8), (1, 12, 1024, 8),
                                     (2, 8, 1024, 16), (4, 16, 300, 1)])
@pytest.mark.parametrize("edges", [False, True])
def test_grouping_function_gradients_match_plain(cuda, mode, b, v, c, m,
                                                 edges):
    rs = np.random.RandomState(b * v + m + edges)
    scores = (_edge_scores(b, v, m) if edges
              else _scores_clear_of_edges(rs, b, v, m))
    d = rs.randn(b, v, c).astype(np.float32)
    gf = torch.from_numpy(rs.randn(b, c).astype(np.float32)).to(cuda)
    gw = torch.from_numpy(rs.randn(b, m).astype(np.float32)).to(cuda)
    grads = []
    for fn in (group_and_fuse, group_and_fuse_plain):
        sd = torch.from_numpy(scores).to(cuda).requires_grad_()
        dd = torch.from_numpy(d).to(cuda).requires_grad_()
        before = launched("group_and_fuse")
        fused, weights, _ = fn(sd, dd, m, mode)
        ((fused * gf).sum() + (weights * gw).sum()).backward()
        assert launched("group_and_fuse") == before + (fn is group_and_fuse)
        grads.append((sd.grad, dd.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_one_train_step_on_the_card(cuda):
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    base = get_config("mn40_12view")
    cfg = base.replace(data=dataclasses.replace(
        base.data, height=64, width=64, num_views=4, batch_size=2),
        dropout_keep_prob=1.0)
    rs = np.random.RandomState(0)
    batch = {"views": torch.from_numpy(rs.uniform(-1, 1, (2, 4, 64, 64, 3))
                                       .astype(np.float32)),
             "label": torch.from_numpy(np.array([3, 17]))}
    ref = create_train_state(cfg.replace(compute_dtype="float32"), "cpu")
    want = train_step(ref, batch, cfg.replace(compute_dtype="float32"))
    state = create_train_state(cfg, cuda)
    before = [p.detach().clone() for p in state.kernels]
    launches = (launched("stem_conv7x7s2"), launched("group_and_fuse"))
    got = train_step(state, {k: t.to(cuda) for k, t in batch.items()}, cfg)
    assert (launched("stem_conv7x7s2") - launches[0],
            launched("group_and_fuse") - launches[1]) == (1, 1)
    assert state.step == 1
    assert all(torch.isfinite(t) for t in got.values())
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=0.05)
    assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]),
                                                    rel=0.1)
    # Every kernel moves (the score-logit bias has a zero gradient under the
    # softmax over views, so only the kernels are checked).
    assert all(not torch.equal(a, b) for a, b in zip(before, state.kernels))


@pytest.mark.parametrize("name,launches", [
    ("mn10_single_view", (1, 1, 0)),          # (stem, stem fp32, grouping)
    ("mn40_12view_mvcnn", (1, 0, 0)),
    ("mn40_12view_resnet50", (0, 0, 1)),
    ("mn40_12view_inception_v4", (0, 0, 1)),
])
def test_families_on_the_card(cuda, name, launches):
    """One eval forward of each family at 80x80, 2 views (1 for the single
    view), B = 2, on the card against the CPU in fp32: the kernels of the
    path launch once each (the fp32 stem for the fp32 config), and the
    logits agree within the serving bound (3% of max|logit|; TF32 off on
    the card, by the `cuda` fixture)."""
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.models.gvcnn import (
        build_model,
        init_weights,
        to_device,
    )

    base = get_config(name)
    cfg = base.replace(data=dataclasses.replace(
        base.data, height=80, width=80, batch_size=2,
        num_views=min(base.data.num_views, 2)))
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (2, cfg.data.num_views, 80, 80, 3)).astype(np.float32))
    ref = init_weights(build_model(cfg.replace(compute_dtype="float32")),
                       cfg.train.seed).eval()
    model = to_device(init_weights(build_model(cfg), cfg.train.seed),
                      cuda).eval()
    before = (launched("stem_conv7x7s2"), launched("stem_conv7x7s2_f32"),
              launched("group_and_fuse"))
    with torch.no_grad():
        got = model(x.to(cuda))[0].float().cpu()
        want = ref(x)[0]
    assert (launched("stem_conv7x7s2") - before[0],
            launched("stem_conv7x7s2_f32") - before[1],
            launched("group_and_fuse") - before[2]) == launches
    assert (got - want).abs().max() <= 3e-2 * want.abs().max()


def _eval_logits():
    """Context: the fp32 logits of every batch `evaluate` scores, appended
    to the list it yields (`eval.recorded_logits`: on the card the logits
    of the replayed graph, which no module hook sees)."""
    from gvcnn_tf_tpu_torch.eval import recorded_logits

    return recorded_logits()


def test_eval_on_the_card(cuda, tmp_path):
    """`--eval_every` on the card: 2 train steps and an eval of the 10-shape
    procedural split (3 padded batches of 4) launch each kernel 2 + 3 times;
    the optimizer's foreach update and `load_state_dict` bump the version
    counters the kernels' caches are keyed on; a fresh model from the
    checkpoint scores exactly as the training model did; the card (bf16)
    and the CPU (fp32) predict alike wherever the CPU's top-2 margin is
    above 3% of max|logit| (the serving bound, chip_smoke.LOGIT_REL_TOL)."""
    import dataclasses
    import json

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.eval import evaluate
    from gvcnn_tf_tpu_torch.train import train

    base = get_config("mn40_12view")
    cfg = base.replace(
        data=dataclasses.replace(
            base.data, height=64, width=64, num_views=4, batch_size=4,
            num_classes=10, dataset="procedural", transfer_dtype="uint8",
            synthetic_num_shapes=10),
        train=dataclasses.replace(base.train, train_logdir=str(tmp_path),
                                  checkpoint_every=2, eval_every=2,
                                  log_every=1))
    launches = (launched("stem_conv7x7s2"), launched("group_and_fuse"))
    state, _ = train(cfg, num_steps=2, device=cuda)
    assert (launched("stem_conv7x7s2") - launches[0],
            launched("group_and_fuse") - launches[1]) == (5, 5)
    assert state.model.training
    rec = [json.loads(line) for line in
           (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["val_count"] for r in rec if "val_count" in r] == [10]

    with _eval_logits() as in_training:
        mine = evaluate(cfg, state=state, per_class=True)
    with _eval_logits() as fresh:
        got = evaluate(cfg, per_class=True, device=cuda)
    assert got == mine
    for a, b in zip(in_training, fresh):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with _eval_logits() as ref:
        evaluate(cfg.replace(compute_dtype="float32"), device="cpu")
    card, cpu = torch.cat(fresh)[:10], torch.cat(ref)[:10]
    bound = 3e-2 * cpu.abs().max()
    assert (card - cpu).abs().max() <= bound
    top2 = cpu.topk(2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > bound
    assert torch.equal(card.argmax(-1)[clear], cpu.argmax(-1)[clear])

    w = state.model.InceptionV1.Conv2d_1a_7x7.conv.weight
    bn = state.model.InceptionV1.Conv2d_1a_7x7.BatchNorm.running_var
    v = w._version
    state.optimizer.step([torch.zeros_like(p) for p in state.optimizer.params])
    assert w._version > v
    v = (w._version, bn._version)
    state.model.load_state_dict(state.model.state_dict())
    assert w._version > v[0] and bn._version > v[1]


def test_world_of_one_over_nccl_is_the_plain_step(cuda, tmp_path):
    """Three mn40_12view steps at 64x64, 4 views, B = 2, bf16, dropout on,
    through the data-parallel path (a world of one rank over NCCL: the
    gradient, loss and accuracy all-reduce each step) equal the plain
    step's bit for bit, cuDNN deterministic on both sides; one launch of
    each kernel a step on each side."""
    import dataclasses
    import datetime

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.parallel import initialize_distributed, shutdown
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    base = get_config("mn40_12view")
    cfg = base.replace(data=dataclasses.replace(
        base.data, height=64, width=64, num_views=4, batch_size=2))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    world = initialize_distributed(
        timeout=datetime.timedelta(seconds=120), device="cuda:0",
        init_method=f"file://{tmp_path}/rendezvous", rank=0, world_size=1)
    try:
        assert (world.backend, world.size, world.distributed) == (
            "nccl", 1, True)
        plain = create_train_state(cfg, cuda)
        dp = create_train_state(cfg, world=world)
        rs = np.random.RandomState(4)
        for _ in range(3):
            batch = {"views": torch.from_numpy(rs.uniform(
                -1, 1, (2, 4, 64, 64, 3)).astype(np.float32)).to(cuda),
                "label": torch.from_numpy(rs.randint(0, 40, 2)).to(cuda)}
            want = train_step(plain, batch, cfg)
            launches = (launched("stem_conv7x7s2"), launched("group_and_fuse"))
            got = train_step(dp, batch, cfg)
            assert (launched("stem_conv7x7s2") - launches[0],
                    launched("group_and_fuse") - launches[1]) == (1, 1)
            for k in want:
                assert torch.equal(got[k], want[k]), k
        a, b = plain.model.state_dict(), dp.model.state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    finally:
        shutdown(world)
        torch.backends.cudnn.deterministic = deterministic


OPCHECK_CASES = ["stem_bf16", "stem_bf16_epilogue", "stem_f32_epilogue",
                 "grouping_mean", "grouping_ceil_sum"]


@pytest.mark.parametrize("case", OPCHECK_CASES)
def test_ops_opcheck_on_the_card(cuda, case):
    """`torch.library.opcheck` of `gvcnn::stem_conv7x7s2` and
    `gvcnn::group_and_fuse` on CUDA tensors (the kernels' implementation)."""
    rs = np.random.RandomState(len(case))
    if case.startswith("stem"):
        dtype = torch.float32 if "f32" in case else torch.bfloat16
        x = torch.from_numpy(rs.randn(2, 30, 34, 3).astype(np.float32))
        w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(
            np.float32))
        affine = ((torch.rand(64, device=cuda) + 0.5,
                   torch.randn(64, device=cuda)) if "epilogue" in case
                  else (None, None))
        torch.library.opcheck(torch.ops.gvcnn.stem_conv7x7s2.default, (
            x.to(cuda, dtype), w.to(cuda, dtype), *affine,
            "epilogue" in case))
    else:
        scores = torch.softmax(torch.from_numpy(
            rs.randn(3, 12).astype(np.float32)), -1).to(cuda)
        descs = torch.from_numpy(rs.randn(3, 12, 1024).astype(
            np.float32)).to(cuda)
        torch.library.opcheck(torch.ops.gvcnn.group_and_fuse.default,
                              (scores, descs, 8, case.split("_", 1)[1]))


@pytest.fixture(scope="module")
def small_artifact():
    """mn40_12view at 64x64, 4 views, bf16, exported on the card at B = 2
    (seeded weights, folded BN) -> (loaded module, the eager model, x)."""
    import dataclasses
    import io

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.models.gvcnn import (
        build_model,
        init_weights,
        to_device,
    )
    from gvcnn_tf_tpu_torch.tools.export_model import export_model
    from gvcnn_tf_tpu_torch.utils import fold_batch_norm

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    base = get_config("mn40_12view")
    cfg = base.replace(data=dataclasses.replace(
        base.data, height=64, width=64, num_views=4, batch_size=2))
    module = torch.export.load(io.BytesIO(export_model(
        cfg, device="cuda"))).module()
    eager = fold_batch_norm(init_weights(build_model(cfg), cfg.train.seed))
    eager = to_device(eager.cast_convs_(), dev).eval()
    x = torch.from_numpy(np.random.RandomState(5).uniform(
        -1, 1, (2, 4, 64, 64, 3)).astype(np.float32)).to(dev)
    return module, eager, x


def test_artifact_launches_each_kernel_once_a_forward(cuda, small_artifact):
    module, _, x = small_artifact
    before = (launched("stem_conv7x7s2"), launched("group_and_fuse"))
    with torch.inference_mode():
        module(x)
        module(x)
    torch.cuda.synchronize()
    assert (launched("stem_conv7x7s2") - before[0],
            launched("group_and_fuse") - before[1]) == (2, 2)


def test_artifact_equals_the_eager_forward(cuda, small_artifact):
    """The artifact and the eager model run the same kernels and cuDNN
    convs in bf16: within 1e-2 of max|logit| (a few bf16 roundings; they
    are expected equal), argmax equal."""
    module, eager, x = small_artifact
    with torch.inference_mode():
        got, probs = module(x)
        want, ep = eager(x)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-2 * scale
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    torch.testing.assert_close(probs, ep["Predictions"], rtol=0, atol=1e-2)


def _png_tree(root, num_shapes=8, res=64, views=4):
    """A rendered-view PNG tree of the procedural split (10 classes)."""
    from gvcnn_tf_tpu_torch.data.procedural import build_procedural_split
    from gvcnn_tf_tpu_torch.utils.png import write_png

    v, labels = build_procedural_split(
        num_views=views, height=res, width=res, num_shapes=num_shapes,
        seed=0, train_split=True, num_classes=10)
    for i in range(num_shapes):
        d = root / f"class{labels[i]:02d}" / f"s{i:04d}"
        d.mkdir(parents=True, exist_ok=True)
        for k in range(views):
            write_png(str(d / f"view_{k:02d}.png"), v[i, k])
    return str(root)


def _loader_cfg(tree, logdir, loader):
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config

    base = get_config("mn40_12view")
    return base.replace(
        data=dataclasses.replace(
            base.data, height=64, width=64, num_views=4, batch_size=2,
            dataset_dir=tree, loader=loader, transfer_dtype="uint8"),
        train=dataclasses.replace(base.train, train_logdir=str(logdir),
                                  log_every=1, checkpoint_every=2))


def test_device_flip_on_the_card(cuda, tmp_path):
    import importlib

    from gvcnn_tf_tpu_torch.utils import device_flip

    train_mod = importlib.import_module("gvcnn_tf_tpu_torch.train")
    rs = np.random.RandomState(0)
    views = torch.from_numpy(rs.randint(0, 256, (3, 4, 9, 10, 3)).astype(
        np.uint8))
    mask = torch.from_numpy(rs.rand(3, 4) < 0.5)
    got = device_flip(views.cuda(), mask.cuda()).cpu()
    assert torch.equal(got, device_flip(views, mask))
    cfg = _loader_cfg(_png_tree(tmp_path / "t"), tmp_path / "run",
                      "decoded")
    state = train_mod.create_train_state(cfg, "cuda")
    masks = []
    for step in range(20):
        state.step = step
        m = train_mod.flip_mask(state, cfg, (8, 12))
        assert m.device.type == "cuda" and m.dtype == torch.bool
        masks.append(m.cpu())
    rate = float(torch.stack(masks).float().mean())
    assert abs(rate - 0.5) < 5 * 0.5 / np.sqrt(20 * 96)
    state.step = 0
    before = (launched("stem_conv7x7s2"), launched("group_and_fuse"))
    batch = {"views": views.new_zeros((2, 4, 64, 64, 3)).cuda(),
             "label": torch.zeros(2, dtype=torch.long, device="cuda")}
    mets = train_mod.train_step(state, batch, cfg)
    assert np.isfinite(float(mets["loss"]))
    assert (launched("stem_conv7x7s2") - before[0],
            launched("group_and_fuse") - before[1]) == (1, 1)


def _train_three_steps(cfg):
    import importlib

    train_mod = importlib.import_module("gvcnn_tf_tpu_torch.train")
    before = (launched("stem_conv7x7s2"), launched("group_and_fuse"))
    state, mets = train_mod.train(cfg, num_steps=3, device="cuda")
    assert state.step == 3 and np.isfinite(mets["loss"])
    assert (launched("stem_conv7x7s2") - before[0],
            launched("group_and_fuse") - before[1]) == (3, 3)


def test_native_train_on_the_card(cuda, tmp_path):
    """Three steps through the native decode pool; where the machine lacks
    libjpeg or libpng (the H100 machine this port is measured on), the
    loader refuses, naming what is missing, and the test says so."""
    from gvcnn_tf_tpu_torch.data import make_dataset, native_loader

    cfg = _loader_cfg(_png_tree(tmp_path / "t"), tmp_path / "run", "native")
    if not native_loader.available():
        with pytest.raises(RuntimeError, match="missing .*(jpeglib.h|png.h|"
                                               "libjpeg|libpng)") as e:
            make_dataset(cfg.data, train=True)
        pytest.skip(str(e.value).splitlines()[0])
    _train_three_steps(cfg)


def test_tfrecord_train_on_the_card(cuda, tmp_path):
    """Three steps through the TFRecord reader (the pool's decoder, or PIL
    where the pool does not build)."""
    from gvcnn_tf_tpu_torch.data.tfrecord import build_tfrecords

    tree = _png_tree(tmp_path / "t")
    build_tfrecords(tree, str(tmp_path / "tfr"), 4, num_shards=2)
    _train_three_steps(_loader_cfg(str(tmp_path / "tfr"), tmp_path / "run",
                                   "tfrecord"))


def _procedural_cfg(logdir, mode):
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config

    base = get_config("mn40_12view")
    return base.replace(
        data=dataclasses.replace(
            base.data, height=64, width=64, num_views=4, batch_size=2,
            num_classes=10, dataset="procedural", transfer_dtype="uint8",
            synthetic_num_shapes=8, device_resident=mode),
        train=dataclasses.replace(base.train, train_logdir=str(logdir),
                                  checkpoint_every=10, log_every=1))


def test_resident_step_is_the_streaming_step_on_the_card(cuda):
    """One bf16 step on a batch of the card-resident split (the staged
    split and its indices, gathered in the step) against one on the same
    batch streamed through the prefetcher, from one seeded state, cuDNN
    deterministic: equal bit for bit, one launch of each kernel a step, and
    the resident batch's views the staged tensor itself."""
    from gvcnn_tf_tpu_torch.data import DevicePrefetcher, make_dataset
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    cfg = _procedural_cfg("unused", "on")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        resident = make_dataset(cfg.data, train=True, device=cuda)
        assert type(resident).__name__ == "DeviceResidentIter"
        assert resident.views.is_cuda
        stream = make_dataset(cfg.data, train=True)
        states, outs = [], []
        for it in (resident, stream):
            with DevicePrefetcher(it, cuda) as pf:
                batch = next(pf)
            state = create_train_state(cfg, cuda)
            launches = (launched("stem_conv7x7s2"), launched("group_and_fuse"))
            outs.append(train_step(state, batch, cfg))
            assert (launched("stem_conv7x7s2") - launches[0],
                    launched("group_and_fuse") - launches[1]) == (1, 1)
            states.append(state.model.state_dict())
            if it is resident:
                assert batch["views"].data_ptr() == resident.views.data_ptr()
                assert batch["idx"].is_cuda and batch["idx"].shape == (2,)
        for k in outs[0]:
            assert torch.equal(outs[0][k], outs[1][k]), k
        for k in states[0]:
            assert torch.equal(states[0][k], states[1][k]), k
    finally:
        torch.backends.cudnn.deterministic = deterministic


def test_profiled_window_on_the_card(cuda, tmp_path):
    """`train(profile_steps=(1, 3))` over 4 resident steps: the Chrome
    trace holds the spans of steps 1 and 2 only, and the device events of
    exactly 2 launches of each kernel (their `__global__` names)."""
    import json

    from gvcnn_tf_tpu_torch.parallel import World
    from gvcnn_tf_tpu_torch.tools.measure import PROFILE_TRIES
    from gvcnn_tf_tpu_torch.train import trace_name, train

    for attempt in range(PROFILE_TRIES):   # measure.kernel_us's retry
        logdir = tmp_path / str(attempt)
        state, _ = train(_procedural_cfg(logdir, "auto"), num_steps=4,
                         profile_steps=(1, 3), device="cuda")
        assert state.step == 4
        assert [p.name for p in logdir.glob("*.json")] == [
            trace_name((1, 3), World())]
        with open(logdir / trace_name((1, 3), World())) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        if kernels:
            break
    spans = sorted(e["name"] for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("train_step "))
    assert spans == ["train_step 1", "train_step 2"]
    assert sum("stem_conv_mma_kernel" in k for k in kernels) == 2
    assert sum("group_and_fuse_kernel" in k for k in kernels) == 2


# ---------------------------------------------------------------------------
# CUDA graphs: the compiled step, the engine's buckets, eval
# ---------------------------------------------------------------------------

def _graph_cfg(config="mn40_12view", size=64, **train_kw):
    """`config` (mn40_12view) at size x size (64x64), 4 views, B = 2, bf16,
    dropout on, the decoded loader's on-card flip on a uint8 wire."""
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config

    base = get_config(config)
    return base.replace(
        data=dataclasses.replace(
            base.data, height=size, width=size, num_views=4, batch_size=2,
            loader="decoded", augment=True, device_flip=True,
            transfer_dtype="uint8"),
        train=dataclasses.replace(base.train, **train_kw))


def _u8_batches(cfg, n, seed=0):
    d = cfg.data
    rs = np.random.RandomState(seed)
    return [{"views": torch.from_numpy(rs.randint(
        0, 256, (d.batch_size, d.num_views, d.height, d.width, 3)).astype(
            np.uint8)).cuda(), "label": torch.from_numpy(rs.randint(
                0, d.num_classes, d.batch_size)).cuda()} for _ in range(n)]


@pytest.mark.parametrize("op", ["mul", "div"])
def test_foreach_by_a_0d_tensor_is_by_the_scalar_on_the_card(cuda, op):
    """The optimizer's device scalars on the card: `_foreach_mul` of fp32
    CUDA tensors by a 0-d fp32 CUDA tensor gives the bits of the same call
    by the Python float; `_foreach_div` by a Python float is `_foreach_mul`
    by its fp32 reciprocal there (a division by a 0-d tensor is IEEE's and
    differs), which is how `Optimizer` stores Adam's corrections on a
    card."""
    rs = np.random.RandomState(3)
    xs = [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(cuda)
          for s in [(1000,), (64, 3, 7, 7), (5,)]]
    for value in (-0.1 * 0.94 ** 3, 1.0 - 0.999 ** 7, -1e-3 / 3):
        if op == "mul":
            want = torch._foreach_mul(xs, value)
            got = torch._foreach_mul(xs, torch.tensor(value, device=cuda))
        else:
            want = torch._foreach_div(xs, value)
            inv = np.float32(1.0) / np.float32(value)
            got = torch._foreach_mul(xs, torch.tensor(float(inv),
                                                      device=cuda))
        for a, b in zip(want, got):
            assert torch.equal(a, b), value


@pytest.mark.parametrize("clip", [0.0, 0.7])
@pytest.mark.parametrize("kind", ["momentum", "sgd", "adam"])
def test_device_scalar_optimizer_on_the_card(cuda, kind, clip):
    """5 updates of CUDA tensors with the optimizer's scalars in device
    tensors equal the Python-float update bit for bit
    (`tests/torch_optimizer_ref.py`)."""
    from torch_optimizer_ref import python_float_update

    from gvcnn_tf_tpu_torch.configs import TrainConfig
    from gvcnn_tf_tpu_torch.train import Optimizer

    tc = TrainConfig(optimizer=kind, learning_rate=0.1, lr_decay_steps=2,
                     lr_decay_rate=0.94, warmup_steps=3, grad_clip_norm=clip)
    rs = np.random.RandomState(7)
    shapes = [(3, 4), (5000,), (64, 3, 7, 7)]
    start = [rs.randn(*s).astype(np.float32) for s in shapes]
    got, ref = (Optimizer([torch.from_numpy(p.copy()).to(cuda)
                           for p in start], tc) for _ in range(2))
    for count in range(5):
        grads = [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(cuda)
                 for s in shapes]
        got.step(grads)
        python_float_update(ref, grads, count)
        for a, b in zip(got.params, ref.params):
            assert torch.equal(a, b), count


def test_compiled_step_is_the_eager_step_on_the_card(cuda):
    """3 steps of the compiled step (the warm-up, a capture and its replay,
    a replay) equal 3 eager steps bit for bit, cuDNN deterministic on both
    sides: loss, grad_norm, every parameter and BatchNorm statistic, with
    dropout, the on-card flip and accumulate_steps = 2; the launches equal
    the eager step's (one K2 and one K1 a microbatch)."""
    from gvcnn_tf_tpu_torch.train import (
        compile_train_step,
        create_train_state,
        train_step,
    )

    cfg = _graph_cfg(accumulate_steps=2)
    batches = _u8_batches(cfg, 3)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = create_train_state(cfg, cuda)
        state = create_train_state(cfg, cuda)
        step = compile_train_step(state, cfg, batches[0])
        for b in batches:
            before = (launched("stem_conv7x7s2"), launched("group_and_fuse"))
            want = train_step(ref, b, cfg)
            eager = (launched("stem_conv7x7s2") - before[0],
                     launched("group_and_fuse") - before[1])
            before = (launched("stem_conv7x7s2"), launched("group_and_fuse"))
            got = step(state, b, cfg)
            assert (launched("stem_conv7x7s2") - before[0],
                    launched("group_and_fuse") - before[1]) == eager == (2, 2)
            for k in want:
                assert torch.equal(got[k], want[k]), k
        a, b = ref.model.state_dict(), state.model.state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), k
        assert (step.graph.captures, step.graph.replays) == (1, 2)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def test_train_replays_its_step_on_the_card(cuda, tmp_path, monkeypatch):
    """`train()` with one rank on the card runs the compiled step: 4 steps
    are a warm-up and 3 replays, one launch of each kernel a step."""
    import dataclasses
    import importlib

    train_mod = importlib.import_module("gvcnn_tf_tpu_torch.train")
    made = []
    real = train_mod.compile_train_step

    def spy(*a):
        made.append(real(*a))
        return made[-1]

    monkeypatch.setattr(train_mod, "compile_train_step", spy)
    cfg = _procedural_cfg(tmp_path, "auto")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                checkpoint_every=0))
    before = (launched("stem_conv7x7s2"), launched("group_and_fuse"))
    state, mets = train_mod.train(cfg, num_steps=4, device="cuda")
    assert state.step == 4 and np.isfinite(mets["loss"])
    assert (launched("stem_conv7x7s2") - before[0],
            launched("group_and_fuse") - before[1]) == (4, 4)
    [step] = made
    assert (step.graph.captures, step.graph.replays) == (1, 3)


def _engine_cfg():
    import dataclasses

    from gvcnn_tf_tpu_torch import get_config

    base = get_config("mn40_12view")
    return base.replace(data=dataclasses.replace(
        base.data, height=64, width=64, num_views=4,
        transfer_dtype="uint8"))


def test_engine_bucket_replay_is_the_eager_forward(cuda):
    """A bucket's replayed forward gives the logits and scores of the
    engine's model run eagerly on the same request, bit for bit."""
    from gvcnn_tf_tpu_torch.serve import InferenceEngine
    from gvcnn_tf_tpu_torch.utils import normalize_views

    views = np.random.RandomState(1).randint(
        0, 256, (2, 4, 64, 64, 3)).astype(np.uint8)
    engine = InferenceEngine(_engine_cfg(), serve_batch_size=2,
                             device="cuda")
    try:
        g = engine.graphs[(2, np.dtype(np.uint8))]
        logits, scores = engine.logits_and_scores(views)
        assert (g.captures, g.replays) == (1, 2)

        def eager():
            with torch.inference_mode():
                out, ep = engine.model(normalize_views(
                    torch.from_numpy(views).cuda()))
                return (out.cpu().numpy(),
                        ep["view_discrimination_scores"].cpu().numpy())

        want = engine._device_thread.submit(eager).result()
    finally:
        engine.close()
    np.testing.assert_array_equal(logits, want[0])
    np.testing.assert_array_equal(scores, want[1])


def test_a_weight_reload_changes_the_replayed_logits(cuda):
    """Weights loaded in place into a serving engine's model change what
    its graphs compute (the stem's packed weight and scale and shift are
    computed inside the graph): the reloaded engine answers as an engine
    built with those weights."""
    import dataclasses

    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.serve import InferenceEngine
    from gvcnn_tf_tpu_torch.utils import fold_batch_norm

    cfg = _engine_cfg()
    views = np.random.RandomState(2).randint(
        0, 256, (2, 4, 64, 64, 3)).astype(np.uint8)
    other = cfg.replace(train=dataclasses.replace(cfg.train, seed=7))
    fresh = InferenceEngine(other, serve_batch_size=2, device="cuda")
    engine = InferenceEngine(cfg, serve_batch_size=2, device="cuda")
    try:
        want = fresh.logits_and_scores(views)[0]
        before = engine.logits_and_scores(views)[0]
        weights = fold_batch_norm(init_weights(build_model(other), 7))
        weights.cast_convs_()
        engine._device_thread.submit(
            engine.model.load_state_dict, weights.state_dict()).result()
        after = engine.logits_and_scores(views)[0]
        g = engine.graphs[(2, np.dtype(np.uint8))]
        assert g.captures == 1
    finally:
        engine.close()
        fresh.close()
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, want)


def test_eval_graph_counts_as_eager_on_the_card(cuda, tmp_path, monkeypatch):
    """`evaluate` of a 10-shape procedural split (3 padded batches of 4)
    through its graph gives the eager counts and logits; the graph was
    captured once and replayed for the batches after the warm-up."""
    import dataclasses

    from gvcnn_tf_tpu_torch import eval as eval_mod
    from gvcnn_tf_tpu_torch.train import create_train_state
    from gvcnn_tf_tpu_torch.utils import graphs

    cfg = _procedural_cfg(tmp_path, "off")
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, batch_size=4, synthetic_num_shapes=10))
    state = create_train_state(cfg, cuda)
    results = []
    for capture in (True, False):
        with monkeypatch.context() as mp:
            if not capture:
                mp.setattr(graphs, "capturable", lambda device: False)
            with eval_mod.recorded_logits() as seen:
                results.append((eval_mod.evaluate(cfg, state=state,
                                                  per_class=True),
                                torch.cat(seen)))
    (got, got_logits), (want, want_logits) = results
    assert got == want and got["count"] == 10
    assert torch.equal(got_logits, want_logits)
    [g] = eval_mod._GRAPHS[state.model].values()
    assert (g.captures, g.replays) == (1, 2)


def test_train_in_a_world_of_one_over_nccl_replays(cuda, tmp_path,
                                                   monkeypatch):
    """`train()` in a world of one rank over NCCL runs the compiled step,
    its all-reduce captured in the graph: 3 steps (a warm-up, a capture and
    its replay, a replay) end where the single process's `train()` ends,
    bit for bit, cuDNN deterministic."""
    import dataclasses
    import datetime
    import importlib

    from gvcnn_tf_tpu_torch.parallel import initialize_distributed, shutdown

    train_mod = importlib.import_module("gvcnn_tf_tpu_torch.train")
    made = []
    real = train_mod.compile_train_step

    def spy(*a):
        made.append(real(*a))
        return made[-1]

    monkeypatch.setattr(train_mod, "compile_train_step", spy)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    states = []
    for name in ("alone", "world"):
        cfg = _procedural_cfg(tmp_path / name, "off")
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    checkpoint_every=0))
        world = None
        if name == "world":
            world = initialize_distributed(
                timeout=datetime.timedelta(seconds=120), device="cuda:0",
                init_method=f"file://{tmp_path}/rendezvous", rank=0,
                world_size=1)
            assert (world.backend, world.size) == ("nccl", 1)
        try:
            state, _ = train_mod.train(cfg, num_steps=3, device="cuda",
                                       world=world)
        finally:
            if world is not None:
                shutdown(world)
        states.append(state.model.state_dict())
    assert [(s.graph.captures, s.graph.replays) for s in made] == [(1, 2)] * 2
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


# ---------------------------------------------------------------------------
# The max-pool kernels (csrc/max_pool.cu)
# ---------------------------------------------------------------------------

# (pool, H = W, C, k, s) of every max pool of Inception-v1 (13) and
# ResNet-50 (1) at 224x224, as tests/test_torch_pool_kernel.py lists them.
POOL_SHAPES = [
    ("MaxPool_2a_3x3", 112, 64, 3, 2), ("MaxPool_3a_3x3", 56, 192, 3, 2),
    ("Mixed_3b", 28, 192, 3, 1), ("Mixed_3c", 28, 256, 3, 1),
    ("MaxPool_4a_3x3", 28, 480, 3, 2), ("Mixed_4b", 14, 480, 3, 1),
    ("Mixed_4c", 14, 512, 3, 1), ("Mixed_4d", 14, 512, 3, 1),
    ("Mixed_4e", 14, 512, 3, 1), ("Mixed_4f", 14, 528, 3, 1),
    ("MaxPool_5a_2x2", 14, 832, 2, 2), ("Mixed_5b", 7, 832, 3, 1),
    ("Mixed_5c", 7, 832, 3, 1), ("resnet50_pool1", 112, 64, 3, 2)]
POOL_N = 8


def _pool_input(cuda, n, h, c, dtype, seed):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(n, c, h, h).astype(np.float32))
    return x.to(cuda, dtype).contiguous(memory_format=torch.channels_last)


def _geometry(x, k, s):
    from gvcnn_tf_tpu_torch.ops.pool import _pads

    return (k, k), (s, s), _pads(x, (k, k), (s, s), "SAME")


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,h,c,k,s", POOL_SHAPES)
def test_pool_kernel_is_the_plain_pool_bit_for_bit(cuda, name, h, c, k, s,
                                                   dtype, record):
    """The forward kernel at N = 8 gives `F.pad` + `F.max_pool2d`'s output
    bit for bit, and its record the plain record (bf16 draws hold ties,
    which both credit to the first maximum)."""
    from gvcnn_tf_tpu_torch.ops import pool_kernel as pk

    x = _pool_input(cuda, POOL_N, h, c, dtype, h + c + k)
    geo = _geometry(x, k, s)
    before = launched("max_pool_same_fwd")
    with torch.no_grad():
        y, slot = pk._forward(x, *geo, record)
        want = pk.max_pool_plain(x, *geo)
        torch.cuda.synchronize()
    assert launched("max_pool_same_fwd") == before + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, want)
    if record:
        want_y, want_slot = pk.max_pool_record_plain(x, *geo)
        assert torch.equal(want_y, want)
        assert torch.equal(slot, want_slot)
    else:
        assert slot.numel() == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,h,c,k,s", POOL_SHAPES)
def test_pool_backward_kernel_matches_autograd(cuda, name, h, c, k, s,
                                               dtype):
    """The pool's op at N = 8 against autograd through `F.pad` +
    `F.max_pool2d`: dx bit-equal where an input wins one window (or none),
    within one bf16 ulp (fp32: 1e-6 relative) where it wins several, the
    fp32 sum taken in another order; the backward kernel launches once."""
    from gvcnn_tf_tpu_torch.ops import pool_kernel as pk

    x = _pool_input(cuda, POOL_N, h, c, dtype, h + c + k + 1)
    geo = _geometry(x, k, s)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = launched("max_pool_same_bwd")
    y = pk.max_pool_same(xa, *geo)
    dy = _pool_input(cuda, POOL_N, y.shape[2], c, dtype, 5)
    y.backward(dy)
    pk.max_pool_plain(xb, *geo).backward(dy)
    torch.cuda.synchronize()
    assert launched("max_pool_same_bwd") == before + 1
    _, slot = pk.max_pool_record_plain(x, *geo)
    wins = pk.max_pool_backward_plain(torch.ones_like(dy, dtype=torch.float32),
                                      slot, (h, h), *geo)
    got, want = xa.grad.float(), xb.grad.float()
    once = wins <= 1
    assert torch.equal(got[once], want[once])
    if dtype == torch.bfloat16:
        assert bool(((got - want).abs() <= _bf16_ulp(want)).all())
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_pool_kernel_edges_on_the_card(cuda):
    """Ties, all -inf windows and NaN by the first-maximum rule, SAME and
    VALID, forward and backward, each against the plain record and the
    plain gather from it; most windows are ties of zeros, so slot 0 wins
    most of them.  A C that does not fill 16-byte channel vectors, and data
    one element past an aligned address, raise in both directions."""
    from gvcnn_tf_tpu_torch.ops import pool_kernel as pk
    from gvcnn_tf_tpu_torch.ops.pool import _pads

    x = torch.zeros(2, 8, 9, 10, device=cuda)
    x[0, 0, :3, :3] = -torch.inf
    x[0, 1, 4, 4] = x[0, 1, 5, 6] = torch.nan
    x[1, 2] = torch.randint(0, 3, (9, 10), device=cuda).float()
    x[1, 5] = torch.randn(9, 10, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype).contiguous(memory_format=torch.channels_last)
        for k, s in pk.GEOMETRIES:
            for padding in ("SAME", "VALID"):
                what = (dtype, k, s, padding)
                geo = ((k, k), (s, s), _pads(xd, (k, k), (s, s), padding))
                y, slot = pk._forward(xd, *geo, True)
                want, want_slot = pk.max_pool_record_plain(xd, *geo)
                assert torch.equal(y.isnan(), want.isnan()), what
                assert torch.equal(torch.nan_to_num(y),
                                   torch.nan_to_num(want)), what
                assert torch.equal(slot, want_slot), what
                dy = torch.randn(y.shape, device=cuda).to(dtype).contiguous(
                    memory_format=torch.channels_last)
                dx = pk._backward(dy, slot, (9, 10), *geo).float()
                want_dx = pk.max_pool_backward_plain(dy, want_slot, (9, 10),
                                                     *geo).float()
                wins = pk.max_pool_backward_plain(
                    torch.ones_like(dy, dtype=torch.float32), want_slot,
                    (9, 10), *geo)
                assert torch.equal(dx[wins <= 1], want_dx[wins <= 1]), what
                if dtype == torch.bfloat16:
                    assert bool(((dx - want_dx).abs()
                                 <= _bf16_ulp(want_dx)).all()), what
                else:
                    torch.testing.assert_close(dx, want_dx, rtol=1e-6,
                                               atol=1e-6)
    for dtype, c in ((torch.bfloat16, 3), (torch.bfloat16, 4),
                     (torch.float32, 6)):
        xc = torch.zeros(2, c, 12, 12, device=cuda, dtype=dtype).contiguous(
            memory_format=torch.channels_last)
        geo = _geometry(xc, 3, 2)
        with pytest.raises(ValueError, match="multiple"):
            pk._forward(xc, *geo, True)
        y = torch.zeros(2, c, 6, 6, device=cuda, dtype=dtype).contiguous(
            memory_format=torch.channels_last)
        with pytest.raises(ValueError, match="multiple"):
            pk._backward(y, y.to(torch.uint8), (12, 12), *geo)
    flat = torch.randn(1 + 2 * 12 * 12 * 16, device=cuda).to(torch.bfloat16)
    view = flat[1:].view(2, 12, 12, 16).permute(0, 3, 1, 2)
    assert view.is_contiguous(memory_format=torch.channels_last)
    geo = _geometry(view, 3, 2)
    with pytest.raises(ValueError, match="aligned"):
        pk.max_pool_same(view, *geo)
    _, slot = pk._forward(view.clone(), *geo, True)
    flat = torch.randn(1 + slot.numel(), device=cuda).to(torch.bfloat16)
    dy = flat[1:].view(2, 6, 6, 16).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="aligned"):
        pk._backward(dy, slot, (12, 12), *geo)


def test_pool_dtypes_and_geometries_on_the_card(cuda):
    """bf16 and fp32 pick their kernels; another dtype or window raises; an
    NCHW-contiguous input gives the channels-last input's result."""
    from gvcnn_tf_tpu_torch.ops import pool_kernel as pk

    x = _pool_input(cuda, 2, 12, 16, torch.float32, 4)
    geo = _geometry(x, 3, 2)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            pk.max_pool_same(x.to(dtype), *geo)
    with pytest.raises(ValueError):
        pk.max_pool_same(x, (5, 5), (2, 2), ((1, 2), (1, 2)))
    with pytest.raises(ValueError):
        pk.max_pool_same(x, (3, 3), (1, 2), geo[2])
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        want = pk.max_pool_same(xd, *geo)
        got = pk.max_pool_same(xd.contiguous(), *geo)
        assert got.dtype == dtype and torch.equal(got, want)


def test_pool_ops_opcheck_on_the_card(cuda):
    """`torch.library.opcheck` of `gvcnn::max_pool_same` (with and without
    the record) and `gvcnn::max_pool_same_backward` on CUDA tensors."""
    x = _pool_input(cuda, 2, 12, 16, torch.bfloat16, 6)
    for record in (False, True):
        torch.library.opcheck(torch.ops.gvcnn.max_pool_same.default,
                              (x, [3, 3], [2, 2], [0, 1, 0, 1], record))
    y, slot = torch.ops.gvcnn.max_pool_same(x, [3, 3], [2, 2], [0, 1, 0, 1],
                                            True)
    dy = torch.randn_like(y)
    torch.library.opcheck(torch.ops.gvcnn.max_pool_same_backward.default,
                          (dy, slot, [12, 12], [3, 3], [2, 2], [0, 1, 0, 1]))


def _replay_kernels(step, state, batch, cfg):
    """({kernel name: launches} of one profiled replay of a compiled step,
    the replays made): a window in which the profiler saw nothing is
    profiled again, as `measure.kernel_us` does."""
    from torch.profiler import ProfilerActivity, profile

    from gvcnn_tf_tpu_torch.tools.measure import PROFILE_TRIES

    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(state, batch, cfg)
            torch.cuda.synchronize()
        seen = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen[e.name] = seen.get(e.name, 0) + 1
        if seen:
            return seen, tries
    raise RuntimeError("the profiler saw no kernel in a replay")


def test_compiled_step_runs_the_pool_kernels(cuda, monkeypatch):
    """A captured and replayed B = 4 train step of mn40_12view (64x64, 4
    views, bf16) runs the pool kernels, 13 forwards and 13 backwards a
    step, and no `at::native` max-pool kernel; against the same step with
    the pools on `F.pad` + `F.max_pool2d`, it runs three fewer fills (the
    -inf pads) and at least three fewer copies.  Every pool's input is
    already channels-last (the kernel's `.contiguous` copies nothing)."""
    import dataclasses

    from gvcnn_tf_tpu_torch.ops import pool_kernel as pk
    from gvcnn_tf_tpu_torch.train import compile_train_step, create_train_state

    cfg = _graph_cfg()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=4))
    batches = _u8_batches(cfg, 3)
    layouts = []
    real_forward, real_backward = pk._forward, pk._backward

    def forward(x, *a):
        layouts.append(x.is_contiguous(memory_format=torch.channels_last))
        return real_forward(x, *a)

    def backward(dy, *a):
        layouts.append(dy.is_contiguous(memory_format=torch.channels_last))
        return real_backward(dy, *a)

    counts = {}
    for path in ("kernel", "plain"):
        with monkeypatch.context() as mp:
            if path == "plain":
                mp.setattr(pk, "max_pool_same",
                           lambda x, k, s, p: pk.max_pool_plain(x, k, s, p))
            else:
                mp.setattr(pk, "_forward", forward)
                mp.setattr(pk, "_backward", backward)
            state = create_train_state(cfg, cuda)
            step = compile_train_step(state, cfg, batches[0])
            step(state, batches[0], cfg)          # the warm-up
            step(state, batches[1], cfg)          # the capture, replayed
            before = (launched("max_pool_same_fwd"),
                      launched("max_pool_same_bwd"))
            counts[path], replays = _replay_kernels(step, state, batches[2],
                                                    cfg)
            moved = (launched("max_pool_same_fwd") - before[0],
                     launched("max_pool_same_bwd") - before[1])
            per = (13, 13) if path == "kernel" else (0, 0)
            assert moved == (per[0] * replays, per[1] * replays)
    assert len(layouts) >= 2 * 26 and all(layouts)

    def launches(path, part):
        return sum(n for k, n in counts[path].items() if part in k.lower())

    kern = counts["kernel"]
    assert sum(n for k, n in kern.items()
               if "max_pool_same_fwd_nhwc" in k) == 13
    assert sum(n for k, n in kern.items()
               if "max_pool_same_bwd_nhwc" in k) == 13
    assert not any("max_pool" in k and "at::native" in k for k in kern)
    assert launches("plain", "at::native") > 0
    assert launches("kernel", "fill") <= launches("plain", "fill") - 3
    assert launches("kernel", "copy") <= launches("plain", "copy") - 3


# ---------------------------------------------------------------------------
# The average-pool kernels (csrc/avg_pool.cu)
# ---------------------------------------------------------------------------

# (H = W, C) of Inception-v4's average pools at 299x299: 4, 7 and 3 of them.
AVG_SHAPES = [(35, 384), (17, 1024), (8, 1536)]
AVG_N = 384


def _avg_input(cuda, n, h, c, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, c, h, h, generator=g, device=cuda)
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _within_avg_tolerance(got, want, dtype):
    """bf16: one ulp of want (fp32 sums in another order may round the
    other way), and 1e-6 more where a window's values cancel toward 0 (the
    fp32 sums' own rounding); fp32: rtol = atol = 1e-6."""
    got, want = got.float(), want.float()
    if dtype == torch.bfloat16:
        assert bool(((got - want).abs() <= _bf16_ulp(want) + 1e-6).all())
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,c", AVG_SHAPES)
def test_avg_pool_forward_kernel_is_the_plain_pool(cuda, h, c, dtype):
    """The forward kernel at 384 images against the plain forward
    (`F.avg_pool2d` counting the pads): a channels-last output of x's shape
    within the tolerance; it launches once."""
    from gvcnn_tf_tpu_torch.ops import pool_kernel as pk

    x = _avg_input(cuda, AVG_N, h, c, dtype, h + c)
    before = launched("avg_pool_same_fwd")
    with torch.no_grad():
        y = pk.avg_pool_same(x)
        want = pk.avg_pool_plain(x)
    torch.cuda.synchronize()
    assert launched("avg_pool_same_fwd") == before + 1
    assert y.shape == x.shape and y.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last)
    _within_avg_tolerance(y, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,c", AVG_SHAPES)
def test_avg_pool_backward_kernel_is_autograds(cuda, h, c, dtype):
    """The pool's op at 384 images: dx from the backward kernel
    within the tolerance of autograd's through `F.avg_pool2d` and of the
    plain box sum of dy; one launch each way, through the op's gradient.
    Autograd runs on fp32 NCHW copies of x and dy and its dx is rounded to
    the dtype once: PyTorch's channels-last backward is displaced (module
    docstring), and its bf16 NCHW backward lay up to 2 ulps from the
    kernel's on the card (it divides each dy by 9 in bf16 before it
    sums)."""
    from gvcnn_tf_tpu_torch.ops import pool_kernel as pk

    x = _avg_input(cuda, AVG_N, h, c, dtype, h + c + 1)
    dy = _avg_input(cuda, AVG_N, h, c, dtype, 5)
    xa = x.clone().requires_grad_()
    xb = x.float().contiguous().requires_grad_()
    before = (launched("avg_pool_same_fwd"), launched("avg_pool_same_bwd"))
    y = pk.avg_pool_same(xa)
    y.backward(dy)
    F.avg_pool2d(xb, 3, 1, padding=1, count_include_pad=True).backward(
        dy.float().contiguous())
    plain = pk.avg_pool_backward_plain(dy)
    torch.cuda.synchronize()
    assert (launched("avg_pool_same_fwd") - before[0],
            launched("avg_pool_same_bwd") - before[1]) == (1, 1)
    assert "gvcnn_avg_pool_same" in type(y.grad_fn).__name__
    assert xa.grad.is_contiguous(memory_format=torch.channels_last)
    _within_avg_tolerance(xa.grad, xb.grad.to(dtype), dtype)
    _within_avg_tolerance(xa.grad, plain, dtype)


def test_compiled_inception_v4_step_runs_the_avg_pool_kernels(cuda):
    """A captured and replayed B = 2 train step of
    mn40_12view_inception_v4 (80x80, 4 views, bf16) runs the average-pool
    kernels, 14 forwards and 14 backwards a step, as its launch counters
    say, and no `avg_pool2d` kernel of PyTorch's."""
    from gvcnn_tf_tpu_torch.ops import pool_kernel as pk
    from gvcnn_tf_tpu_torch.train import compile_train_step, create_train_state

    cfg = _graph_cfg("mn40_12view_inception_v4", size=80)
    batches = _u8_batches(cfg, 3)
    state = create_train_state(cfg, cuda)
    step = compile_train_step(state, cfg, batches[0])
    step(state, batches[0], cfg)          # the warm-up
    step(state, batches[1], cfg)          # the capture, replayed
    before = (launched("avg_pool_same_fwd"), launched("avg_pool_same_bwd"))
    kern, replays = _replay_kernels(step, state, batches[2], cfg)
    assert (launched("avg_pool_same_fwd") - before[0],
            launched("avg_pool_same_bwd") - before[1]) == (14 * replays,
                                                  14 * replays)
    assert sum(n for k, n in kern.items() if "avg_pool_same_fwd" in k) == 14
    assert sum(n for k, n in kern.items() if "avg_pool_same_bwd" in k) == 14
    assert not any("avg_pool2d" in k for k in kern)


def test_avg_pool_refuses_on_the_card_without_launching(cuda):
    """Another window, another dtype, a C that does not fill 16-byte
    channel vectors and data off a 16-byte boundary raise, each before a
    launch; an NCHW-contiguous input gives the channels-last input's
    result."""
    from gvcnn_tf_tpu_torch.ops import pool_kernel as pk
    from gvcnn_tf_tpu_torch.ops.pool import avg_pool

    before = (launched("avg_pool_same_fwd"), launched("avg_pool_same_bwd"))
    x = _avg_input(cuda, 2, 12, 16, torch.float32, 7)
    with pytest.raises(ValueError, match="3x3 window at stride 1"):
        avg_pool(x, (3, 3), (2, 2))
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            pk.avg_pool_same(x.to(dtype))
    for dtype, c in ((torch.bfloat16, 12), (torch.float32, 6)):
        xc = _avg_input(cuda, 2, 12, c, dtype, 8)
        with pytest.raises(ValueError, match="multiple"):
            pk.avg_pool_same(xc)
        with pytest.raises(ValueError, match="multiple"):
            pk.avg_pool_same(xc.requires_grad_()).sum().backward()
    flat = torch.randn(1 + 2 * 12 * 12 * 16, device=cuda).to(torch.bfloat16)
    view = flat[1:].view(2, 12, 12, 16).permute(0, 3, 1, 2)
    assert view.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="aligned"):
        pk.avg_pool_same(view)
    torch.cuda.synchronize()
    assert (launched("avg_pool_same_fwd"),
            launched("avg_pool_same_bwd")) == before
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        want = pk.avg_pool_same(xd)
        got = pk.avg_pool_same(xd.contiguous())
        assert got.dtype == dtype and torch.equal(got, want)



# ---------------------------------------------------------------------------
# Train-mode BatchNorm (+ ReLU) (csrc/batch_norm.cu)
# ---------------------------------------------------------------------------

# (name, N, C, H, W): the B = 32 cells' real shapes (Inception-v1's
# Conv2d_1a, Inception-v4's Conv2d_2a, ResNet-50's block4) and a C that is
# not a multiple of 8 (one channel a thread).
BN_SHAPES = [("v1_Conv2d_1a", 384, 64, 112, 112),
             ("v4_Conv2d_2a", 384, 32, 147, 147),
             ("resnet50_block4", 384, 2048, 7, 7),
             ("odd_c", 6, 37, 9, 11)]
BN_EPS, BN_MOMENTUM = 1e-3, 0.9


def _ulp(t, dtype):
    """The spacing of `dtype`'s numbers at |t| (t float32)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - (7 if dtype == torch.bfloat16 else 23))


def _bn_case(cuda, n, c, h, w, dtype, scale, seed=0):
    """(x, dy, weight or None, bias): x with a mean and a spread of its own
    a channel, channels-last, in `dtype`; fp32 parameters."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    mu = torch.randn(c, 1, 1, generator=g, device=cuda)
    sd = torch.rand(c, 1, 1, generator=g, device=cuda) * 2 + 0.1
    x = torch.randn(n, c, h, w, generator=g, device=cuda) * sd + mu
    dy = torch.randn(n, c, h, w, generator=g, device=cuda)
    weight = (torch.rand(c, generator=g, device=cuda) + 0.5) if scale else None
    bias = torch.randn(c, generator=g, device=cuda) * 0.5
    cl = torch.channels_last
    return (x.to(dtype).contiguous(memory_format=cl),
            dy.to(dtype).contiguous(memory_format=cl), weight, bias)


def _within(name, got, want, bound):
    """|got - want| <= bound everywhere (bound a number or a tensor)."""
    gap = (got.float() - want.float()).abs()
    excess = (gap - bound).max().item()
    assert excess <= 0, (f"{name}: max gap {gap.max().item():.3g}, past its "
                         f"bound by {excess:.3g}")


def _bn_kernels(x, dy, weight, bias, rm, rv, relu, update=True):
    """(mean, invstd, y, dx, dweight, dbias) of the four kernels."""
    mean, invstd = torch.ops.gvcnn.batch_norm_stats(x, rm, rv, BN_MOMENTUM,
                                                    BN_EPS, update)
    y = torch.ops.gvcnn.batch_norm_apply(x, weight, bias, mean, invstd, relu)
    dx, dw, db = torch.ops.gvcnn.batch_norm_backward(
        dy, x, weight, bias, mean, invstd, relu,
        [True, weight is not None, True])
    return mean, invstd, y, dx, dw, db


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,n,c,h,w", BN_SHAPES)
def test_batch_norm_kernels_match_plain(cuda, name, n, c, h, w, dtype, relu,
                                        scale):
    """The four kernels against the plain versions on fp32 copies on the
    card.  Statistics: the mean within 1e-4 of the largest channel std,
    invstd and the running variance within rtol 1e-4, the running mean as
    the mean.  y and the gradients against the plain apply and backward
    given the kernels' own statistics (so the ReLU's mask is the same): y
    within one ulp of its dtype (the same fp32 expression; the plain
    version rounds the fma twice), dx within one bf16 ulp plus 1e-4 of
    max|dx| (fp32: 1e-4 of max|dx|), dbeta and dgamma within 1e-4 of the
    channel's sum of |terms| (fp32 sums in another order)."""
    from gvcnn_tf_tpu_torch.ops import batch_norm_kernel as bk

    x, dy, weight, bias = _bn_case(cuda, n, c, h, w, dtype, scale)
    rm = torch.randn(c, device=cuda)
    rv = torch.rand(c, device=cuda) + 0.5
    rm_k, rv_k = rm.clone(), rv.clone()
    before = launched("batch_norm")
    mean, invstd, y, dx, dw, db = _bn_kernels(x, dy, weight, bias, rm_k,
                                              rv_k, relu)
    torch.cuda.synchronize()
    assert launched("batch_norm") - before == 4
    assert y.dtype == dx.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert dx.is_contiguous(memory_format=torch.channels_last)

    xf = x.float()
    mean_p, invstd_p = bk.stats_plain(xf, BN_EPS)
    tol = 1e-4 * invstd_p.reciprocal().max().item()
    _within("mean", mean, mean_p, tol)
    _within("invstd", invstd, invstd_p, 1e-4 * invstd_p)
    bk.update_plain(rm, rv, mean_p, bk.var_plain(invstd_p, BN_EPS),
                    BN_MOMENTUM)
    _within("running_mean", rm_k, rm, tol)
    _within("running_var", rv_k, rv, 1e-4 * rv)

    want_y = bk.apply_plain(xf, weight, bias, mean, invstd, relu)
    _within("y", y, want_y, _ulp(want_y, dtype))
    want = bk.backward_plain(dy.float(), xf, weight, bias, mean, invstd,
                             relu, [True, scale, True])
    top = 1e-4 * want[0].abs().max().item()
    _within("dx", dx, want[0], top + (
        0.0 if dtype == torch.float32 else _ulp(want[0], dtype)))
    g = dy.float()
    if relu:
        g = torch.where(bk.apply_plain(xf, weight, bias, mean, invstd,
                                       False) > 0, g, 0.0)
    _within("dbeta", db, want[2], 1e-4 * g.abs().sum((0, 2, 3)))
    if scale:
        xhat = (xf - mean[:, None, None]) * invstd[:, None, None]
        _within("dgamma", dw, want[1],
                1e-4 * (g * xhat).abs().sum((0, 2, 3)))
    else:
        assert dw.numel() == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batch_norm_backward_reads_a_channel_slice_in_place(cuda, dtype):
    """dy as a concat's backward hands it over, the channels [o, o + C) of
    a wider channels-last tensor, is read where it lies (its row pitch,
    no copy): the gradients of a contiguous dy, bit for bit at an offset
    that keeps 16-byte vectors; at one that does not (one channel a thread,
    so sums in another order) dx within one bf16 ulp plus 1e-4 of max|dx|
    and the parameters' within 1e-4 of max|d|."""
    from gvcnn_tf_tpu_torch.ops import batch_norm_kernel as bk

    x, _, weight, bias = _bn_case(cuda, 16, 64, 14, 14, dtype, True)
    mean, invstd = torch.ops.gvcnn.batch_norm_stats(
        x, torch.zeros(64, device=cuda), torch.ones(64, device=cuda),
        BN_MOMENTUM, BN_EPS, False)
    wide = torch.randn(16, 200, 14, 14, device=cuda).to(dtype).contiguous(
        memory_format=torch.channels_last)
    for offset in (64, 3):
        dy = wide[:, offset:offset + 64]
        assert bk._pitch(dy) == 200
        got = torch.ops.gvcnn.batch_norm_backward(
            dy, x, weight, bias, mean, invstd, True, [True, True, True])
        want = torch.ops.gvcnn.batch_norm_backward(
            dy.contiguous(memory_format=torch.channels_last), x, weight,
            bias, mean, invstd, True, [True, True, True])
        for a, b in zip(got, want):
            if offset % (16 // x.element_size()) == 0:
                assert torch.equal(a, b)
            else:
                _within("slice", a, b, 1e-4 * b.abs().max().item() + (
                    _ulp(b.float(), dtype) if a.dim() == 4 else 0.0))


def test_batch_norm_moves_no_statistics_in_a_recompute(cuda):
    """`BatchNorm` in train mode launches the stats and apply kernels once a
    forward; the stats kernel moves the running statistics (and their
    version counters) outside a remat recompute and not inside one, where
    the batch statistics, and so y, are the same bit for bit."""
    from gvcnn_tf_tpu_torch.models.backbones import layers

    bn = layers.BatchNorm(64, momentum=BN_MOMENTUM).to(cuda).train()
    x, _, _, _ = _bn_case(cuda, 8, 64, 28, 28, torch.bfloat16, False)
    before = (launched("batch_norm_stats"), launched("batch_norm_apply"))
    state = [t.clone() for t in (bn.running_mean, bn.running_var)]
    versions = [bn.running_mean._version, bn.running_var._version]
    with layers._recomputing():
        y0 = bn(x, relu=True)
    assert all(torch.equal(a, b) for a, b in
               zip(state, (bn.running_mean, bn.running_var)))
    assert [bn.running_mean._version, bn.running_var._version] == versions
    y1 = bn(x, relu=True)
    torch.cuda.synchronize()
    assert torch.equal(y0, y1)
    assert not torch.equal(state[0], bn.running_mean)
    assert not torch.equal(state[1], bn.running_var)
    assert bn.running_mean._version > versions[0]
    assert (launched("batch_norm_stats") - before[0],
            launched("batch_norm_apply") - before[1]) == (2, 2)


def test_batch_norm_replays_in_a_graph(cuda):
    """The four kernels captured in a CUDA graph and replayed on new data
    give the eager results bit for bit, move the running statistics once a
    replay, and leave the tile tickets at 0 (no memset in the graph)."""
    from gvcnn_tf_tpu_torch.ops import batch_norm_kernel as bk

    cases = [_bn_case(cuda, 32, 192, 28, 28, torch.bfloat16, True, seed)
             for seed in range(3)]
    x, dy, weight, bias = (t.clone() for t in cases[0])
    rm, rv = torch.zeros(192, device=cuda), torch.ones(192, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _bn_kernels(x, dy, weight, bias, rm.clone(), rv.clone(), True)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _bn_kernels(x, dy, weight, bias, rm, rv, True)
    for case in cases[1:]:
        for static, new in zip((x, dy, weight, bias), case):
            static.copy_(new)
        rm_e, rv_e = rm.clone(), rv.clone()
        graph.replay()
        want = _bn_kernels(*case, rm_e, rv_e, True)
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            assert torch.equal(a, b)
        assert torch.equal(rm, rm_e) and torch.equal(rv, rv_e)
        assert int(bk._device(x.device)[0].abs().sum()) == 0


def test_compiled_inception_v1_step_runs_the_batch_norm_kernels(
        cuda, monkeypatch):
    """A captured and replayed B = 2 train step of mn40_12view (64x64, 4
    views, bf16) launches the stats, apply, backward-reduce and backward-
    elementwise kernels once for each BatchNorm a step, as the launch
    counters say, and none of PyTorch's batch-norm kernels; every x reaches
    the stats, apply and backward wrappers channels-last and every dy with
    a row pitch (no copy of either); the eager step runs no
    `native_batch_norm` and no separate ReLU."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from gvcnn_tf_tpu_torch.models.backbones.layers import BatchNorm
    from gvcnn_tf_tpu_torch.ops import batch_norm_kernel as bk
    from gvcnn_tf_tpu_torch.train import compile_train_step, create_train_state

    cfg = _graph_cfg()
    batches = _u8_batches(cfg, 3)
    state = create_train_state(cfg, cuda)
    n_bn = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    assert n_bn > 50
    copies, x_copies = [], []
    real_nhwc, real_channels_last = bk._nhwc, bk._channels_last
    monkeypatch.setattr(bk, "_nhwc", lambda t: copies.append(
        bk._pitch(t) is None) or real_nhwc(t))
    monkeypatch.setattr(bk, "_channels_last", lambda t: x_copies.append(
        not t.is_contiguous(memory_format=torch.channels_last))
        or real_channels_last(t))

    class Ops(TorchDispatchMode):
        seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(func._schema.name)
            return func(*args, **(kwargs or {}))

    step = compile_train_step(state, cfg, batches[0])
    with Ops() as ops:
        step(state, batches[0], cfg)          # the warm-up, eager
    assert "gvcnn::batch_norm_apply" in ops.seen
    assert not ops.seen & {"aten::native_batch_norm", "aten::relu",
                           "aten::relu_", "aten::threshold_backward",
                           "aten::native_batch_norm_backward"}
    assert len(copies) == n_bn and not any(copies)
    assert len(x_copies) == 3 * n_bn and not any(x_copies)
    step(state, batches[1], cfg)              # the capture, replayed
    names = ("stats", "apply", "bwd_reduce", "bwd_elemt")
    before = [launched(f"batch_norm_{k}") for k in names]
    kern, replays = _replay_kernels(step, state, batches[2], cfg)
    assert [launched(f"batch_norm_{k}") - b for k, b in
            zip(names, before)] == [n_bn * replays] * 4
    for k in names:
        assert sum(n for name, n in kern.items()
                   if f"batch_norm_{k}<" in name) == n_bn, k
    assert not any("batch_norm" in k and "channels_last" in k for k in kern)


# ---------------------------------------------------------------------------
# The residual join (csrc/residual_join.cu)
# ---------------------------------------------------------------------------

# (name, N, C, H = W): Inception-ResNet-v2's three joins at 384 images (a
# B = 32 step of 12 views at 299x299), and a C that is not a multiple of 8
# (one channel a thread).
JOIN_SHAPES = [("block35", 384, 320, 35), ("block17", 384, 1088, 17),
               ("block8", 384, 2080, 8), ("odd_c", 6, 37, 9)]


def _join_case(cuda, n, c, hw, dtype, seed=0):
    """(x, u, dy channels-last in `dtype`, bias fp32): x and u of a spread
    that puts about half of x + s (u + b) below 0."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    cl = torch.channels_last
    x, u, dy = (torch.randn(n, c, hw, hw, generator=g, device=cuda).to(
        dtype).contiguous(memory_format=cl) for _ in range(3))
    return x, u, dy, torch.randn(c, generator=g, device=cuda)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,n,c,hw", JOIN_SHAPES)
def test_residual_join_kernels_match_plain(cuda, name, n, c, hw, dtype,
                                           relu):
    """The forward, backward and bias-gradient kernels against the plain
    versions on the card: y, dx and du equal bit for bit (the same fp32
    operations, no fma contraction, one rounding into the dtype), dbias
    within 1e-4 of the channel's sum of |du| (fp32 sums in another order),
    as `test_batch_norm_kernels_match_plain` bounds its parameter
    gradients.  Without the ReLU (the last block8) dx is dy itself."""
    from gvcnn_tf_tpu_torch.ops import residual_join as rj

    x, u, dy, b = _join_case(cuda, n, c, hw, dtype)
    scale = {"block35": 0.17, "block17": 0.10}.get(name, 0.20 if relu
                                                    else 1.0)
    before = (launched("residual_join_fwd"), launched("residual_join_bwd"),
              launched("residual_join_bias_grad"))
    y = torch.ops.gvcnn.residual_join(x, u, b, scale, relu)
    dx, du, db = torch.ops.gvcnn.residual_join_backward(
        dy, y if relu else None, scale, relu)
    torch.cuda.synchronize()
    assert (launched("residual_join_fwd") - before[0],
            launched("residual_join_bwd") - before[1],
            launched("residual_join_bias_grad") - before[2]) == (1, 1, 1)
    assert y.dtype == du.dtype == dtype and db.dtype == torch.float32
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert du.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, rj.residual_join_plain(x, u, b, scale, relu))
    want_dx, want_du, want_db = rj.residual_join_backward_plain(
        dy, y if relu else None, scale, relu)
    if relu:
        assert dx.dtype == dtype and torch.equal(dx, want_dx)
    else:
        assert dx.numel() == 0
    assert torch.equal(du, want_du)
    terms = scale * (want_dx if relu else dy).float().abs()
    _within("dbias", db, want_db, 1e-4 * terms.sum((0, 2, 3)))
    again = torch.ops.gvcnn.residual_join_backward(
        dy, y if relu else None, scale, relu)
    assert torch.equal(again[2], db)          # the same order every launch


def test_residual_join_refuses_what_it_does_not_take(cuda):
    """Another dtype, a u of another shape and a bias that is not fp32 (C,)
    raise before a launch; an NCHW-contiguous x gives the channels-last
    result, in x's layout."""
    from gvcnn_tf_tpu_torch.ops import residual_join as rj

    x, u, dy, b = _join_case(cuda, 4, 64, 6, torch.float32)
    before = launched("residual_join")
    with pytest.raises(TypeError):
        rj.residual_join(x.half(), u.half(), b, 0.1, True)
    with pytest.raises(ValueError):
        rj.residual_join(x, u[:, :32], b, 0.1, True)
    with pytest.raises(ValueError):
        rj.residual_join(x, u, b.double(), 0.1, True)
    with pytest.raises(ValueError):
        torch.ops.gvcnn.residual_join_backward(dy, None, 0.1, True)
    torch.cuda.synchronize()
    assert launched("residual_join") == before
    want = rj.residual_join(x, u, b, 0.1, True)
    got = rj.residual_join(x.contiguous(), u.contiguous(), b, 0.1, True)
    assert got.is_contiguous() and torch.equal(got, want)


def test_residual_join_replays_in_a_graph(cuda):
    """The three kernels captured in a CUDA graph and replayed on new data
    give the eager results bit for bit."""
    cases = [_join_case(cuda, 32, 1088, 17, torch.bfloat16, seed)
             for seed in range(3)]
    static = [t.clone() for t in cases[0]]

    def run(x, u, dy, b):
        y = torch.ops.gvcnn.residual_join(x, u, b, 0.1, True)
        return (y,) + tuple(torch.ops.gvcnn.residual_join_backward(
            dy, y, 0.1, True))

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run(*static)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run(*static)
    for case in cases[1:]:
        for s, new in zip(static, case):
            s.copy_(new)
        graph.replay()
        want = run(*case)
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            assert torch.equal(a, b)


def test_inception_resnet_v2_replays_its_joins(cuda):
    """mn40_12view_inception_resnet_v2 at 80x80, 4 views, B = 2, bf16: a
    forward replayed from a CUDA graph (`utils/graphs.CapturedCall`) moves
    `ops.launches` by its 40 joins and gives the eager logits; a captured
    and replayed train step by 40 forward, 40 backward and 40 bias-gradient
    launches, and its profiled replay runs that many of each kernel."""
    from gvcnn_tf_tpu_torch.train import compile_train_step, create_train_state
    from gvcnn_tf_tpu_torch.utils.graphs import CapturedCall

    cfg = _graph_cfg("mn40_12view_inception_resnet_v2", size=80)
    batches = _u8_batches(cfg, 3)
    state = create_train_state(cfg, cuda)
    model = state.model.eval()
    x = batches[0]["views"].to(torch.bfloat16) / 255.0 * 2.0 - 1.0

    inputs = {"x": x.clone()}

    def forward():
        with torch.no_grad():
            return model(inputs["x"])[0]

    call = CapturedCall("irv2 forward", forward, inputs, device=cuda)
    want = call(x=x).clone()                  # the warm-up, eager
    call(x=x)                                 # the capture, replayed
    before = launched("residual_join_fwd")
    got = call(x=x)
    torch.cuda.synchronize()
    assert launched("residual_join_fwd") - before == 40
    assert torch.equal(got, want)
    model.train()

    step = compile_train_step(state, cfg, batches[0])
    step(state, batches[0], cfg)              # the warm-up
    step(state, batches[1], cfg)              # the capture, replayed
    names = ("residual_join_fwd", "residual_join_bwd",
             "residual_join_bias_grad")
    before = [launched(k) for k in names]
    kern, replays = _replay_kernels(step, state, batches[2], cfg)
    assert [launched(k) - b for k, b in zip(names, before)] == \
        [40 * replays] * 3
    for k in names:
        assert sum(n for name, n in kern.items() if k in name) == 40, k
