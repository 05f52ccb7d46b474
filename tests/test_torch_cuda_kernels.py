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

Gradients: the stem's autograd Function against autograd through the plain
version (both end in cuDNN's bf16 conv gradient, fp32 accumulation, in
whatever order cuDNN picks) within 1% of max|dw| and max|dx|; the grouping
head's Function against autograd through its plain version, rtol 1e-5 /
atol 1e-6.  One mn40_12view train step at 64x64, 4 views, B = 2, bf16 on
the card against the same step in fp32 on the CPU: loss within 5%, grad
norm within 10% (bf16 through ~60 layers with batch statistics).

Evaluation: `--eval_every` on a 10-shape procedural split at 64x64, 4
views, B = 4 (`test_eval_on_the_card`, its bounds in its docstring).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

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
    before = stem_conv.launches
    with torch.inference_mode():
        got = stem_conv(xd, wd)
        torch.cuda.synchronize()
        want = stem_conv_plain(xd, wd)
    assert stem_conv.launches == before + 1
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
    before = stem_conv.launches
    with torch.inference_mode():
        got = stem_conv(xd, wd, sd, hd, relu=relu)
        torch.cuda.synchronize()
        want = stem_conv_plain(xd, wd, sd, hd, relu=relu).float()
        conv = stem_conv_plain(xd, wd).float()
    assert stem_conv.launches == before + 1
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
    launches = stem_conv.launches
    with torch.inference_mode():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got = stem(xd)
        torch.cuda.synchronize()
        y = stem_conv_plain(xd, stem.conv.weight).permute(0, 3, 1, 2)
        want = F.relu(stem.BatchNorm(y))
    assert stem_conv.launches == launches + 1
    ops = {e.key for e in prof.key_averages()}
    assert not ops & {"aten::batch_norm", "aten::relu", "aten::relu_"}, ops
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=5e-2)


def test_stem_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 16, 16, 3), device=cuda)
    w = torch.zeros((64, 3, 7, 7), device=cuda)
    with pytest.raises(TypeError):
        stem_conv(x, w)                                       # fp32
    with pytest.raises(ValueError):
        stem_conv(x.bfloat16().permute(0, 2, 1, 3), w.bfloat16())
    wg = w.bfloat16().requires_grad_()
    one = torch.ones(64, device=cuda)
    with pytest.raises(NotImplementedError):                  # epilogue
        stem_conv(x.bfloat16(), wg, one, one, relu=True)
    y = stem_conv(x.bfloat16(), wg)                 # the autograd Function
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
@pytest.mark.parametrize("b,v,c,m", [(8, 12, 1024, 8), (3, 1, 64, 1),
                                     (2, 8, 1024, 16), (1, 12, 300, 8),
                                     (1, 12, 1024, 8), (1, 12, 100, 16),
                                     (4, 16, 300, 1), (1, 12, 300, 16)])
@pytest.mark.parametrize("edges", [False, True])
def test_grouping_kernel_matches_plain(cuda, mode, b, v, c, m, edges):
    rs = np.random.RandomState(b * v + m)
    scores = (_edge_scores(b, v, m) if edges
              else _scores_clear_of_edges(rs, b, v, m))
    s = torch.from_numpy(scores).to(cuda)
    d = torch.from_numpy(rs.randn(b, v, c).astype(np.float32)).to(cuda)
    before = group_and_fuse.launches
    with torch.inference_mode():
        got = group_and_fuse(s, d, m, mode)
        torch.cuda.synchronize()
        want = group_and_fuse_plain(s, d, m, mode)
    assert group_and_fuse.launches == before + 1
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
    fused.sum().backward()                          # the autograd Function
    assert sg.grad is not None and torch.isfinite(sg.grad).all()


@pytest.mark.parametrize("shape", STEM_SHAPES)
@pytest.mark.parametrize("need_dx", [False, True])
def test_stem_function_gradients_match_plain(cuda, shape, need_dx):
    rs = np.random.RandomState(sum(shape) + need_dx)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(np.float32))
    n, h, wd, _ = shape
    g = torch.from_numpy(rs.randn(n, -(-h // 2), -(-wd // 2), 64).astype(
        np.float32)).to(cuda, torch.bfloat16)
    grads = []
    for fn in (stem_conv, stem_conv_plain):
        xd = x.to(cuda, torch.bfloat16).requires_grad_(need_dx)
        wd32 = w.to(cuda).requires_grad_()
        before = stem_conv.launches
        fn(xd, wd32.to(torch.bfloat16)).backward(g)
        assert stem_conv.launches == before + (fn is stem_conv)
        grads.append((wd32.grad, xd.grad))
    (dw, dx), (dw_ref, dx_ref) = grads
    assert dw.dtype == torch.float32
    torch.testing.assert_close(dw, dw_ref, rtol=0,
                               atol=1e-2 * dw_ref.abs().max().item())
    assert (dx is None) == (not need_dx)
    if need_dx:
        torch.testing.assert_close(dx.float(), dx_ref.float(), rtol=0,
                                   atol=1e-2 * dx_ref.abs().max().item())


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
        before = group_and_fuse.launches
        fused, weights, _ = fn(sd, dd, m, mode)
        ((fused * gf).sum() + (weights * gw).sum()).backward()
        assert group_and_fuse.launches == before + (fn is group_and_fuse)
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
    launches = (stem_conv.launches, group_and_fuse.launches)
    got = train_step(state, {k: t.to(cuda) for k, t in batch.items()}, cfg)
    assert (stem_conv.launches - launches[0],
            group_and_fuse.launches - launches[1]) == (1, 1)
    assert state.step == 1
    assert all(torch.isfinite(t) for t in got.values())
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=0.05)
    assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]),
                                                    rel=0.1)
    # Every kernel moves (the score-logit bias has a zero gradient under the
    # softmax over views, so only the kernels are checked).
    assert all(not torch.equal(a, b) for a, b in zip(before, state.kernels))


def _eval_logits():
    """Context: the logits of every GVCNN forward run in eval mode, appended
    to the list it yields (a global module hook; removed on exit)."""
    import contextlib

    from gvcnn_tf_tpu_torch.models.gvcnn import GVCNN

    @contextlib.contextmanager
    def ctx():
        seen = []

        def hook(module, args, out):
            if isinstance(module, GVCNN) and not module.training:
                seen.append(out[0].detach().float().cpu())

        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        try:
            yield seen
        finally:
            handle.remove()

    return ctx()


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
    launches = (stem_conv.launches, group_and_fuse.launches)
    state, _ = train(cfg, num_steps=2, device=cuda)
    assert (stem_conv.launches - launches[0],
            group_and_fuse.launches - launches[1]) == (5, 5)
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
