"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc: it is marked `cuda` and skips
where `torch.cuda.is_available()` is false.  The file imports no JAX, so it
runs on a machine that has only PyTorch (tests/conftest.py imports JAX, so
skip it there):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py

Tolerances: the stem (bf16 out, both sides accumulate in fp32) rtol = atol
= 1e-2, one bf16 rounding apart; the grouping head (fp32) scheme exact,
weights rtol 1e-6, fused rtol 1e-5 / atol 1e-6.  TF32 is turned off for the
fp32 comparisons, so the plain version's einsums run in full fp32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


@pytest.mark.parametrize("shape", [(12, 224, 224, 3), (2, 30, 30, 3),
                                   (1, 31, 33, 3), (3, 8, 130, 3)])
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


def test_stem_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 16, 16, 3), device=cuda)
    w = torch.zeros((64, 3, 7, 7), device=cuda)
    with pytest.raises(TypeError):
        stem_conv(x, w)                                       # fp32
    with pytest.raises(ValueError):
        stem_conv(x.bfloat16().permute(0, 2, 1, 3), w.bfloat16())
    with pytest.raises(NotImplementedError):
        stem_conv(x.bfloat16(), w.bfloat16().requires_grad_())


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
@pytest.mark.parametrize("b,v,c,m", [(8, 12, 1024, 8), (3, 1, 64, 1),
                                     (2, 8, 1024, 16), (1, 12, 300, 8)])
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
    with pytest.raises(NotImplementedError):
        group_and_fuse(s.requires_grad_(), torch.zeros((1, 4, 8),
                                                       device=cuda), 8)
