"""The grouping head of the port against the JAX package.

The plain version (ops/grouping.py) is held to the JAX oracle
(`ops/grouping.py::group_and_fuse`) and to the Pallas kernel in interpret
mode: scheme exact, weights rtol 1e-6, fused rtol 1e-5 / atol 1e-6 (the max
is exact; only the order of the weighted sum differs).  Scores are kept
more than 1e-5 from every interior edge j/M, or put exactly on the edges
with values that are exact in fp32.  The CUDA kernel is held to the plain
version on the card in tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gvcnn_tf_tpu.ops import grouping as G  # noqa: E402
from gvcnn_tf_tpu.ops.pallas_grouping import group_and_fuse_pallas  # noqa: E402
from gvcnn_tf_tpu_torch.ops import grouping as PG  # noqa: E402
from gvcnn_tf_tpu_torch.ops.grouping_kernel import (  # noqa: E402
    group_and_fuse,
    group_and_fuse_plain,
)

C = 32


def _scores_clear_of_edges(rs, b, v, m):
    """Softmax-like scores in (0, 1), each > 1e-5 from every j/M edge."""
    while True:
        s = rs.dirichlet(np.ones(v) * 0.7, size=b).astype(np.float32)
        edges = np.arange(1, m) / m
        if m == 1 or np.abs(s[..., None] - edges).min() > 1e-5:
            return s


def _edge_scores(b, v, m):
    """Scores exactly on j/M edges (and 0, 1): exact in fp32 for M a power
    of two, so ceil(s * M) is the same in every implementation."""
    grid = np.arange(0, m + 1, dtype=np.float32) / np.float32(m)
    idx = np.arange(b * v).reshape(b, v) * 3 % (m + 1)
    return grid[idx]


def _check(got, want):
    fused, weights, scheme = (np.asarray(a) for a in got)
    wf, ww, ws = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(scheme, ws)
    np.testing.assert_allclose(weights, ww, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(fused, wf, rtol=1e-5, atol=1e-6)


def _plain(scores, descs, m, mode):
    return [t.numpy() for t in group_and_fuse_plain(
        torch.from_numpy(scores), torch.from_numpy(descs), m, mode)]


@pytest.mark.parametrize("mode", ["mean", "ceil_sum"])
@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("v", [1, 8, 12])
def test_plain_matches_oracle_and_pallas(mode, m, v):
    rs = np.random.RandomState(100 * m + v)
    scores = _scores_clear_of_edges(rs, 3, v, m)
    descs = rs.randn(3, v, C).astype(np.float32)
    got = _plain(scores, descs, m, mode)
    s, d = jnp.asarray(scores), jnp.asarray(descs)
    _check(got, G.group_and_fuse(s, d, m, mode))
    _check(got, group_and_fuse_pallas(s, d, m, mode, interpret=True))


@pytest.mark.parametrize("mode", ["mean", "ceil_sum"])
@pytest.mark.parametrize("m", [2, 8, 16])
def test_edge_scores_and_empty_groups(mode, m):
    scores = _edge_scores(4, 12, m)
    descs = np.random.RandomState(m).randn(4, 12, C).astype(np.float32)
    got = _plain(scores, descs, m, mode)
    assert (got[2].sum(-1) == 0).any()       # some group is empty
    _check(got, G.group_and_fuse(jnp.asarray(scores), jnp.asarray(descs), m,
                                 mode))


@pytest.mark.parametrize("mode", ["mean", "ceil_sum"])
def test_plain_gradients_match_oracle(mode):
    """Scheme detached, straight-through ceil: the same VJP as JAX."""
    rs = np.random.RandomState(7)
    scores = _scores_clear_of_edges(rs, 2, 8, 8)
    descs = rs.randn(2, 8, C).astype(np.float32)
    gf = rs.randn(2, C).astype(np.float32)
    gw = rs.randn(2, 8).astype(np.float32)

    s = torch.from_numpy(scores).requires_grad_()
    d = torch.from_numpy(descs).requires_grad_()
    fused, weights, _ = PG.group_and_fuse(s, d, 8, mode)
    ((fused * torch.from_numpy(gf)).sum()
     + (weights * torch.from_numpy(gw)).sum()).backward()

    _, vjp = jax.vjp(lambda a, b: G.group_and_fuse(a, b, 8, mode)[:2],
                     jnp.asarray(scores), jnp.asarray(descs))
    ds, dd = vjp((jnp.asarray(gf), jnp.asarray(gw)))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(ds), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(dd), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("method", ["softmax", "sigmoid", "sigmoid_log"])
def test_squash_scores_matches_oracle(method):
    raw = np.random.RandomState(3).randn(2, 12).astype(np.float32)
    np.testing.assert_allclose(
        PG.squash_scores(torch.from_numpy(raw), method).numpy(),
        np.asarray(G.squash_scores(jnp.asarray(raw), method)),
        rtol=1e-6, atol=1e-7)


def test_wrapper_on_cpu_runs_the_plain_version():
    rs = np.random.RandomState(0)
    s = torch.from_numpy(_scores_clear_of_edges(rs, 2, 12, 8))
    d = torch.from_numpy(rs.randn(2, 12, C).astype(np.float32))
    before = group_and_fuse.launches
    got = group_and_fuse(s, d, 8)
    assert group_and_fuse.launches == before
    for a, b in zip(got, group_and_fuse_plain(s, d, 8)):
        torch.testing.assert_close(a, b)
