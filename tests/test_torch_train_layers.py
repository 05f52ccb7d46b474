"""The port's layers and kernels in train mode against the JAX package, on
the CPU.

- BatchNorm in train mode against Flax's `BatchNorm(use_running_average=
  False, use_scale=False)`: the output, the updated mean and var, and the
  gradients of x and bias.  fp32: rtol 1e-5 / atol 1e-5 (Flax's
  E[x^2] - E[x]^2 and the fused kernel's one-pass variance, summed in
  another order); bf16 input: one bf16 rounding of the output and of dx
  (rtol = atol = 2e-2), statistics in fp32 at rtol 1e-5, and the bias
  gradient within 1e-2 (PyTorch's mixed-dtype backward on the CPU returns
  the fp32 sum rounded to bf16; JAX keeps fp32).
- The TF-'SAME' max-pool's gradient against the JAX `max_pool` VJP, with
  ties (post-ReLU zeros) and asymmetric pads: exact at fp32, NCHW and
  channels-last (each window's gradient goes to its first maximum).
- K2's op and its registered gradient (plain forward on the CPU): dw and
  dx against `jax.vjp(stem_conv_reference)` (the pullback the JAX custom
  VJP uses) at bf16, within 1% of max|dw|; against autograd of the plain
  version at fp32, rtol 1e-5.
- K1's op and its registered gradient: its VJP against `jax.vjp` of
  `group_and_fuse_pallas(..., interpret=True)`, rtol 1e-5 / atol 1e-6
  (atol 1e-5 for the score gradient at M = 1, which is rounding noise).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import flax.linen as flax_nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gvcnn_tf_tpu.ops.pallas_grouping import (  # noqa: E402
    group_and_fuse_pallas,
)
from gvcnn_tf_tpu.ops.pallas_stem import stem_conv_reference  # noqa: E402
from gvcnn_tf_tpu.ops.pool import max_pool as jax_max_pool  # noqa: E402
from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import (  # noqa: E402
    BatchNorm,
)
from gvcnn_tf_tpu_torch.ops import grouping_kernel  # noqa: E402
from gvcnn_tf_tpu_torch.ops.grouping_kernel import group_and_fuse  # noqa: E402
from gvcnn_tf_tpu_torch.ops.pool import max_pool  # noqa: E402
from gvcnn_tf_tpu_torch.ops.stem_kernel import (  # noqa: E402
    stem_conv,
    stem_conv_plain,
)


def _nchw(a, channels_last=False):
    t = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    return t.contiguous(memory_format=torch.channels_last) if channels_last \
        else t


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- BatchNorm

def _flax_bn_train(x, bias, mean, var, momentum, dtype, g):
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=momentum,
                           epsilon=1e-3, dtype=dtype,
                           param_dtype=jnp.float32, use_scale=False)
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def f(xx, bb):
        y, upd = bn.apply({"params": {"bias": bb}, "batch_stats": stats},
                          xx, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    (y, new), vjp = jax.vjp(f, jnp.asarray(x, dtype), jnp.asarray(bias))
    gy = jnp.asarray(g, dtype)
    zeros = jax.tree.map(jnp.zeros_like, new)
    dx, db = vjp((gy, zeros))
    return (np.asarray(y, np.float32), np.asarray(new["mean"]),
            np.asarray(new["var"]), np.asarray(dx, np.float32),
            np.asarray(db))


@pytest.mark.parametrize("dtype,channels_last,momentum", [
    ("float32", False, 0.9997), ("float32", True, 0.9),
    ("bfloat16", True, 0.9997)])
def test_batch_norm_train_matches_flax(dtype, channels_last, momentum):
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 6, 5, 16) * 2.0 + rs.randn(16)).astype(np.float32)
    x = np.maximum(x, 0.0)                  # post-ReLU-like, ties at 0
    bias = rs.randn(16).astype(np.float32)
    mean0 = rs.randn(16).astype(np.float32)
    var0 = rs.uniform(0.5, 2.0, 16).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    if dtype == "bfloat16":    # both sides see the same bf16 values
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        g = np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
    want = _flax_bn_train(x, bias, mean0, var0, momentum, jdt, g)

    bn = BatchNorm(16, momentum=momentum).train()
    with torch.no_grad():
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    tdt = getattr(torch, dtype)
    xt = _nchw(x, channels_last).to(tdt).requires_grad_()
    y = bn(xt)
    assert y.dtype == tdt
    y.backward(_nchw(g).to(tdt))
    got = (_nhwc(y), bn.running_mean.numpy(), bn.running_var.numpy(),
           _nhwc(xt.grad), bn.bias.grad.numpy())
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    stat_tol = dict(rtol=1e-5, atol=1e-6)
    db_tol = stat_tol if dtype == "float32" else dict(rtol=1e-2, atol=1e-3)
    for name, a, b, t in zip(("y", "mean", "var", "dx", "dbias"), got, want,
                             (tol, stat_tol, stat_tol, tol, db_tol)):
        np.testing.assert_allclose(a, b, err_msg=name, **t)


def test_batch_norm_train_running_var_is_biased():
    """The EMA takes the biased batch variance (Flax), not the unbiased
    one torch's own batch_norm stores."""
    x = torch.tensor([0.0, 2.0]).reshape(2, 1, 1, 1)
    bn = BatchNorm(1, momentum=0.0).train()
    with torch.no_grad():
        bn(x)
    assert bn.running_mean.item() == pytest.approx(1.0)
    assert bn.running_var.item() == pytest.approx(1.0)   # unbiased: 2.0


# ------------------------------------------------------------------ max-pool

@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("size,k,s", [(14, 3, 2), (15, 3, 2), (16, 3, 1),
                                      (15, 2, 2), (17, 3, 1)])
def test_max_pool_gradient_matches_jax_with_ties(size, k, s, channels_last):
    rs = np.random.RandomState(size * 10 + k * s)
    x = np.maximum(rs.randint(-2, 3, (2, size, size, 5)), 0).astype(
        np.float32)                                     # most windows tie
    y, vjp = jax.vjp(lambda a: jax_max_pool(a, (k, k), (s, s), "SAME"),
                     jnp.asarray(x))
    g = rs.randn(*y.shape).astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(g))[0])

    xt = _nchw(x, channels_last).requires_grad_()
    max_pool(xt, (k, k), (s, s)).backward(_nchw(g))
    np.testing.assert_array_equal(_nhwc(xt.grad), want)


# ---------------------------------------------------------------- K2 (stem)

def _stem_inputs(n, h, w, seed):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    k = (rs.randn(7, 7, 3, 64) * 0.1).astype(np.float32)        # HWIO
    g = rs.randn(n, -(-h // 2), -(-w // 2), 64).astype(np.float32)
    return x, k, g


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("h,w", [(32, 32), (30, 30), (16, 40)])
def test_stem_function_matches_jax_vjp_at_bf16(h, w):
    x, k, g = _stem_inputs(2, h, w, h + w)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    gb = np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
    _, vjp = jax.vjp(stem_conv_reference, jnp.asarray(xb), jnp.asarray(k))
    dx_ref, dw_ref = (np.asarray(a, np.float32)
                      for a in vjp(jnp.asarray(gb, jnp.bfloat16)))

    xt = torch.from_numpy(xb).bfloat16().requires_grad_()
    wt = _oihw(k).requires_grad_()
    y = stem_conv(xt, wt.to(torch.bfloat16))
    assert "gvcnn_stem_conv7x7s2" in y.grad_fn.name()
    y.backward(torch.from_numpy(gb).bfloat16())
    dw = wt.grad.permute(2, 3, 1, 0).numpy()                    # -> HWIO
    assert wt.grad.dtype == torch.float32
    np.testing.assert_allclose(dw, dw_ref, rtol=0,
                               atol=1e-2 * np.abs(dw_ref).max())
    dx = xt.grad.float().numpy()
    np.testing.assert_allclose(dx, dx_ref, rtol=0,
                               atol=1e-2 * np.abs(dx_ref).max())


@pytest.mark.parametrize("h,w,need_dx", [(32, 32, False), (31, 33, True),
                                         (30, 30, True)])
def test_stem_function_matches_plain_autograd_at_fp32(h, w, need_dx):
    x, k, g = _stem_inputs(2, h, w, 3 * h + w)
    gt = torch.from_numpy(g)
    xa = torch.from_numpy(x).requires_grad_(need_dx)
    wa = _oihw(k).requires_grad_()
    stem_conv(xa, wa).backward(gt)
    xb = torch.from_numpy(x).requires_grad_(need_dx)
    wb = _oihw(k).requires_grad_()
    stem_conv_plain(xb, wb).backward(gt)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-5, atol=1e-5)
    assert (xa.grad is None) == (not need_dx)
    if need_dx:
        torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-5)


def test_stem_epilogue_refuses_gradients():
    x, k, _ = _stem_inputs(1, 16, 16, 0)
    w = _oihw(k).requires_grad_()
    one = torch.ones(64)
    with pytest.raises(NotImplementedError, match="eval-only"):
        stem_conv(torch.from_numpy(x), w, one, one, relu=True)
    with torch.no_grad():
        stem_conv(torch.from_numpy(x), w, one, one, relu=True)


# ------------------------------------------------------------- K1 (grouping)

def _edge_scores(b, v, m):
    grid = np.arange(0, m + 1, dtype=np.float32) / np.float32(m)
    return grid[np.arange(b * v).reshape(b, v) * 3 % (m + 1)]


@pytest.mark.parametrize("mode", ["mean", "ceil_sum"])
@pytest.mark.parametrize("m,edges", [(1, False), (8, False), (16, False),
                                     (8, True)])
def test_grouping_function_matches_jax_fused_op_vjp(mode, m, edges):
    rs = np.random.RandomState(m + 7 * edges)
    b, v, c = 3, 12, 32
    scores = (_edge_scores(b, v, m) if edges
              else rs.dirichlet(np.ones(v) * 0.7, size=b).astype(np.float32))
    descs = rs.randn(b, v, c).astype(np.float32)
    gf = rs.randn(b, c).astype(np.float32)
    gw = rs.randn(b, m).astype(np.float32)
    _, vjp = jax.vjp(
        lambda s, d: group_and_fuse_pallas(s, d, m, mode, interpret=True)[:2],
        jnp.asarray(scores), jnp.asarray(descs))
    ds_ref, dd_ref = (np.asarray(a) for a in vjp((jnp.asarray(gf),
                                                  jnp.asarray(gw))))

    s = torch.from_numpy(scores).requires_grad_()
    d = torch.from_numpy(descs).requires_grad_()
    fused, weights, scheme = group_and_fuse(s, d, m, mode)
    assert "gvcnn_group_and_fuse" in fused.grad_fn.name()
    assert not scheme.requires_grad
    ((fused * torch.from_numpy(gf)).sum()
     + (weights * torch.from_numpy(gw)).sum()).backward()
    # With M = 1 the weights are 1 whatever the scores, and the score
    # gradient is rounding noise of a few 1e-6 on both sides.
    np.testing.assert_allclose(s.grad.numpy(), ds_ref, rtol=1e-5,
                               atol=1e-5 if m == 1 else 1e-6)
    np.testing.assert_allclose(d.grad.numpy(), dd_ref, rtol=1e-5, atol=1e-6)


def test_grouping_function_takes_a_scheme_cotangent():
    """The backward accepts a cotangent for all three outputs; the scheme's
    changes nothing (the scheme is detached)."""
    rs = np.random.RandomState(0)
    s = torch.from_numpy(rs.dirichlet(np.ones(12), size=2).astype(np.float32))
    d = torch.from_numpy(rs.randn(2, 12, 8).astype(np.float32))

    class Ctx:
        saved_tensors = (s, d)
        num_group, weight_mode = 8, "mean"

    gf, gw = torch.ones(2, 8), torch.ones(2, 8)
    with_scheme = grouping_kernel._backward(Ctx(), gf, gw,
                                            torch.ones(2, 8, 12))
    without = grouping_kernel._backward(Ctx(), gf, gw,
                                        torch.zeros(2, 8, 12))
    for a, b in zip(with_scheme[:2], without[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
