"""The blocks of the port's Inception-v3/v4 and ResNet-50 against the JAX
package's, one at a time, on the CPU at fp32 (the whole backbones:
`tests/test_torch_backbones.py`, whose helpers this file uses).

- Eval mode: the blocks of v3 and v4 (their stems, Inception-A/B/C,
  Reduction-A/B), at a few pixels, against the JAX block modules, weights
  and BatchNorm calibrated as that file does; max|diff| <= 1e-4 x max|ref|.
- Train mode (batch statistics, the BatchNorm EMA, gradients) of ResNet's
  strided bottleneck (scaled BN, projection shortcut) and of v4's
  Inception-A (average pool) and Reduction-A ('VALID' convs, max-pool):
  output, new statistics, and the gradients of x and of every parameter
  against `jax.vjp`, within 1e-3 of each tensor's max (the mean
  subtraction of train-mode BN over a few dozen values amplifies fp32
  rounding).
- ResNet's bottleneck, which hands its shortcut to conv3's BatchNorm as a
  residual, against the composition it replaced (conv3's BatchNorm
  without the ReLU, the add, `F.relu`): in train mode bit for bit in fp32
  (output, statistics, every gradient), with the identity and with the
  projection shortcut; ResNet-50's eval forward bit for bit in bf16 and
  fp32.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gvcnn_tf_tpu.models.backbones import inception_v3 as jax_v3  # noqa: E402
from gvcnn_tf_tpu.models.backbones import inception_v4 as jax_v4  # noqa: E402
from gvcnn_tf_tpu.models.backbones import resnet as jax_resnet  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import state_dict_to_jax  # noqa: E402
from gvcnn_tf_tpu_torch.models.backbones import (  # noqa: E402
    inception_v3,
    inception_v4,
    resnet,
)
from gvcnn_tf_tpu_torch.models.backbones.layers import (  # noqa: E402
    BatchNorm,
    conv2d_tf,
)
from test_torch_backbones import (  # noqa: E402
    _nhwc,
    assert_close_rel,
    calibrate_bn,
    randomize,
)


# The blocks of v3 and v4, one at a time: (port factory, JAX module,
# input channels, input size).
BLOCKS = {
    "v4_stem": (lambda: inception_v4.InceptionV4Base("Mixed_5a"),
                functools.partial(jax_v4.InceptionV4Base,
                                  final_endpoint="Mixed_5a"),
                3, 75),
    "v4_inception_a": (inception_v4.inception_a, jax_v4.InceptionA, 384, 5),
    "v4_reduction_a": (inception_v4.reduction_a, jax_v4.ReductionA, 384, 7),
    "v4_inception_b": (inception_v4.inception_b, jax_v4.InceptionB, 1024,
                       5),
    "v4_reduction_b": (inception_v4.reduction_b, jax_v4.ReductionB, 1024,
                       7),
    "v4_inception_c": (inception_v4.inception_c, jax_v4.InceptionC, 1536,
                       4),
    "v3_stem": (lambda: inception_v3.InceptionV3Base("MaxPool_5a_3x3"),
                functools.partial(jax_v3.InceptionV3Base,
                                  final_endpoint="MaxPool_5a_3x3"), 3, 75),
    "v3_block_a": (lambda: inception_v3.block_a(192, 32), functools.partial(
        jax_v3._BlockA, pool_proj=32), 192, 5),
    "v3_block_b": (lambda: inception_v3.block_b(128), functools.partial(
        jax_v3._BlockB, width=128), 768, 5),
    "v3_block_c": (lambda: inception_v3.block_c(1280), jax_v3._BlockC, 1280,
                   4),
}


def _block_io(key, rs):
    make, jmake, cin, hw = BLOCKS[key]
    port = make()
    x = rs.uniform(-1, 1, (2, hw, hw, cin)).astype(np.float32)
    return port, jmake(dtype=jnp.float32), x


def _port_block(port, x):
    """A block takes NCHW, a backbone NHWC; both give NHWC back here."""
    t = torch.from_numpy(x)
    if isinstance(port, inception_v4.StagedBackbone):
        return _nhwc(port(t)[0])
    return _nhwc(port(t.permute(0, 3, 1, 2)))


@pytest.mark.parametrize("key", list(BLOCKS))
def test_block_matches_jax(key):
    rs = np.random.RandomState(len(key))
    port, jm, x = _block_io(key, rs)
    xt = torch.from_numpy(x)
    calibrate_bn(port, xt if isinstance(port, inception_v4.StagedBackbone)
                 else xt.permute(0, 3, 1, 2), rs)
    with torch.no_grad():
        got = _port_block(port, x)
    v = state_dict_to_jax(port.state_dict())
    want = jax.jit(functools.partial(jm.apply, train=False))(v, x)
    if isinstance(want, tuple):
        want = want[0]
    assert_close_rel(got, jax.device_get(want), msg=key)


# Train mode: (port factory, JAX factory, input channels, input size).
TRAIN_BLOCKS = {
    "resnet_bottleneck_s2": (
        lambda: resnet.Bottleneck(64, 32, stride=2),
        lambda: jax_resnet.Bottleneck(32, 2, dtype=jnp.float32), 64, 9),
    "v4_inception_a": (inception_v4.inception_a,
                       lambda: jax_v4.InceptionA(dtype=jnp.float32), 384, 5),
    "v4_reduction_a": (inception_v4.reduction_a,
                       lambda: jax_v4.ReductionA(dtype=jnp.float32), 384, 7),
}


@pytest.mark.parametrize("key", list(TRAIN_BLOCKS))
def test_train_mode_block_matches_jax(key):
    make, jmake, cin, hw = TRAIN_BLOCKS[key]
    rs = np.random.RandomState(7)
    port = make()
    randomize(port, rs)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(torch.from_numpy(
                    rs.normal(0, 0.1, m.running_mean.shape).astype(
                        np.float32)))
                m.momentum = 0.9
    x = rs.uniform(-1, 1, (2, hw, hw, cin)).astype(np.float32)
    v = state_dict_to_jax(port.state_dict())
    jm = jmake()
    jm = jm.clone(bn_momentum=0.9)

    def fwd(params, xx):
        out, upd = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return out, upd["batch_stats"]

    out, vjp_fn, stats = jax.vjp(fwd, v["params"], x, has_aux=True)
    g = rs.normal(0, 1, np.shape(out)).astype(np.float32)
    gparams, gx = vjp_fn(jnp.asarray(g))

    port.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = port(xt)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    assert_close_rel(_nhwc(y), out, rel=1e-3, msg="output")
    assert_close_rel(_nhwc(xt.grad), gx, rel=1e-3, msg="dx")
    want = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(
        {"params": gparams, "batch_stats": stats}))[0])
    got_tree = state_dict_to_jax(
        {**{k: p.grad for k, p in port.named_parameters()},
         **{k: b for k, b in port.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}})
    got = dict(jax.tree_util.tree_flatten_with_path(got_tree)[0])
    assert set(got) == set(want)
    for path in want:
        assert_close_rel(got[path], want[path], rel=1e-3, msg=str(path))


def _unfused_bottleneck(block, x):
    """The bottleneck as it ran before the residual op: conv3's BatchNorm
    without the ReLU, then relu(shortcut + y)."""
    import torch.nn.functional as F

    shortcut = x if block.shortcut is None else block.shortcut(x)
    c3 = block.conv3
    y = c3.BatchNorm(conv2d_tf(block.conv2(block.conv1(x)), c3.conv.weight,
                               c3.conv.stride, c3.padding))
    return F.relu(shortcut + y)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shortcut", ["identity", "projection"])
def test_train_mode_bottleneck_is_the_unfused_composition(shortcut,
                                                          channels_last):
    """A train-mode bottleneck (fp32, scaled BN) gives the unfused
    composition's output, running statistics and gradients of x and of
    every parameter bit for bit, with the identity shortcut (256 -> 256)
    and with the projection (64 -> 128, stride 2)."""
    rs = np.random.RandomState(11)
    in_ch, width, stride = (256, 64, 1) if shortcut == "identity" else (
        64, 32, 2)
    fused = resnet.Bottleneck(in_ch, width, stride)
    randomize(fused, rs)
    assert (fused.shortcut is None) == (shortcut == "identity")
    unfused = resnet.Bottleneck(in_ch, width, stride)
    unfused.load_state_dict(fused.state_dict())
    x = torch.from_numpy(rs.uniform(-1, 1, (2, in_ch, 9, 9)).astype(
        np.float32))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya = fused.train()(xa)
    yb = _unfused_bottleneck(unfused.train(), xb)
    assert torch.equal(ya, yb)
    g = torch.from_numpy(rs.normal(0, 1, ya.shape).astype(np.float32))
    ya.backward(g)
    yb.backward(g)
    assert torch.equal(xa.grad, xb.grad)
    for (name, p), q in zip(fused.named_parameters(),
                            unfused.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for (name, t), u in zip(fused.state_dict().items(),
                            unfused.state_dict().values()):
        assert torch.equal(t, u), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet50_eval_forward_is_unchanged(dtype, monkeypatch):
    """ResNet-50's eval forward (every endpoint, at 64x64) equals the one
    whose bottlenecks run the unfused composition, bit for bit."""
    rs = np.random.RandomState(5)
    model = resnet.ResNet50Base()
    calibrate_bn(model, torch.from_numpy(rs.uniform(
        -1, 1, (1, 64, 64, 3)).astype(np.float32)), rs)
    model = model.to(dtype).eval()
    x = torch.from_numpy(rs.uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)).to(dtype)
    with torch.no_grad():
        got = model(x)[1]
        monkeypatch.setattr(resnet.Bottleneck, "forward",
                            _unfused_bottleneck)
        want = model(x)[1]
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
