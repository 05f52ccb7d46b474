"""The port's Inception-v2/v3/v4 and ResNet-50 backbones against the JAX
package's, on the CPU at fp32.

- Every endpoint of each backbone, in eval mode, B = 2, at a small size
  where it exists: ResNet-50 and v2 at 48x48, v3 at 80x80, v4 at 107x107,
  the least size at which v4's Mixed_7 blocks see 2x2 pixels (from 75 to
  106 they see one, their 1x3 and 3x1 convs only their centre taps, and
  the fp32 rounding gap doubles a block, to 2.4e-4 of max at Mixed_7d at
  80x80).  Weights are drawn in the port (numpy, seeded), BatchNorm
  biases and ResNet's scales randomized, and each BatchNorm's statistics
  calibrated to its input in one port forward: running mean 0 and running
  var the input's mean square, floored at the layer average, so every
  layer scales and shifts and activations stay O(1) with no subtraction
  to cancel (`tests/test_torch_gvcnn.py`'s tenth of the mean, over v4's
  ~150 layers, grew the gap to 1.2e-4 at Mixed_7d).  The same weights go
  to JAX through the bridge; one jitted forward per backbone.  Tolerance:
  max|diff| <= 1e-4 x max|ref| per endpoint (fp32 summed in another order
  by XLA:CPU and oneDNN; the worst reading is 5.5e-5, v4's Mixed_7d).
- (The blocks one at a time, in eval and train mode:
  `tests/test_torch_backbone_blocks.py`.)
- The bridge round trip, JAX -> port -> JAX, exact for every backbone; the
  parameter trees equal `jax.eval_shape` of the JAX init.
- BatchNorm folding: port-folded equals JAX-folded (rtol 1e-6) and folded
  equals unfolded (1e-4 of max) for ResNet (gamma, eps 1e-5) and v2 (the
  separable stem's pointwise conv).
- Endpoint shapes at 224 and 299 on the `meta` device, against
  `tests/test_backbones_swap.py`'s tables; the registry's names.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gvcnn_tf_tpu.models.backbones import (  # noqa: E402
    get_backbone as jax_get_backbone,
)
from gvcnn_tf_tpu.utils.fold_bn import (  # noqa: E402
    fold_batch_norm as jax_fold_batch_norm,
)
from gvcnn_tf_tpu_torch.bridge import (  # noqa: E402
    jax_to_state_dict,
    state_dict_to_jax,
)
from gvcnn_tf_tpu_torch.models.backbones import (  # noqa: E402
    BACKBONES,
    get_backbone,
)
from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import (  # noqa: E402
    Stem,
)
from gvcnn_tf_tpu_torch.models.backbones.layers import (  # noqa: E402
    BatchNorm,
)
from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv_plain  # noqa: E402
from gvcnn_tf_tpu_torch.utils import fold_batch_norm  # noqa: E402

# The JAX package's backbones (`gvcnn_tf_tpu.models.backbones.get_backbone`
# registers them lazily), and the one the port has beside them.
JAX_BACKBONES = ("inception_v1", "inception_v2", "inception_v3",
                 "inception_v4", "resnet50")
PORT_ONLY_BACKBONES = {"inception_resnet_v2"}

NEW = ("inception_v2", "inception_v3", "inception_v4", "resnet50")
SIZE = {"inception_v2": 48, "inception_v3": 80, "inception_v4": 107,
        "resnet50": 48}
REL = 1e-4


def assert_close_rel(got, want, rel=REL, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{msg}: {err} > {rel} x {scale}"


@torch.no_grad()
def randomize(module, rs):
    """Seeded weights: conv kernels normal with variance 2 / fan_in, BN
    biases N(0, 0.1), BN scales U(0.5, 1.5)."""
    for name, p in module.named_parameters():
        if name.endswith("weight"):
            std = (2.0 / p[0].numel()) ** 0.5
            a = rs.normal(0, std, p.shape)
        elif name.endswith("scale"):
            a = rs.uniform(0.5, 1.5, p.shape)
        else:
            a = rs.normal(0, 0.1, p.shape)
        p.copy_(torch.from_numpy(a.astype(np.float32)))


@torch.no_grad()
def calibrate_bn(model, x, rs):
    """Random weights, then each BatchNorm's running statistics from its
    input, layer after layer, in one forward pass: mean 0, var the mean
    square, floored at the layer's average."""
    randomize(model, rs)
    handles = []

    def hook(bn, args):
        y = args[0].float()
        sq = y.square().mean(dim=(0, 2, 3))
        bn.running_mean.zero_()
        bn.running_var.copy_(sq + sq.mean())

    def stem_hook(stem, args):
        y = stem_conv_plain(args[0], stem.conv.weight)
        hook(stem.BatchNorm, (y.permute(0, 3, 1, 2),))

    for m in model.modules():
        if isinstance(m, BatchNorm):
            handles.append(m.register_forward_pre_hook(hook))
        elif isinstance(m, Stem):
            handles.append(m.register_forward_pre_hook(stem_hook))
    model.eval()(x)
    for h in handles:
        h.remove()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


_PAIRS = {}


def backbone_pair(name):
    """(JAX endpoints, port endpoints, port model, input) of `name` at its
    size, from one calibrated port model; one jitted JAX forward."""
    if name not in _PAIRS:
        rs = np.random.RandomState(len(name))
        hw = SIZE[name]
        x = rs.uniform(-1, 1, (2, hw, hw, 3)).astype(np.float32)
        port = get_backbone(name)()
        calibrate_bn(port, torch.from_numpy(x), rs)
        with torch.no_grad():
            _, peps = port(torch.from_numpy(x))
        jm = jax_get_backbone(name)(dtype=jnp.float32)
        v = state_dict_to_jax(port.state_dict())
        _, jeps = jax.jit(functools.partial(jm.apply, train=False))(v, x)
        _PAIRS[name] = (jax.device_get(jeps),
                        {k: _nhwc(t) for k, t in peps.items()}, port, x)
    return _PAIRS[name]


@pytest.mark.parametrize("name", NEW)
def test_every_endpoint_matches_jax(name):
    jeps, peps, port, _ = backbone_pair(name)
    assert list(peps) == list(port.ENDPOINTS) == list(
        jax_get_backbone(name).ENDPOINTS)
    assert set(jeps) == set(peps)
    for k in port.ENDPOINTS:
        assert_close_rel(peps[k], jeps[k], msg=f"{name} {k}")


@pytest.mark.parametrize("name", NEW)
def test_bridge_round_trip_is_exact(name):
    """JAX tree (from `jax.eval_shape` of the JAX init, filled with seeded
    values) -> port state_dict -> JAX tree, bit for bit; the port model
    takes the state_dict strictly."""
    hw = SIZE[name]
    jm = jax_get_backbone(name)(dtype=jnp.float32)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.key(0),
                            jax.ShapeDtypeStruct((1, hw, hw, 3), jnp.float32))
    rs = np.random.RandomState(3)
    tree = jax.tree.map(lambda s: rs.randn(*s.shape).astype(np.float32),
                        shapes)
    port = get_backbone(name)()
    port.load_state_dict(jax_to_state_dict(tree), strict=True)
    back = state_dict_to_jax(port.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a, err_msg=str(path))


@pytest.mark.parametrize("name", ["resnet50", "inception_v2"])
def test_fold_matches_jax_and_the_unfolded_model(name):
    _, peps, port, x = backbone_pair(name)
    root = jax_get_backbone(name).NAME
    want = jax_fold_batch_norm(state_dict_to_jax(
        {f"{root}.{k}": v for k, v in port.state_dict().items()}))
    folded = get_backbone(name)().eval()
    folded.load_state_dict(port.state_dict())
    fold_batch_norm(folded)
    got = {f"{root}.{k}": v for k, v in folded.state_dict().items()}
    want = jax_to_state_dict(jax.device_get(want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    if name == "resnet50":
        assert all(torch.equal(m.scale, torch.ones_like(m.scale))
                   for m in folded.modules() if isinstance(m, BatchNorm))
    with torch.no_grad():
        _, feps = folded(torch.from_numpy(x))
    for k, t in feps.items():
        assert_close_rel(_nhwc(t), peps[k], msg=k)


def _shapes(name, hw):
    with torch.device("meta"):
        _, eps = get_backbone(name)().eval()(torch.empty(1, hw, hw, 3))
    return {k: (1,) + tuple(t.shape[2:]) + (t.shape[1],)
            for k, t in eps.items()}


# tests/test_backbones_swap.py's tables (NHWC), and the channels of every
# endpoint against the class's ENDPOINT_CHANNELS.
SHAPES = [
    ("inception_v4", 299, {"Mixed_3a": (1, 73, 73, 160),
                           "Mixed_4a": (1, 71, 71, 192),
                           "Mixed_5a": (1, 35, 35, 384),
                           "Mixed_5e": (1, 35, 35, 384),
                           "Mixed_6a": (1, 17, 17, 1024),
                           "Mixed_6h": (1, 17, 17, 1024),
                           "Mixed_7a": (1, 8, 8, 1536),
                           "Mixed_7d": (1, 8, 8, 1536)}),
    ("inception_v4", 224, {"Mixed_7d": (1, 5, 5, 1536)}),
    ("resnet50", 224, {"conv1": (1, 56, 56, 64), "block1": (1, 28, 28, 256),
                       "block2": (1, 14, 14, 512),
                       "block3": (1, 7, 7, 1024),
                       "block4": (1, 7, 7, 2048)}),
    ("inception_v2", 224, {"Conv2d_1a_7x7": (1, 112, 112, 64),
                           "MaxPool_3a_3x3": (1, 28, 28, 192),
                           "Mixed_3b": (1, 28, 28, 256),
                           "Mixed_3c": (1, 28, 28, 320),
                           "Mixed_4a": (1, 14, 14, 576),
                           "Mixed_4e": (1, 14, 14, 576),
                           "Mixed_5a": (1, 7, 7, 1024),
                           "Mixed_5c": (1, 7, 7, 1024)}),
    ("inception_v3", 299, {"Conv2d_1a_3x3": (1, 149, 149, 32),
                           "MaxPool_5a_3x3": (1, 35, 35, 192),
                           "Mixed_5b": (1, 35, 35, 256),
                           "Mixed_5d": (1, 35, 35, 288),
                           "Mixed_6a": (1, 17, 17, 768),
                           "Mixed_6e": (1, 17, 17, 768),
                           "Mixed_7a": (1, 8, 8, 1280),
                           "Mixed_7c": (1, 8, 8, 2048)}),
    ("inception_v3", 224, {"Mixed_7c": (1, 5, 5, 2048)}),
    ("resnet50", 299, {"block4": (1, 10, 10, 2048)}),
    ("inception_v2", 299, {"Mixed_5c": (1, 10, 10, 1024)}),
]


@pytest.mark.parametrize("name,hw,want", SHAPES)
def test_endpoint_shapes_on_meta(name, hw, want):
    got = _shapes(name, hw)
    cls = get_backbone(name)
    assert list(got) == list(cls.ENDPOINTS)
    assert {k: v[-1] for k, v in got.items()} == cls.ENDPOINT_CHANNELS
    for k, shape in want.items():
        assert got[k] == shape, k
    assert got[cls.DEFAULT_FINAL_ENDPOINT][-1] == cls.DESCRIPTOR_DIM


def test_registry_names_and_truncation():
    # The port's registry is the JAX package's backbones and one the port
    # alone has; the JAX package registers lazily, so its names are listed.
    assert set(BACKBONES) == set(JAX_BACKBONES) | PORT_ONLY_BACKBONES
    for name in PORT_ONLY_BACKBONES:
        with pytest.raises(KeyError):
            jax_get_backbone(name)
    for name in JAX_BACKBONES:
        cls, jcls = BACKBONES[name], jax_get_backbone(name)
        assert cls.NAME == getattr(jcls, "NAME", "InceptionV1")
        assert cls.ENDPOINTS == tuple(jcls.ENDPOINTS)
        for attr in ("DEFAULT_RAW_ENDPOINT", "DEFAULT_FINAL_ENDPOINT",
                     "DESCRIPTOR_DIM"):
            assert getattr(cls, attr) == getattr(jcls, attr), (name, attr)
    with pytest.raises(KeyError):
        get_backbone("vgg16")
    with pytest.raises(ValueError):
        get_backbone("resnet50")("Mixed_5c")
    cut = get_backbone("inception_v4")("Mixed_5e")
    assert not any(k.startswith("Mixed_6") for k in cut.state_dict())
    cut = get_backbone("resnet50")("block2")
    assert not any(k.startswith("block3") for k in cut.state_dict())
