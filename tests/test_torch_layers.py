"""TF-'SAME' layers of the port against Flax, at fp32 on the CPU, eval mode.

ConvBNReLU (7x7/2, 3x3/1, 1x1) with random kernels and non-trivial BN
statistics, and max_pool (3x3/2, 3x3/1, 2x2/2), at even and odd sizes.
Tolerance rtol 1e-5 / atol 1e-5 for the convs (one fp32 conv, summed in
another order); the pools are compared exactly (a max is exact).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gvcnn_tf_tpu.models.backbones.inception_v1 import (  # noqa: E402
    ConvBNReLU as JaxConvBNReLU,
)
from gvcnn_tf_tpu.ops.pool import max_pool as jax_max_pool  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import jax_to_state_dict  # noqa: E402
from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import (  # noqa: E402
    ConvBNReLU,
)
from gvcnn_tf_tpu_torch.ops.pool import max_pool, same_pads  # noqa: E402


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("size", [16, 17])
@pytest.mark.parametrize("cin,cout,k,s", [
    (3, 64, 7, 2),
    (8, 16, 3, 1),
    (8, 16, 1, 1),
    (8, 16, 3, 2),
])
def test_conv_bn_relu_matches_flax(cin, cout, k, s, size):
    rs = np.random.RandomState(size * 100 + k)
    x = rs.randn(2, size, size, cin).astype(np.float32)
    mod = JaxConvBNReLU(cout, (k, k), (s, s), dtype=jnp.float32)
    v = jax.device_get(mod.init(jax.random.key(0), jnp.asarray(x)))
    v["params"]["BatchNorm"]["bias"] = rs.randn(cout).astype(np.float32)
    v["batch_stats"]["BatchNorm"] = {
        "mean": rs.randn(cout).astype(np.float32),
        "var": rs.uniform(0.5, 2.0, cout).astype(np.float32),
    }
    want = np.asarray(mod.apply(v, jnp.asarray(x), train=False))

    port = ConvBNReLU(cin, cout, (k, k), (s, s)).eval()
    port.load_state_dict(jax_to_state_dict(v))
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [14, 15, 16, 17])
@pytest.mark.parametrize("k,s", [(3, 2), (3, 1), (2, 2)])
def test_max_pool_matches_flax(k, s, size):
    # Negative inputs: a padded -inf must never win, a zero pad would.
    x = -np.abs(np.random.RandomState(size).randn(2, size, size, 5)) - 1.0
    x = x.astype(np.float32)
    want = np.asarray(jax_max_pool(jnp.asarray(x), (k, k), (s, s), "SAME"))
    got = max_pool(_nchw(x), (k, k), (s, s)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_same_pads_at_224():
    assert same_pads(224, 7, 2) == (2, 3)       # the stem
    assert same_pads(112, 3, 2) == (0, 1)       # MaxPool_2a
    assert same_pads(28, 3, 1) == (1, 1)        # Mixed-block pools
    assert same_pads(14, 2, 2) == (0, 0)        # MaxPool_5a
    assert same_pads(30, 7, 2) == (2, 3)        # H % 4 == 2
    assert same_pads(31, 7, 2) == (3, 3)        # odd
