"""The stem conv of the port (ops/stem_kernel.py) against the JAX package.

The plain version is held to the XLA conv (`stem_conv_reference`) and to
the Pallas kernel in interpret mode at bf16, rtol = atol = 0.05 (bf16
accumulation order, as tests/test_pallas_stem.py), and to
`lax.conv_general_dilated` with TF-'SAME' padding at fp32, rtol 1e-5.  The
CUDA kernel is held to the plain version on the card in
tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from gvcnn_tf_tpu.ops.pallas_stem import (  # noqa: E402
    _stem_fwd,
    stem_conv_reference,
)
from gvcnn_tf_tpu_torch.ops import stem_kernel  # noqa: E402
from gvcnn_tf_tpu_torch.ops.stem_kernel import (  # noqa: E402
    stem_conv,
    stem_conv_plain,
)


def _inputs(n, h, w, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, h, w, 3).astype(np.float32)
    k = (rs.randn(7, 7, 3, 64) * 0.1).astype(np.float32)   # HWIO
    return x, k


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("h,w", [(32, 32), (64, 32)])
def test_plain_matches_jax_at_bf16(h, w):
    x, k = _inputs(2, h, w)
    got = stem_conv_plain(torch.from_numpy(x).bfloat16(),
                          _oihw(k).bfloat16()).float().numpy()
    for ref in (stem_conv_reference(jnp.asarray(x), jnp.asarray(k)),
                _stem_fwd(jnp.asarray(x), jnp.asarray(k), interpret=True)):
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape == (2, h // 2, w // 2, 64)
        np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("h,w", [(32, 32), (30, 30), (31, 33), (224, 224)])
def test_plain_matches_lax_conv_at_fp32(h, w):
    x, k = _inputs(1, h, w, seed=h + w)
    ref = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), window_strides=(2, 2),
        padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=lax.Precision.HIGHEST)
    got = stem_conv_plain(torch.from_numpy(x), _oihw(k)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_runs_the_plain_version():
    x, k = _inputs(1, 16, 16)
    before = stem_conv.launches
    got = stem_conv(torch.from_numpy(x), _oihw(k))
    assert stem_conv.launches == before
    torch.testing.assert_close(got, stem_conv_plain(torch.from_numpy(x),
                                                    _oihw(k)))


def test_wrapper_source_names_the_tpu_kernel():
    assert "pallas_stem.py::_stem_fwd" in stem_kernel.__doc__
