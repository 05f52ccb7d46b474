"""The stem conv of the port (ops/stem_kernel.py) against the JAX package.

The plain version is held to the XLA conv (`stem_conv_reference`) and to
the Pallas kernel in interpret mode at bf16, rtol = atol = 0.05 (bf16
accumulation order, as tests/test_pallas_stem.py), and to
`lax.conv_general_dilated` with TF-'SAME' padding at fp32, rtol 1e-5.  The
CUDA kernel is held to the plain version on the card in
tests/test_torch_cuda_kernels.py.

The kernel's operand layout is checked here, in plain PyTorch: the packed
(176, 64) weight times an A matrix read the way the kernel reads its staged
input rows (21 taps of a kernel row plus 3 past them, from element 6 ox of
the padded row) equals the plain conv at fp32.  The epilogue (eval-mode
BatchNorm + ReLU as scale and shift) is held to the JAX package's
`ConvBNReLU` at fp32, and the port's `Stem` to `PallasStem`'s math at bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import flax.linen as flax_nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from jax import lax  # noqa: E402

from gvcnn_tf_tpu.models.backbones.inception_v1 import (  # noqa: E402
    ConvBNReLU as JaxConvBNReLU,
)
from gvcnn_tf_tpu.ops.pallas_stem import (  # noqa: E402
    _stem_fwd,
    stem_conv_reference,
)
from gvcnn_tf_tpu_torch.bridge import jax_to_state_dict  # noqa: E402
from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import (  # noqa: E402
    Stem,
)
from gvcnn_tf_tpu_torch.ops import stem_kernel  # noqa: E402
from gvcnn_tf_tpu_torch.ops.pool import same_pads  # noqa: E402
from gvcnn_tf_tpu_torch.ops.stem_kernel import (  # noqa: E402
    K_PADDED,
    K_ROW,
    KERNEL_NAME,
    KERNEL_NAME_F32,
    kernel_name,
    pack_stem_weight,
    pack_stem_weight_f32,
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


def _kernel_a_operand(x):
    """(N, H, W, 3) -> (N, Ho, Wo, 176): the A matrix as the CUDA kernel
    reads it.  Staged row kh of output row oy is padded input row
    2 oy + kh, flattened to 3 (2 Wo + 6) elements; pixel ox reads the 24
    elements from 6 ox (the 21 taps of kernel row kh and 3 past them, which
    meet zero weights); K = 7 x 24 = 168, then 8 zero columns."""
    n, h, w, _ = x.shape
    ho, wo = -(-h // 2), -(-w // 2)
    top, left = same_pads(h, 7, 2)[0], same_pads(w, 7, 2)[0]
    xp = F.pad(x, (0, 0, left, 2 * wo + 6 - w - left,
                   top, 2 * ho + 5 - h - top))
    flat = xp.reshape(n, 2 * ho + 5, 3 * (2 * wo + 6))
    rows = [flat[:, kh:kh + 2 * ho:2].unfold(2, K_ROW, 6)
            for kh in range(7)]                       # (N, Ho, Wo, 24) each
    a = torch.cat(rows, dim=-1)
    return F.pad(a, (0, K_PADDED - 7 * K_ROW))


@pytest.mark.parametrize("n,h,w", [(2, 32, 32), (2, 30, 30), (1, 31, 33),
                                   (3, 8, 130), (1, 224, 224)])
def test_packed_layout_matches_plain_at_fp32(n, h, w):
    x, k = _inputs(n, h, w, seed=h * w)
    xt, wt = torch.from_numpy(x), _oihw(k)
    packed = pack_stem_weight(wt)
    assert packed.shape == (K_PADDED, 64)
    zero_rows = [kh * K_ROW + m for kh in range(7) for m in range(21, 24)]
    zero_rows += list(range(7 * K_ROW, K_PADDED))
    assert not packed[zero_rows].any()
    a = _kernel_a_operand(xt)
    assert a.shape == (n, -(-h // 2), -(-w // 2), K_PADDED)
    got = (a.double() @ packed.double()).float()
    want = stem_conv_plain(xt, wt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,h,w", [(2, 30, 30), (1, 31, 33), (8, 64, 64)])
def test_packed_f32_layout_matches_plain_at_fp32(n, h, w):
    """The fp32 kernel's (147, 64) weight, row (kh * 7 + kw) * 3 + c, times
    the im2col of the TF-'SAME'-padded input in that order, is the plain
    conv."""
    x, k = _inputs(n, h, w, seed=h + 7 * w)
    xt, wt = torch.from_numpy(x), _oihw(k)
    packed = pack_stem_weight_f32(wt)
    assert packed.shape == (147, 64) and packed.is_contiguous()
    np.testing.assert_array_equal(packed.numpy(), k.reshape(147, 64))
    ho, wo = -(-h // 2), -(-w // 2)
    top, left = same_pads(h, 7, 2)[0], same_pads(w, 7, 2)[0]
    xp = F.pad(xt, (0, 0, left, 2 * wo + 5 - w - left,
                    top, 2 * ho + 5 - h - top))
    cols = xp.unfold(1, 7, 2).unfold(2, 7, 2)        # (N, Ho, Wo, 3, 7, 7)
    a = cols.permute(0, 1, 2, 4, 5, 3).reshape(n, ho, wo, 147)
    got = (a.double() @ packed.double()).float()
    np.testing.assert_allclose(got.numpy(), stem_conv_plain(xt, wt).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_dtype_picks_the_kernel_and_anything_else_raises():
    """bf16 goes to the tensor-core kernel, fp32 to the CUDA-core one; any
    other dtype, or a weight of another dtype than x, raises before a
    launch (the checks a CUDA tensor meets, run here on CPU tensors)."""
    assert kernel_name(torch.bfloat16) == KERNEL_NAME
    assert kernel_name(torch.float32) == KERNEL_NAME_F32
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bfloat16.*float32"):
            kernel_name(bad)
    x = torch.zeros((1, 16, 16, 3))
    w = torch.zeros((64, 3, 7, 7))
    check = stem_kernel._check_cuda_args
    assert check(x, w, None, None) == KERNEL_NAME_F32
    assert check(x.bfloat16(), w.bfloat16(), None, None) == KERNEL_NAME
    with pytest.raises(TypeError):
        check(x.half(), w.half(), None, None)
    with pytest.raises(TypeError, match="like x"):
        check(x, w.bfloat16(), None, None)
    with pytest.raises(ValueError, match="scale and shift"):
        check(x, w, torch.ones(64), None)


def test_packed_weight_cache_keeps_one_layout_per_dtype():
    w = torch.randn(64, 3, 7, 7)
    with torch.no_grad():
        assert stem_kernel._packed_weight(w).shape == (147, 64)
        wb = w.bfloat16()
        assert stem_kernel._packed_weight(wb).shape == (K_PADDED, 64)
        assert stem_kernel._packed_weight(w) is stem_kernel._packed_weight(w)


def _bn_variables(rs, k):
    return {
        "params": {"conv": {"kernel": k},
                   "BatchNorm": {"bias": rs.randn(64).astype(np.float32)}},
        "batch_stats": {"BatchNorm": {
            "mean": rs.randn(64).astype(np.float32),
            "var": rs.uniform(0.25, 4.0, 64).astype(np.float32)}},
    }


def _stem_from(v):
    port = Stem().eval()
    port.load_state_dict(jax_to_state_dict(v))
    return port


@pytest.mark.parametrize("h,w", [(32, 32), (30, 30), (31, 33)])
def test_plain_epilogue_matches_jax_conv_bn_relu_at_fp32(h, w):
    x, k = _inputs(2, h, w, seed=7 * h + w)
    v = _bn_variables(np.random.RandomState(h + w), k)
    mod = JaxConvBNReLU(64, (7, 7), (2, 2), dtype=jnp.float32)
    want = np.asarray(mod.apply(v, jnp.asarray(x), train=False))

    port = _stem_from(v)
    with torch.no_grad():
        scale, shift = port.BatchNorm.scale_shift()
        got = stem_conv_plain(torch.from_numpy(x), port.conv.weight, scale,
                              shift, relu=True).numpy()
        module = port(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(module, got)
    assert (got == 0).any() and (got > 0).any()    # the ReLU did work


@pytest.mark.parametrize("h,w", [(32, 32), (64, 32)])
def test_stem_module_matches_pallas_stem_math_at_bf16(h, w):
    """PallasStem (inception_v1.py): the Pallas conv (interpret mode here),
    then Flax BatchNorm and ReLU in bf16."""
    x, k = _inputs(2, h, w, seed=h + 3 * w)
    v = _bn_variables(np.random.RandomState(h * w), k)
    bn = flax_nn.BatchNorm(use_running_average=True, epsilon=0.001,
                           dtype=jnp.bfloat16, param_dtype=jnp.float32,
                           use_scale=False)
    y = _stem_fwd(jnp.asarray(x), jnp.asarray(k), interpret=True)
    want = flax_nn.relu(bn.apply(
        {"params": v["params"]["BatchNorm"],
         "batch_stats": v["batch_stats"]["BatchNorm"]},
        y.astype(jnp.bfloat16)))
    want = np.asarray(want, np.float32)

    port = _stem_from(v)
    port.conv.to(torch.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16()).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == want.shape == (2, h // 2, w // 2, 64)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def test_stem_refuses_training_mode():
    """In training mode the stem refuses its eval-only epilogue: the conv
    runs alone through the autograd Function, then BatchNorm with the
    batch's statistics and the ReLU, as JAX's ConvBNReLU(train=True)."""
    x, k = _inputs(2, 16, 16, seed=11)
    v = _bn_variables(np.random.RandomState(11), k)
    mod = JaxConvBNReLU(64, (7, 7), (2, 2), dtype=jnp.float32)
    want, upd = mod.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    port = _stem_from(v).train()
    got = port(torch.from_numpy(x))
    assert got.grad_fn is not None
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.BatchNorm.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["BatchNorm"]
                                          ["var"]), rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="training mode"):
        port.BatchNorm.scale_shift()
    one = torch.ones(64)
    with pytest.raises(NotImplementedError, match="eval-only"):
        stem_conv(torch.from_numpy(x), port.conv.weight, one, one, relu=True)


def test_packed_weight_is_kept_until_the_weight_changes():
    _, k = _inputs(1, 8, 8)
    w = _oihw(k).bfloat16()              # the bf16 kernel's layout
    with torch.no_grad():
        first = stem_kernel._packed_weight(w)
        assert stem_kernel._packed_weight(w) is first
        w.mul_(2.0)                                  # bumps its version
        again = stem_kernel._packed_weight(w)
    assert again is not first
    torch.testing.assert_close(again, pack_stem_weight(w), rtol=0, atol=0)
    torch.testing.assert_close(again, 2.0 * first, rtol=0, atol=0)
    assert stem_kernel._packed_weight(w) is not again   # grad mode: fresh


def test_scale_shift_follows_the_statistics():
    bn = Stem().eval().BatchNorm
    rs = np.random.RandomState(5)
    with torch.no_grad():
        bn.bias.copy_(torch.from_numpy(rs.randn(64).astype(np.float32)))
        first = bn.scale_shift()
        assert bn.scale_shift() is first
        bn.running_var.fill_(3.0)
        bn.running_mean.fill_(0.5)
        scale, shift = bn.scale_shift()
    want_scale = torch.full((64,), 3.0 + bn.eps).rsqrt()
    torch.testing.assert_close(scale, want_scale)
    torch.testing.assert_close(shift, bn.bias.detach() - 0.5 * want_scale)
    y = torch.from_numpy(rs.randn(2, 64, 3, 3).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(
            bn(y), y * scale[:, None, None] + shift[:, None, None],
            rtol=1e-6, atol=1e-6)
