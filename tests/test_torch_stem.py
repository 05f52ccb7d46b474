"""The stem conv of the port (ops/stem_kernel.py) against the JAX package.

The plain version is held to the XLA conv (`stem_conv_reference`) and to
the Pallas kernel in interpret mode at bf16, rtol = atol = 0.05 (bf16
accumulation order, as tests/test_pallas_stem.py), and to
`lax.conv_general_dilated` with TF-'SAME' padding at fp32, rtol 1e-5.  The
CUDA kernel is held to the plain version on the card in
tests/test_torch_cuda_kernels.py.

The kernels' operand layouts are checked here, in plain PyTorch: the packed
(176, 64) weight times an A matrix read the way the bf16 kernel reads its
staged input rows (21 taps of a kernel row plus 3 past them, from element
6 ox of the padded row) equals the plain conv at fp32, and so does the
(168, 64) fp32 weight times an A matrix read the way the fp32 kernel reads
its staged rows (its tiles, strips and word offsets, mirrored from
csrc/stem_conv.cu).  The fp32 kernel's arithmetic, 3xTF32 (`tf32_rna`
splits, three products accumulated in fp32 k-step by k-step), is emulated
on that A matrix and held to `lax.conv_general_dilated` in fp32 at
precision HIGHEST within 1e-5 x max|ref|, the bound the card tests hold
the kernel to; a single TF32 product misses it.  The epilogue (eval-mode
BatchNorm + ReLU as scale and shift) is held to the JAX package's
`ConvBNReLU` at fp32, and the port's `Stem` to `PallasStem`'s math at bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
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
from gvcnn_tf_tpu_torch.ops import launched, stem_kernel  # noqa: E402
from gvcnn_tf_tpu_torch.ops.pool import same_pads  # noqa: E402
from gvcnn_tf_tpu_torch.ops.stem_kernel import (  # noqa: E402
    K_F32,
    K_PADDED,
    K_ROW,
    KERNEL_NAME,
    KERNEL_NAME_F32,
    kernel_name,
    pack_stem_weight,
    pack_stem_weight_f32,
    stem_conv,
    stem_conv_plain,
    tf32_rna,
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
    before = launched()
    got = stem_conv(torch.from_numpy(x), _oihw(k))
    assert launched() == before
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


# The fp32 kernel's tiling (csrc/stem_conv.cu, stem_conv7x7s2_f32): words
# before padded element 0 of a staged row, widest strip, m16 tile.
F_LEAD, F_MAX_STRIP = 2, 128


def _f32_strips(wo, max_strip=F_MAX_STRIP):
    """(strip width, strips, staged row words) as the launcher picks them."""
    strips = -(-wo // max_strip)
    sw = -(-wo // strips)
    if strips > 1:
        sw += sw & 1
        strips = -(-wo // sw)
    return sw, strips, (F_LEAD + 6 * sw + 18 + 3) & ~3


def _f32_tiles(n, ho, wo, band, max_strip=F_MAX_STRIP):
    """Each tile's (image, first output row, rows, first column, columns)."""
    sw, strips, _ = _f32_strips(wo, max_strip)
    for img in range(n):
        for oy0 in range(0, ho, band):
            for sx0 in range(0, sw * strips, sw):
                yield img, oy0, min(band, ho - oy0), sx0, min(sw, wo - sx0)


def _f32_koff(rsw):
    """Word offset of tap k = kh * 24 + m from a pixel's tap (0, 0): k-step
    3 kh + sub reads kernel row kh's staged row, words 8 sub .. 8 sub + 7."""
    k = torch.arange(K_F32)
    return (k // K_ROW) * rsw + k % K_ROW


def _f32_pixel_words(q, nc, rsw):
    """Word of tap (0, 0) of tile pixel q in the tile's staged rows."""
    r = q // nc
    return 2 * r * rsw + F_LEAD + 6 * (q - r * nc)


def _kernel_f32_a_operand(x, band=7, max_strip=F_MAX_STRIP):
    """(N, H, W, 3) -> (N, Ho, Wo, 168): the A matrix as the fp32 kernel
    reads it.  Each tile stages 2 band + 5 input rows of rsw words; word
    F_LEAD + f of a staged row is element 3 (2 sx0 - pad_left) + f of the
    input row (zero outside the image), and pixel q of the tile reads tap k
    at its tap (0, 0) word plus `_f32_koff`."""
    n, h, w, _ = x.shape
    ho, wo = -(-h // 2), -(-w // 2)
    top, left = same_pads(h, 7, 2)[0], same_pads(w, 7, 2)[0]
    _, _, rsw = _f32_strips(wo, max_strip)
    koff = _f32_koff(rsw)
    rows = x.reshape(n, h, 3 * w)
    a = x.new_full((n, ho, wo, K_F32), float("nan"))
    for img, oy0, nr, sx0, nc in _f32_tiles(n, ho, wo, band, max_strip):
        iy = torch.arange(2 * band + 5) + 2 * oy0 - top
        e = torch.arange(rsw) + 3 * (2 * sx0 - left) - F_LEAD
        ok = ((iy >= 0) & (iy < h))[:, None] & ((e >= 0) & (e < 3 * w))
        staged = rows[img][iy.clamp(0, h - 1)][:, e.clamp(0, 3 * w - 1)]
        staged = torch.where(ok, staged, 0.0).reshape(-1)
        q = torch.arange(nr * nc)
        words = _f32_pixel_words(q, nc, rsw)[:, None] + koff
        a[img, oy0:oy0 + nr, sx0:sx0 + nc] = staged[words].reshape(
            nr, nc, K_F32)
    return a


def _gemm_tf32(a, b, three=True):
    """a (..., 168) @ b (168, 64) as the fp32 kernel computes it: operands
    split into big = rna(v) and small = rna(v - big); per k-step of 8,
    small_a big_b, big_a small_b, big_a big_b added to the fp32
    accumulator in that order (three=False: big_a big_b alone, a single
    TF32 product)."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    sa, sb = tf32_rna(a - ab), tf32_rna(b - bb)
    acc = a.new_zeros(a.shape[:-1] + (b.shape[1],))
    for k0 in range(0, K_F32, 8):
        k = slice(k0, k0 + 8)
        if three:
            acc = acc + sa[..., k] @ bb[k]
            acc = acc + ab[..., k] @ sb[k]
        acc = acc + ab[..., k] @ bb[k]
    return acc


@pytest.mark.parametrize("n,h,w", [(2, 30, 30), (1, 31, 33), (8, 64, 64),
                                   (1, 18, 226)])
def test_packed_f32_layout_matches_plain_at_fp32(n, h, w):
    """The fp32 kernel's (168, 64) weight, row kh * 24 + 3 * kw + c with
    rows kh * 24 + 21..23 zero, times the A matrix read the way the kernel
    reads its staged rows (`_kernel_f32_a_operand`) is the plain conv: at
    the kernel's own bands and strips, and at narrow strips (a ragged last
    strip, odd strip starts in the padded row) and bands of 2 and 3."""
    x, k = _inputs(n, h, w, seed=h + 7 * w)
    xt, wt = torch.from_numpy(x), _oihw(k)
    packed = pack_stem_weight_f32(wt)
    assert packed.shape == (K_F32, 64) and packed.is_contiguous()
    zero_rows = [kh * K_ROW + m for kh in range(7) for m in range(21, 24)]
    assert not packed[zero_rows].any()
    taps = np.delete(np.arange(K_F32), zero_rows)
    np.testing.assert_array_equal(packed[taps].numpy(), k.reshape(147, 64))
    want = stem_conv_plain(xt, wt).numpy()
    for band, strip in ((7, F_MAX_STRIP), (2, 16), (3, 10)):
        a = _kernel_f32_a_operand(xt, band, strip)
        assert a.shape == (n, -(-h // 2), -(-w // 2), K_F32)
        assert not a.isnan().any()
        got = (a.double() @ packed.double()).float()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("w", [224, 226, 130])
def test_f32_fragment_loads_hit_32_banks(w):
    """Fragment row r of an m16 tile holds tile pixel 2 r (r < 8) or
    2 (r - 8) + 1, so one A load (lanes gid 0-7, tig 0-3, rows gid or
    gid + 8) reads 32 distinct banks wherever the m-tile lies in one output
    row (every m-tile of a 7-row band at W = 224); consecutive pixels
    (words 6 p + tig) would collide two by two."""
    wo = -(-w // 2)
    sw, _, rsw = _f32_strips(wo)
    gid, tig = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    npix = 7 * sw
    one_row = 0
    for m in range(npix // 16):
        for hh in range(2):
            q = 16 * m + 2 * gid + hh
            if (q // sw).min() != (q // sw).max():
                continue
            one_row += 1
            words = _f32_pixel_words(q, sw, rsw) + tig
            assert len(set((words % 32).ravel())) == 32, (m, hh)
        p = 16 * m + gid
        assert len(set(((6 * p + tig) % 32).ravel())) < 32
    # Only an m-tile across a row boundary (at most one a row) may collide.
    assert one_row >= 2 * (npix // 16 - (7 if sw % 16 else 0))


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e3, 1e30])
def test_tf32_rna_keeps_10_bits_to_nearest(scale):
    """rna(x) has its low 13 bits zero and lies within half a TF32 ulp,
    2^-11 |x|, of x; its neighbours one TF32 ulp either side are no
    nearer; x - rna(x) and rna of that rebuild x within 2^-22 |x|."""
    rs = np.random.RandomState(int(np.log10(scale) + 40))
    x = torch.from_numpy((rs.randn(4096) * scale).astype(np.float32))
    r = tf32_rna(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - r.double()).abs()
    assert (err <= 2.0 ** -11 * x.double().abs()).all()
    ulp = (r.view(torch.int32) + 0x2000).view(torch.float32).double() - (
        r.double())
    for side in (r.double() + ulp, r.double() - ulp):
        assert (err <= (x.double() - side).abs()).all()
    small = tf32_rna(x - r)
    rebuilt = r.double() + small.double()
    assert ((rebuilt - x.double()).abs() <= 2.0 ** -22 * x.double().abs()
            ).all()


def test_tf32_rna_ties_round_away_from_zero():
    """A value halfway between two TF32 numbers (bit 12 set, bits 0-11
    clear) rounds up in magnitude, on both signs; just under halfway
    rounds down."""
    bits = torch.tensor([1.0, 1.5, 3.0e-5, 7.0e20]).view(torch.int32)
    bits = bits & ~0x1FFF                           # TF32 numbers
    base = bits.view(torch.float32)
    for sign in (1.0, -1.0):
        tie = (bits | 0x1000).view(torch.float32) * sign
        under = (bits | 0x0FFF).view(torch.float32) * sign
        up = (bits + 0x2000).view(torch.float32) * sign
        torch.testing.assert_close(tf32_rna(tie), up, rtol=0, atol=0)
        torch.testing.assert_close(tf32_rna(under), base * sign, rtol=0,
                                   atol=0)
        torch.testing.assert_close(tf32_rna(base * sign), base * sign,
                                   rtol=0, atol=0)


def _lax_conv_fp32(x, k):
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), window_strides=(2, 2),
        padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=lax.Precision.HIGHEST))


@pytest.mark.parametrize("n,h,w", [(2, 30, 30), (1, 31, 33), (1, 18, 226)])
@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_3xtf32_matches_lax_conv_at_fp32(n, h, w, scale):
    """The fp32 kernel's arithmetic (3xTF32 on its A operand and packed
    weight, k-step by k-step) within 1e-5 x max|ref| of the fp32 XLA conv:
    the card tests' bound for the kernel against cuDNN's fp32 conv."""
    x, k = _inputs(n, h, w, seed=3 * h + w)
    x = (x * scale).astype(np.float32)
    ref = _lax_conv_fp32(x, k)
    a = _kernel_f32_a_operand(torch.from_numpy(x))
    got = _gemm_tf32(a, pack_stem_weight_f32(_oihw(k))).numpy()
    err = np.abs(got - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err / np.abs(ref).max()


@pytest.mark.parametrize("n,h,w", [(2, 30, 30), (1, 18, 226)])
def test_single_tf32_product_misses_the_fp32_bound(n, h, w):
    """One TF32 product (what cuDNN's TF32 convs and a kernel without the
    split compute) misses 1e-5 x max|ref| by more than 5x, so the bound
    tells 3xTF32 from TF32."""
    x, k = _inputs(n, h, w, seed=3 * h + w)
    ref = _lax_conv_fp32(x, k)
    a = _kernel_f32_a_operand(torch.from_numpy(x))
    got = _gemm_tf32(a, pack_stem_weight_f32(_oihw(k)), three=False).numpy()
    assert np.abs(got - ref).max() > 5e-5 * np.abs(ref).max()


def test_dtype_picks_the_kernel_and_anything_else_raises():
    """bf16 goes to the bf16 kernel, fp32 to the 3xTF32 one; any
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
        assert stem_kernel._packed_weight(w).shape == (K_F32, 64)
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


@pytest.mark.parametrize("variant", ["kernel", "one_product", "no_mma",
                                     "band_4", "int_rna_a"])
def test_stem_probe_edits_apply_to_the_kernel_source(variant):
    """`measure.py stem-probe` builds its variants by editing
    csrc/stem_conv.cu; every edit must still match the source, and the
    MMA variants keep 6, 2 and 0 of the fp32 kernel's MMA calls."""
    from pathlib import Path

    from gvcnn_tf_tpu_torch.tools.measure import stem_probe_sources

    src = (Path(stem_kernel.__file__).resolve().parent.parent / "csrc"
           / "stem_conv.cu").read_text()
    text = stem_probe_sources(src)[variant]
    assert (text == src) == (variant == "kernel")
    mmas = {"one_product": 2, "no_mma": 0}.get(variant, 6)
    assert text.count("mma_tf32(acc") == mmas
