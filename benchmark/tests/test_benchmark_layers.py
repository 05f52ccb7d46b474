"""The reference's layers against the port's own ops on the CPU, in
float32: a 'VALID' conv against `models/backbones/layers.py::conv2d_tf`,
the 'VALID' 3x3/2 max pools of Inception-v4's stem and reductions against
`ops/pool.py::max_pool`, and the 'SAME' average pool with the padded zeros
counted against `ops/pool.py::avg_pool`; TF-Slim's average pool, which
counts only the window's elements inside the image, against a hand
divisor; a conv with a bias and no BatchNorm, whose numerics round the
conv's operands and not its bias."""

import pytest
import torch

from benchmark.reference import layers


def _x(shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("size,kernel,stride", [
    (299, (3, 3), 2), (147, (1, 7), 1), (73, (7, 1), 1), (35, (3, 3), 2),
    (17, (3, 1), 2)])
def test_valid_conv_matches_the_port(size, kernel, stride):
    from gvcnn_tf_tpu_torch.models.backbones.layers import conv2d_tf

    x = _x((2, 4, size, size + 2))
    w = _x((6, 4) + kernel, 1)
    got = layers.conv(x, w, stride, layers.Exact, padding="VALID")
    want = conv2d_tf(x, w, (stride, stride), "VALID")
    assert got.shape == want.shape
    assert got.shape[2:] == layers.out_hw(size, size + 2, kernel, stride,
                                          "VALID")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("size,out", [(147, 73), (71, 35), (35, 17)])
def test_valid_max_pool_matches_the_port(size, out):
    from gvcnn_tf_tpu_torch.ops import pool

    x = _x((2, 5, size, size))
    got = layers.max_pool(x, 3, 2, "VALID")
    assert got.shape[2:] == (out, out) == layers.out_hw(size, size, 3, 2,
                                                        "VALID")
    torch.testing.assert_close(got, pool.max_pool(x, (3, 3), (2, 2), "VALID"),
                               rtol=0, atol=0)


@pytest.mark.parametrize("size", [35, 17, 8])
def test_same_avg_pool_counting_the_pads_matches_the_port(size):
    from gvcnn_tf_tpu_torch.ops import pool

    x = _x((2, 5, size, size))
    got = layers.avg_pool(x, 3, 1, "SAME", count_include_pad=True)
    want = pool.avg_pool(x, (3, 3), (1, 1), "SAME")
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("at,inside", [
    ((0, 0), 4), ((0, 5), 6), ((5, 0), 6), ((5, 5), 9), ((16, 16), 4),
    ((16, 7), 6)])
def test_same_avg_pool_without_the_pads_divides_by_the_window_inside(
        at, inside):
    """At 17x17, a 3x3/1 window holds 4 elements inside the image at a
    corner, 6 on an edge and 9 in the middle."""
    x = _x((1, 3, 17, 17))
    got = layers.avg_pool(x, 3, 1, "SAME", count_include_pad=False)
    i, j = at
    window = x[:, :, max(i - 1, 0):i + 2, max(j - 1, 0):j + 2]
    assert window.shape[2] * window.shape[3] == inside
    torch.testing.assert_close(got[:, :, i, j], window.sum((2, 3)) / inside,
                               rtol=1e-6, atol=1e-7)
    padded = layers.avg_pool(x, 3, 1, "SAME", count_include_pad=True)
    torch.testing.assert_close(padded[:, :, i, j], window.sum((2, 3)) / 9,
                               rtol=1e-6, atol=1e-7)


def test_valid_avg_pool_is_the_same_under_both_conventions():
    x = _x((2, 3, 17, 17))
    a = layers.avg_pool(x, 3, 2, "VALID", count_include_pad=True)
    b = layers.avg_pool(x, 3, 2, "VALID", count_include_pad=False)
    assert a.shape[2:] == (8, 8)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_kernels_and_strides_as_pairs_or_ints():
    x = _x((1, 2, 9, 11))
    w = _x((3, 2, 3, 3), 1)
    torch.testing.assert_close(layers.conv(x, w, 2, layers.Exact),
                               layers.conv(x, w, (2, 2), layers.Exact),
                               rtol=0, atol=0)
    torch.testing.assert_close(layers.max_pool(x, 3, 2),
                               layers.max_pool(x, (3, 3), (2, 2)),
                               rtol=0, atol=0)
    assert layers.out_hw(9, 11, (1, 3), (2, 1), "VALID") == (5, 9)
    assert layers.out_hw(9, 11, 3, 2) == (5, 6)
    with pytest.raises(ValueError):
        layers.out_hw(2, 11, 3, 1, "VALID")
    with pytest.raises(ValueError):
        layers.max_pool(x, 3, 2, "FULL")


@pytest.mark.parametrize("num", [layers.Exact, layers.BF16, layers.FP8],
                         ids=lambda n: n.name)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_bias_rounds_the_operands_and_adds_the_float32_bias(num,
                                                                 padding):
    x, w, b = _x((2, 6, 9, 9)), _x((5, 6, 3, 3), 1), _x((5,), 2) * 0.1
    net = layers.Net({"up.conv.weight": w, "up.conv.bias": b}, "folded",
                     num, 1e-3)
    got = net.conv_bias(x, "up", padding=padding)
    bare = layers.conv(x, w, 1, num, padding=padding)
    assert got.shape[2:] == layers.out_hw(9, 9, 3, 1, padding)
    torch.testing.assert_close(got - bare, b.view(1, -1, 1, 1).expand_as(got),
                               rtol=0, atol=1e-6)
    if num is not layers.Exact:
        assert (bare - layers.conv(x, w, 1, layers.Exact,
                                   padding=padding)).abs().max() > 1e-3
