"""Inception-v4's pools in the port (`ops/pool.py`).

On the CPU, at Inception-v4's sizes at 299x299: the 3x3/1 'SAME' average
pools of its A, B and C blocks (35, 17 and 8 squared) are the mean over a
window of the input padded with zeros that count (Flax's `avg_pool`), and
its four 'VALID' 3x3/2 max pools (Mixed_3a 147 -> 73 at 64 channels,
Mixed_5a 71 -> 35 at 192, Mixed_6a 35 -> 17 at 384, Mixed_7a 17 -> 8 at
1024) pad nothing and give `F.max_pool2d` and its gradient.

On the card, the same four max pools through the hand-written kernels
(`csrc/max_pool.cu`) at 384 images in bf16 and fp32: the forward equal to
`F.max_pool2d` with indices bit for bit, its record the window slot of
those indices; the gather backward equal to autograd's through
`F.max_pool2d` where an input wins one window, within one bf16 ulp (fp32:
1e-6 relative) where it wins two, summed in another order.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from gvcnn_tf_tpu_torch.ops import launched, pool  # noqa: E402
from gvcnn_tf_tpu_torch.ops import pool_kernel as pk  # noqa: E402

# (pool, input H = W, channels) of the 'VALID' 3x3/2 max pools at 299x299.
VALID_POOLS = [("Mixed_3a", 147, 64), ("Mixed_5a", 71, 192),
               ("Mixed_6a", 35, 384), ("Mixed_7a", 17, 1024)]
# (blocks, H = W, channels) of the 3x3/1 'SAME' average pools at 299x299.
AVG_POOLS = [("Mixed_5b-5e", 35, 384), ("Mixed_6b-6h", 17, 1024),
             ("Mixed_7b-7d", 8, 1536)]
IMAGES = 384


@pytest.mark.parametrize("blocks,h,c", AVG_POOLS)
def test_average_pool_counts_the_padded_zeros(blocks, h, c):
    """Each output is the sum of its 3x3 window of x padded by one zero on
    every side, over 9, at the border too."""
    x = torch.randn(2, c, h, h)
    got = pool.avg_pool(x, (3, 3), (1, 1), "SAME")
    padded = F.pad(x, (1, 1, 1, 1))
    want = sum(padded[:, :, i:i + h, j:j + h]
               for i in range(3) for j in range(3)) / 9
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    corner = x[:, :, :2, :2].sum((2, 3)) / 9
    torch.testing.assert_close(got[:, :, 0, 0], corner, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name,h,c", VALID_POOLS)
def test_valid_pool_on_the_cpu_is_max_pool2d(name, h, c):
    """'VALID' pads nothing: floor((h - 3) / 2) + 1 outputs a side, the
    values and the gradient of `F.max_pool2d(x, 3, 2)`."""
    x = torch.randn(2, c, h, h)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    assert pool._pads(x, (3, 3), (2, 2), "VALID") == ((0, 0), (0, 0))
    y = pool.max_pool(xa, (3, 3), (2, 2), "VALID")
    want = F.max_pool2d(xb, 3, 2)
    assert y.shape[2:] == ((h - 3) // 2 + 1,) * 2
    assert torch.equal(y, want)
    dy = torch.randn_like(y)
    y.backward(dy)
    want.backward(dy)
    assert torch.equal(xa.grad, xb.grad)


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


def _bf16_ulp(t):
    """Spacing of bf16 numbers at |t| (t float32)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _draw(shape, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device)
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


VALID = ((3, 3), (2, 2), ((0, 0), (0, 0)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,h,c", VALID_POOLS)
def test_valid_pool_forward_is_max_pool2d_with_indices(cuda, name, h, c,
                                                       dtype):
    """The forward kernel with its record at 384 images: `F.max_pool2d`'s
    values bit for bit, and the record the window slot of its indices
    (bf16 draws hold ties; both credit the first maximum)."""
    x = _draw((IMAGES, c, h, h), dtype, h + c, cuda)
    before = launched("max_pool_same_fwd")
    with torch.no_grad():
        y, slot = pk._forward(x, *VALID, True)
        want, idx = F.max_pool2d(x, 3, 2, return_indices=True)
    torch.cuda.synchronize()
    assert launched("max_pool_same_fwd") == before + 1
    ho = (h - 3) // 2 + 1
    assert y.shape == (IMAGES, c, ho, ho)
    assert torch.equal(y, want)
    rows = torch.arange(ho, device=cuda).view(ho, 1)
    cols = torch.arange(ho, device=cuda).view(1, ho)
    taps = (idx // h - 2 * rows) * 3 + (idx % h - 2 * cols)
    assert torch.equal(slot.long(), taps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,h,c", VALID_POOLS)
def test_valid_pool_backward_is_max_pool2d_backward(cuda, name, h, c, dtype):
    """The pool's op at 384 images against autograd through
    `F.max_pool2d` (its indices' backward): dx bit-equal where an input
    wins one window or none, within one bf16 ulp (fp32: 1e-6 relative)
    where it wins two; the backward kernel launches once."""
    x = _draw((IMAGES, c, h, h), dtype, h + c + 1, cuda)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = launched("max_pool_same_bwd")
    y = pk.max_pool_same(xa, *VALID)
    dy = _draw(tuple(y.shape), dtype, 5, cuda)
    y.backward(dy)
    want_y, idx = F.max_pool2d(xb, 3, 2, return_indices=True)
    want_y.backward(dy)
    torch.cuda.synchronize()
    assert launched("max_pool_same_bwd") == before + 1
    wins = torch.zeros(IMAGES, c, h * h, device=cuda)
    wins.scatter_add_(2, idx.flatten(2), torch.ones_like(
        idx, dtype=torch.float32).flatten(2))
    once = wins.view(IMAGES, c, h, h) <= 1
    got, want = xa.grad.float(), xb.grad.float()
    assert torch.equal(got[once], want[once])
    if dtype == torch.bfloat16:
        assert bool(((got - want).abs() <= _bf16_ulp(want)).all())
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
