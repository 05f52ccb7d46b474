"""Inception-ResNet-v2 in the port (`models/backbones/inception_resnet_v2.py`,
`layers.ConvBias`, `ops/residual_join.py`) on the CPU, against the
benchmark's plain reference (`benchmark/reference/inception_resnet_v2.py`,
which imports only torch) rather than the JAX package, which has no such
backbone.

- Shapes at 299 on the meta device: every endpoint, 244 convs (40 with a
  bias and no BatchNorm), 54.2 M conv weights, the conv, pool and join
  tables equal to the reference's, and the state-dict names equal to the
  reference's parameter spec.
- GVCNN at 75x75, B = 2, 3 views, float32, on seeded random weights
  (`benchmark.weights.make_weights`): train-mode logits, loss and
  gradients and eval-mode logits against the reference, and the gradients
  again in float64.
- The join op's plain route: gradcheck in float64 with and without the
  ReLU, its rounding in bfloat16, `torch.library.opcheck`, and the L2 term
  leaving the up convs' biases out.
- `fold_batch_norm` leaves the up convs alone; the port config resolves
  ("Repeat", "Conv2d_7b_1x1"); the join readers on canned records.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

import torch.nn as nn  # noqa: E402

from benchmark import compare, harness  # noqa: E402
from benchmark.inputs import make_views  # noqa: E402
from benchmark.reference import gvcnn as ref  # noqa: E402
from benchmark.reference import inception_resnet_v2 as ref_irv2  # noqa: E402
from benchmark.reference import layers as ref_layers  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from benchmark.weights import make_weights  # noqa: E402
from gvcnn_tf_tpu_torch import get_config  # noqa: E402
from gvcnn_tf_tpu_torch.models.backbones import get_backbone  # noqa: E402
from gvcnn_tf_tpu_torch.models.backbones import (  # noqa: E402
    inception_resnet_v2 as port_irv2,
    inception_v4,
)
from gvcnn_tf_tpu_torch.models.backbones.layers import (  # noqa: E402
    ConvBias,
    ConvBN,
)
from gvcnn_tf_tpu_torch.models.gvcnn import build_model  # noqa: E402
from gvcnn_tf_tpu_torch.ops import batch_norm_kernel as bk  # noqa: E402
from gvcnn_tf_tpu_torch.ops import residual_join as rj  # noqa: E402
from gvcnn_tf_tpu_torch.train import kernel_params  # noqa: E402
from gvcnn_tf_tpu_torch.utils import fold_batch_norm  # noqa: E402

CONFIG = "mn40_12view_inception_resnet_v2"
FINAL = "Conv2d_7b_1x1"
SIDE = ref_irv2.MIN_SIZE
# (endpoint, channels, H = W) at 299x299: slim's shapes, and `Repeat`.
ENDPOINTS_299 = [
    ("Conv2d_1a_3x3", 32, 149), ("Conv2d_2a_3x3", 32, 147),
    ("Conv2d_2b_3x3", 64, 147), ("MaxPool_3a_3x3", 64, 73),
    ("Conv2d_3b_1x1", 80, 73), ("Conv2d_4a_3x3", 192, 71),
    ("MaxPool_5a_3x3", 192, 35), ("Mixed_5b", 320, 35), ("Repeat", 320, 35),
    ("Mixed_6a", 1088, 17), ("PreAuxLogits", 1088, 17),
    ("Mixed_7a", 2080, 8), ("Conv2d_7b_1x1", 1536, 8)]


def _file():
    return harness.load_json(harness.HERE / "configs" / f"{CONFIG}.json")


def _port_tables(side):
    """(convs, pools, joins) of the port's backbone at side x side on the
    meta device, in call order: each conv's parameter name, cin, cout,
    kernel, stride, output (h, w) and whether a BatchNorm follows; each
    pool's kind, kernel, stride, padding, channels, input and output (h,
    w); each join's block name, channels, (h, w), scale and ReLU."""
    convs, pools, joins = [], [], []
    net = port_irv2.InceptionResNetV2Base().to("meta")
    names = {m: n for n, m in net.named_modules()}

    def conv_hook(mod, args, out):
        w = mod.conv.weight
        convs.append((f"InceptionResnetV2.{names[mod]}", w.shape[1],
                      w.shape[0], tuple(w.shape[2:]),
                      tuple(mod.conv.stride), tuple(out.shape[2:]),
                      isinstance(mod, ConvBN)))

    def join_hook(mod, args, out):
        joins.append((names[mod].rsplit(".", 1)[0], out.shape[1],
                      tuple(out.shape[2:])))

    for m in net.modules():
        if isinstance(m, (ConvBN, ConvBias)):
            m.register_forward_hook(conv_hook)
        if isinstance(m, ConvBias):
            m.register_forward_hook(join_hook)

    def recorded(kind, fn):
        def pool(x, kernel, strides, padding="SAME"):
            y = fn(x, kernel, strides, padding)
            pools.append((kind, tuple(kernel), tuple(strides), padding,
                          x.shape[1], tuple(x.shape[2:]),
                          tuple(y.shape[2:])))
            return y
        return pool

    # The backbone's pools are inception_v4's `avg_pool3` and
    # `reduce_pool`, which call that module's `avg_pool` and `max_pool`.
    real = inception_v4.avg_pool, inception_v4.max_pool
    inception_v4.avg_pool = recorded("avg", real[0])
    inception_v4.max_pool = recorded("max", real[1])
    try:
        with torch.no_grad():
            net(torch.empty(1, side, side, 3, device="meta"))
    finally:
        inception_v4.avg_pool, inception_v4.max_pool = real
    scales = {names[m]: (m.scale, m.relu) for m in net.modules()
              if isinstance(m, port_irv2.Residual)}
    joins = [(b, c, hw) + scales[b] for b, c, hw in joins]
    return convs, pools, joins


def test_endpoints_and_counts_at_299():
    """Every endpoint's shape, and 244 convs of which 40 have a bias and no
    BatchNorm, 54.2 M conv weights."""
    net = get_backbone("inception_resnet_v2")().to("meta")
    with torch.no_grad():
        feats, ends = net(torch.empty(2, 299, 299, 3, device="meta"))
    assert [(k, v.shape[1], v.shape[2]) for k, v in ends.items()] == \
        ENDPOINTS_299
    assert all(v.shape[0] == 2 and v.shape[2] == v.shape[3]
               for v in ends.values())
    assert feats.shape == (2, 1536, 8, 8)
    assert net.DESCRIPTOR_DIM == 1536
    convs = [m for m in net.modules() if isinstance(m, nn.Conv2d)]
    biased = [m for m in net.modules() if isinstance(m, ConvBias)]
    assert len(convs) == 244 and len(biased) == 40
    assert all(m.conv.bias is not None for m in biased)
    assert sum(isinstance(m, ConvBN) for m in net.modules()) == 204
    weights = sum(m.weight.numel() for m in convs)
    assert round(weights / 1e6, 1) == 54.2
    with pytest.raises(ValueError):
        get_backbone("inception_resnet_v2")("Mixed_6b")
    cut = get_backbone("inception_resnet_v2")("Repeat")
    assert not any(k.startswith(("Mixed_6a", "Repeat_1"))
                   for k in cut.state_dict())


def test_tables_are_the_references_at_299():
    """The port's convs (names, widths, kernels, strides, output sizes and
    whether a BatchNorm follows), pools and joins (channels, size, scale,
    ReLU) at 299 are the reference's tables, in order."""
    convs, pools, joins = _port_tables(299)
    table = ref_irv2.conv_shapes(FINAL, 299, 299)
    assert [(c.name, c.cin, c.cout, c.kernel, c.stride, c.out, c.bn)
            for c in table] == convs
    listed = ref_irv2.pool_shapes(FINAL, 299, 299)
    assert [(p.kind, p.kernel, p.stride, p.padding, p.channels, p.inp,
             p.out) for p in listed] == pools
    assert [(p.inp[0], p.out[0], p.channels) for p in listed
            if p.kind == "max"] == [(147, 73, 64), (71, 35, 192),
                                    (35, 17, 320), (17, 8, 1088)]
    js = ref_irv2.join_shapes(FINAL, 299, 299)
    assert [(f"{j.name}", j.channels, j.hw, j.scale, j.relu)
            for j in js] == joins
    assert [j.name for j in js][:2] == ["Repeat.block35_1",
                                        "Repeat.block35_2"]
    assert js[-1] == ref_irv2.JoinShape("Block8", 2080, (8, 8), 1.0, False)
    per_image = sum(j.channels * j.hw[0] * j.hw[1] for j in js)
    assert per_image == 10 * 35 * 35 * 320 + 20 * 17 * 17 * 1088 \
        + 10 * 8 * 8 * 2080 == 11_539_840
    assert ref_irv2.spatial("Repeat", 299, 299) == (35, 35)
    assert ref_irv2.spatial(FINAL, SIDE, SIDE) == (1, 1)
    with pytest.raises(ValueError):
        ref_irv2.conv_shapes(FINAL, SIDE - 1, SIDE - 1)


def test_state_dict_names_are_the_reference_spec():
    """The port's parameter and statistic names and shapes are the
    reference's `param_spec` (the benchmark loads with strict=True)."""
    model = _file()["model"]
    spec = ref.param_spec(model)
    with torch.device("meta"):
        m = build_model(get_config(CONFIG))
    sd = m.state_dict()
    assert set(sd) == set(spec)
    assert all(tuple(sd[k].shape) == tuple(shape)
               for k, (shape, _) in spec.items())
    assert spec["InceptionResnetV2.Repeat.block35_1.Conv2d_1x1.conv.bias"] \
        == ((320,), "bias")
    assert sum(role == "bias" and ".conv.bias" in k
               for k, (_, role) in spec.items()) == 40


def test_port_config_resolves_its_endpoints():
    cfg = get_config(CONFIG)
    with torch.device("meta"):
        m = build_model(cfg)
    assert (m.raw_endpoint, m.final_endpoint) == ("Repeat", FINAL)
    assert type(m.backbone) is port_irv2.InceptionResNetV2Base
    f = _file()["model"]
    assert (cfg.backbone, cfg.raw_endpoint, cfg.final_endpoint) == (
        f["backbone"], f["raw_endpoint"], f["final_endpoint"])


def _tiny(dtype=torch.float32, seed=123):
    """(model section, port model, weights, views, optimizer) at 75x75,
    B=2 of 3 views, compute in `dtype`, seeded random weights."""
    file = _file()
    model = dict(file["model"], num_views=3, height=SIDE, width=SIDE,
                 compute_dtype="float32")
    base = get_config(CONFIG)
    cfg = base.replace(compute_dtype="float32", data=dataclasses.replace(
        base.data, num_views=3, height=SIDE, width=SIDE, batch_size=2,
        num_classes=model["num_classes"]),
        train=dataclasses.replace(base.train, seed=11))
    w = make_weights(ref.param_spec(model), seed, "cpu")
    w = {k: v.to(dtype) for k, v in w.items()}
    views = make_views(torch.Generator().manual_seed(5),
                       (2, 3, SIDE, SIDE, 3), "cpu")
    m = build_model(cfg.replace(compute_dtype=str(dtype).split(".")[1]))
    if dtype != torch.float32:
        m = m.to(dtype)
        m.Logits.float()            # the program's head pools in float32
    m.load_state_dict(w, strict=True)
    return model, m, w, views, file["optimizer"]


def _program_logits(m, views, dtype=torch.float32):
    gen = torch.Generator().manual_seed(ref_train.dropout_seed(11, 0, 0))
    return m(views.to(dtype) / 255.0 * 2.0 - 1.0, generator=gen)[0]


def _loss_and_grads(m, views, labels, opt):
    params = dict(m.named_parameters())
    logits = _program_logits(m, views, next(iter(params.values())).dtype)
    l2 = sum(p.double().square().sum() for p in kernel_params(
        params.items()))
    loss = (nn.functional.cross_entropy(logits.double(), labels)
            + 0.5 * opt["weight_decay"] * l2)
    return logits, loss, dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


def _reference(w, views, labels, model, opt, keep, trainable):
    wr = {k: v.clone().requires_grad_(k in trainable) for k, v in w.items()}
    loss, logits = ref_train.loss(wr, views, labels, model, opt,
                                  ref_layers.Exact, keep)
    grads = torch.autograd.grad(loss, [wr[k] for k in trainable])
    return logits.detach(), loss.detach(), dict(zip(trainable, grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_train_mode_is_the_references(dtype, monkeypatch):
    """Train-mode logits (with the same dropout mask), the loss with its L2
    term and every moving leaf's gradient, port against reference.

    float32: logits within 1e-4 of the largest, the loss within rtol 1e-4
    and each leaf's gradient norm within 3% of its own or the median
    leaf's.  At 75x75 Mixed_7a and the block8s are 1x1, so their
    train-mode BatchNorms normalize over 6 values a channel, which
    magnifies each side's fp32 rounding (conv sums in other orders, the
    port's join rounding u + b apart from the conv): the leaves read
    0.12-0.80% apart on two seeds, the logits 4e-5, the loss 1.5e-5.
    float64: the same with the backbones' rounding gone: the logits within
    1e-6 of the largest and the loss within rtol 1e-6 (the program's
    `Logits` stays float32, as its head pools there: 2.4e-7 apart), every
    leaf within 1e-5."""
    if dtype == torch.float64:
        monkeypatch.setattr(ref, "normalize", lambda v: v.to(
            torch.float64) / 255.0 * 2.0 - 1.0)
    model, m, w, views, opt = _tiny(dtype)
    m.train()
    labels = torch.tensor([3, 17])
    keep = ref_train.dropout_keep(11, 0, (2, 1536), 0.8, "cpu")
    logits, loss, got = _loss_and_grads(m, views, labels, opt)
    want_logits, want_loss, want = _reference(w, views, labels, model, opt,
                                              keep, list(got))
    tight = dtype == torch.float64
    top = want_logits.abs().max()
    assert (logits.double() - want_logits.double()).abs().max() <= (
        (1e-6 if tight else 1e-4) * top)
    assert float(loss.detach()) == pytest.approx(
        float(want_loss), rel=1e-6 if tight else 1e-4)
    want = compare.leaf_norms(want)
    leaves = compare.moving_leaves(want)
    assert len(leaves) > 450
    gaps = compare.leaf_gaps(compare.leaf_norms(got), want, leaves)
    assert max(gaps) < (1e-5 if tight else 3e-2)


def test_eval_mode_is_the_references():
    """Eval-mode logits within 1e-5 of the largest (measured 5.5e-7: no
    batch statistics, so nothing magnifies the fp32 rounding), and the
    views' scores within 1e-6."""
    model, m, w, views, _ = _tiny()
    with torch.no_grad():
        lp, ep = m.eval()(views.float() / 255.0 * 2.0 - 1.0)
        lr, sr = ref.forward(w, views, model, "eval", ref_layers.Exact)
    assert (lp - lr).abs().max() <= 1e-5 * lr.abs().max()
    assert torch.allclose(ep["view_discrimination_scores"], sr, atol=1e-6)


def test_fold_batch_norm_leaves_the_up_convs():
    """`fold_batch_norm` folds the 204 conv + BatchNorm layers and leaves
    the 40 up convs' weights and biases as they were; eval logits before
    and after agree within fp32 rounding (1e-5 of the largest), and equal
    the reference's folded forward as closely."""
    model, m, w, views, _ = _tiny()
    ups = {n: (mod.conv.weight.clone(), mod.conv.bias.clone())
           for n, mod in m.named_modules() if isinstance(mod, ConvBias)}
    assert len(ups) == 40
    x = views.float() / 255.0 * 2.0 - 1.0
    with torch.no_grad():
        before, _ = m.eval()(x)
        fold_batch_norm(m)
        after, _ = m(x)
        folded, _ = ref.forward(w, views, model, "folded", ref_layers.Exact)
    for n, mod in m.named_modules():
        if isinstance(mod, ConvBias):
            assert torch.equal(mod.conv.weight, ups[n][0])
            assert torch.equal(mod.conv.bias, ups[n][1])
    top = before.abs().max()
    assert (after - before).abs().max() <= 1e-5 * top
    assert (after - folded).abs().max() <= 1e-5 * top


def test_l2_term_leaves_the_biases_out():
    """The L2 term's kernels (`train.kernel_params`, `*.weight`) hold every
    conv weight and no conv bias; the reference's L2 covers the same."""
    with torch.device("meta"):
        m = build_model(get_config(CONFIG))
    params = dict(m.named_parameters())
    kernels = {id(p) for p in kernel_params(params.items())}
    ups = [mod for mod in m.modules() if isinstance(mod, ConvBias)]
    assert len(ups) == 40
    assert all(id(mod.conv.bias) not in kernels
               and id(mod.conv.weight) in kernels for mod in ups)
    named = {n for n, p in params.items() if id(p) in kernels}
    spec = ref.param_spec(_file()["model"])
    assert named == {k for k in spec if k.endswith(".weight")}


@pytest.mark.parametrize("relu", [True, False])
def test_join_gradcheck(relu):
    """The op's registered gradient against finite differences of its plain
    route, float64."""
    g = torch.Generator().manual_seed(3)
    x, u = (torch.randn(2, 16, 3, 5, generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    b = torch.randn(16, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, u, b: rj.residual_join(x, u, b, 0.17, relu), (x, u, b))


@pytest.mark.parametrize("relu", [True, False])
def test_join_rounds_as_written(relu):
    """In bfloat16 the op is relu?(x + s (u + b)) in fp32 rounded once, and
    its gradients are autograd's through that expression: dx and du in
    bfloat16, dbias the fp32 sum of s dx."""
    g = torch.Generator().manual_seed(4)
    x, u = (torch.randn(3, 24, 4, 6, generator=g).to(torch.bfloat16)
            .requires_grad_() for _ in range(2))
    b = torch.randn(24, generator=g).requires_grad_()
    dy = torch.randn(3, 24, 4, 6, generator=g).to(torch.bfloat16)
    y = rj.residual_join(x, u, b, 0.1, relu)
    v = (x.float() + 0.1 * (u.float() + b[:, None, None])).to(torch.bfloat16)
    want = torch.relu(v) if relu else v
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)
    got = torch.autograd.grad(y, (x, u, b), dy)
    xw, uw, bw = (t.detach().clone().requires_grad_() for t in (x, u, b))
    vw = xw.float() + 0.1 * (uw.float() + bw[:, None, None])
    yw = (torch.relu(vw) if relu else vw).to(torch.bfloat16)
    want = torch.autograd.grad(yw, (xw, uw, bw), dy)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-6)
    if relu:
        assert (got[0][y == 0] == 0).all()
    else:
        assert got[0] is dy or torch.equal(got[0], dy)


def test_join_opcheck():
    """`torch.library.opcheck` of both ops on CPU tensors: schema, fake,
    autograd registration."""
    g = torch.Generator().manual_seed(5)
    x, u = (torch.randn(2, 8, 3, 3, generator=g) for _ in range(2))
    b = torch.randn(8, generator=g)
    for relu in (True, False):
        torch.library.opcheck(torch.ops.gvcnn.residual_join,
                              (x.requires_grad_(), u.requires_grad_(),
                               b.requires_grad_(), 0.2, relu))
        y = rj.residual_join(x, u, b, 0.2, relu).detach()
        torch.library.opcheck(torch.ops.gvcnn.residual_join_backward,
                              (torch.randn_like(y), y if relu else None,
                               0.2, relu))


def test_join_plan_covers_the_cells_shapes():
    """The backward takes train-mode BatchNorm's plan at its own blocks an
    SM: at the three joins of a B = 32 step on 132 SMs, 16-byte vectors,
    tiles covering C, chunks covering the rows, and up to BLOCKS_AN_SM
    blocks an SM where the rows allow it."""
    for (c, hw) in ((320, 35), (1088, 17), (2080, 8)):
        rows = 384 * hw * hw
        p = rj.plan(rows, c, 8, 132, rj.BLOCKS_AN_SM)
        assert rj.plan is bk.plan
        assert p.tiles * p.tile_vectors >= c // 8
        assert (p.tiles - 1) * p.tile_vectors < c // 8
        assert p.chunks * p.chunk_rows >= rows
        assert (p.chunks - 1) * p.chunk_rows < rows
        assert p.tile_vectors <= bk.MAX_TILE_VECTORS
        assert p.chunks * p.tiles <= rj.BLOCKS_AN_SM * 132 + p.tiles
        assert p.chunks >= bk.plan(rows, c, 8, 132).chunks


def test_join_readers():
    """Both readers on canned records at the cell's sizes: the joins'
    device time a step (kernels named `residual_join`), and their bound
    (6 bf16 passes over 4.431 G elements: 53.18 GB, 15.87 ms at 3.35 TB/s)
    over it; nothing where no such kernel ran."""
    model = _file()["model"]
    kernels = {
        "void (anonymous namespace)::residual_join_fwd<__nv_bfloat16, 8>("
        "__nv_bfloat16 const*)": (400, 0.07),
        "void (anonymous namespace)::residual_join_bwd<__nv_bfloat16, 8>("
        "__nv_bfloat16 const*)": (400, 0.11),
        "(anonymous namespace)::residual_join_bias_grad_kernel(float "
        "const*, float*, int, int)": (400, 0.02),
        "sm90_xmma_fprop_implicit_gemm_bf16bf16": (2440, 1.5)}
    records = {"kind": "train_stream", "model": model, "views_a_step": 384,
               "peaks": {"bfloat16": 989e12, "bytes": 3.35e12},
               "profile": {"steps": 10, "kernels": kernels}}
    ms = harness.reader("join_ms_per_step.train").read(records)
    assert ms == pytest.approx(20.0)
    roof = harness.reader("join_roofline.train")
    nbytes = roof.join_bytes(model, 384)
    assert nbytes == 6 * 2 * 384 * 11_539_840
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(15.873, abs=1e-3)
    assert roof.read(records) == pytest.approx(100 * 15.8733 / 20.0,
                                               abs=1e-2)
    empty = dict(records, profile=dict(records["profile"], kernels={
        "sm90_xmma_fprop_implicit_gemm_bf16bf16": (2440, 1.5)}))
    assert harness.reader("join_ms_per_step.train").read(empty) is None
    assert roof.read(empty) is None
    v4 = dict(model, backbone="inception_v4", raw_endpoint="Mixed_5e",
              final_endpoint="Mixed_7d")
    assert roof.join_bytes(v4, 384) == 0
    assert roof.read(dict(records, model=v4)) is None


def test_conv_bias_leaves_its_bias_to_the_join():
    """`ConvBias` is the conv without its bias and hands the bias over in
    fp32, also after `cast_convs_` made it bf16; a residual block adds it
    in the join: relu?(x + scale * (conv(m) + b)), within fp32 rounding
    (1e-5 of the largest) of the same sum written out with the conv's own
    bias."""
    torch.manual_seed(7)
    up = ConvBias(8, 8, (1, 1))
    nn.init.normal_(up.conv.bias)
    m = torch.randn(2, 8, 5, 5)
    assert torch.equal(up(m), torch.nn.functional.conv2d(m, up.conv.weight))
    assert up.bias.dtype == torch.float32
    assert torch.equal(up.bias, up.conv.bias)
    block = port_irv2.Residual(320, port_irv2.BLOCK35, 0.17).eval()
    nn.init.normal_(block.Conv2d_1x1.conv.bias)
    x = torch.randn(2, 320, 5, 5)
    with torch.no_grad():
        mixed = port_irv2.Towers.forward(block, x)
        conv = block.Conv2d_1x1.conv
        want = torch.relu(x + 0.17 * torch.nn.functional.conv2d(
            mixed, conv.weight, conv.bias))
        got = block(x)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    half = ConvBias(8, 8, (1, 1)).to(torch.bfloat16)
    assert half.bias.dtype == torch.float32


def test_avgpool_readers_count_mixed_5b():
    """The average-pool readers read this cell too: its one pool, Mixed_5b's
    3x3/1 'SAME' pool at 35x35x192, is the whole bound (forward x read and
    y written, backward dy read and dx written: 4 bf16 passes, 0.724 GB,
    0.216 ms at 3.35 TB/s a B = 32 step)."""
    model = _file()["model"]
    kernels = {
        "void (anonymous namespace)::avg_pool_same_fwd<__nv_bfloat16>("
        "__nv_bfloat16 const*)": (10, 0.0015),
        "void (anonymous namespace)::avg_pool_same_bwd<__nv_bfloat16>("
        "__nv_bfloat16 const*)": (10, 0.0015),
        "sm90_xmma_fprop_implicit_gemm_bf16bf16": (2440, 1.5)}
    records = {"kind": "train_stream", "model": model, "views_a_step": 384,
               "peaks": {"bfloat16": 989e12, "bytes": 3.35e12},
               "profile": {"steps": 10, "kernels": kernels}}
    ms = harness.reader("avgpool_ms_per_step.train").read(records)
    assert ms == pytest.approx(0.3)
    roof = harness.reader("avgpool_roofline.train")
    nbytes = roof.pool_bytes(model, 384)
    assert nbytes == 2 * 2 * 384 * 192 * 2 * 35 * 35
    assert roof.read(records) == pytest.approx(
        100 * nbytes / 3.35e12 / 0.3e-3)
    assert roof.read(records) < 100
