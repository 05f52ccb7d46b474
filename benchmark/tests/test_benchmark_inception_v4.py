"""The Inception-v4 reference (`benchmark/reference/inception_v4.py`) on the
CPU: its endpoint recompute changes nothing, bit for bit; its conv and
pool tables at 299 are the program's own shapes; its counted work; the
program's train-mode forward and gradients are its own in float64; and
the average pools' two readers.

Why float64 for the train mode: Inception-v4 is 75 convs deep with no
residual path, and train-mode BatchNorm over 6 images amplifies each
layer's rounding (about 1.7x an Inception block), so at 75x75 the
program's and the reference's float32 outputs each lie about 2% from the
float64 result at Mixed_7d, and from each other by as much, while in
float64 the two backbones agree to 1e-12 (the logits to 2e-7: the
program's head pools in float32)."""

import dataclasses
import hashlib
import json

import pytest
import torch

from benchmark import compare, counting, harness
from benchmark.inputs import make_views
from benchmark.reference import gvcnn as ref, inception_v4, layers
from benchmark.reference import train as ref_train
from benchmark.weights import make_weights

CONFIG = "mn40_12view_inception_v4"
SIDE = inception_v4.MIN_SIZE
# The 'VALID' max pools at 299x299: (endpoint, input H = W, output H = W,
# channels).
MAX_POOLS = [("Mixed_3a", 147, 73, 64), ("Mixed_5a", 71, 35, 192),
             ("Mixed_6a", 35, 17, 384), ("Mixed_7a", 17, 8, 1024)]


def _file():
    return harness.load_json(harness.HERE / "configs" / f"{CONFIG}.json")


def _tiny(dtype=torch.float32):
    """(model section, port config, weights, views, optimizer) at 75x75,
    B=2 of 3 views, float32 compute; weights in `dtype`."""
    from gvcnn_tf_tpu_torch import get_config

    file = _file()
    model = dict(file["model"], num_views=3, height=SIDE, width=SIDE,
                 compute_dtype="float32")
    cfg = get_config(file["port_config"])
    cfg = cfg.replace(compute_dtype="float32", data=dataclasses.replace(
        cfg.data, num_views=3, height=SIDE, width=SIDE, batch_size=2,
        num_classes=model["num_classes"]),
        train=dataclasses.replace(cfg.train, seed=11))
    w = make_weights(ref.param_spec(model), 123, "cpu")
    w = {k: v.to(dtype) for k, v in w.items()}
    views = make_views(torch.Generator().manual_seed(5),
                       (2, 3, SIDE, SIDE, 3), "cpu")
    return model, cfg, w, views, file["optimizer"]


def _trainable(model):
    return [k for k, (_, role) in ref.param_spec(model).items()
            if not role.startswith("bn_") or role == "bn_bias"]


def _train_and_rows(model, w, views, opt):
    labels = torch.tensor([3, 17])
    batches = [{"views": views, "label": labels}]
    out = ref_train.train(w, _trainable(model), batches, model, opt, 11,
                          layers.Exact)
    rows = ref_train.step_rows(w, batches[0], model, opt, 11, 0,
                               layers.Exact)
    return out, rows


def _no_checkpoint(fn, *args, use_reentrant):
    """`checkpoint` that keeps every activation: the endpoint run as is."""
    return fn(*args)


def test_recompute_is_bit_identical(monkeypatch):
    """One train step with every endpoint recomputed in the backward
    against the same step that keeps every activation: the same loss,
    gradients, parameters and rows, bit for bit."""
    model, _, w, views, opt = _tiny()
    got, rows = _train_and_rows(model, w, views, opt)
    monkeypatch.setattr(inception_v4, "checkpoint", _no_checkpoint)
    want, want_rows = _train_and_rows(model, w, views, opt)
    assert got["losses"] == want["losses"]
    for k in want["grads"]:
        assert torch.equal(got["grads"][k], want["grads"][k]), k
        assert torch.equal(got["params"][k], want["params"][k]), k
    for a, b in zip(got["steps"], want["steps"]):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    assert sorted(want_rows) == ["dlogits", "logits", "raw"]
    for k in want_rows:
        assert torch.equal(rows[k], want_rows[k]), k


def test_recompute_keeps_only_the_endpoints(monkeypatch):
    """With gradients on, the forward saves no tensor inside an endpoint:
    the graph's saved tensors are the endpoints' inputs, far fewer than
    without the recompute."""
    model, _, w, views, _ = _tiny()
    w = {k: v.requires_grad_(k.endswith(".weight")) for k, v in w.items()}
    x = ref.normalize(views).reshape(6, SIDE, SIDE, 3).permute(0, 3, 1, 2)
    net = layers.Net(w, "train", layers.Exact, inception_v4.BN_EPS)

    def saved():
        count = [0]

        def pack(t):
            count[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            inception_v4.forward(net, x, "Mixed_7d", ())
        return count[0]

    recomputed = saved()
    monkeypatch.setattr(inception_v4, "checkpoint", _no_checkpoint)
    assert recomputed * 20 < saved()


def _port_shapes(side):
    """(convs, pools) of the program's InceptionV4Base at side x side on
    the meta device: each ConvBN's parameter name, cin, cout, kernel,
    stride and output (h, w), and each pool's kind, kernel, stride,
    padding, channels, input and output (h, w), in call order."""
    from gvcnn_tf_tpu_torch.models.backbones import (
        inception_v4 as port_v4)
    from gvcnn_tf_tpu_torch.models.backbones.layers import ConvBN

    convs, pools = [], []
    net = port_v4.InceptionV4Base().to("meta")
    names = {m: n for n, m in net.named_modules()}

    def conv_hook(mod, args, out):
        w = mod.conv.weight
        convs.append((f"InceptionV4.{names[mod]}", w.shape[1], w.shape[0],
                      tuple(w.shape[2:]), tuple(mod.conv.stride),
                      tuple(out.shape[2:])))

    for m in net.modules():
        if isinstance(m, ConvBN):
            m.register_forward_hook(conv_hook)

    def recorded(kind, fn):
        def pool(x, kernel, strides, padding="SAME"):
            y = fn(x, kernel, strides, padding)
            pools.append((kind, tuple(kernel), tuple(strides), padding,
                          x.shape[1], tuple(x.shape[2:]),
                          tuple(y.shape[2:])))
            return y
        return pool

    saved = port_v4.avg_pool, port_v4.max_pool
    port_v4.avg_pool = recorded("avg", saved[0])
    port_v4.max_pool = recorded("max", saved[1])
    try:
        with torch.no_grad():
            net(torch.empty(1, side, side, 3, device="meta"))
    finally:
        port_v4.avg_pool, port_v4.max_pool = saved
    return convs, pools


def test_conv_and_pool_tables_are_the_programs_at_299():
    convs, pools = _port_shapes(299)
    table = inception_v4.conv_shapes("Mixed_7d", 299, 299)
    assert len(table) == len(convs) == 149
    assert [(c.name, c.cin, c.cout, c.kernel, c.stride, c.out)
            for c in table] == convs
    listed = inception_v4.pool_shapes("Mixed_7d", 299, 299)
    assert [(p.kind, p.kernel, p.stride, p.padding, p.channels, p.inp,
             p.out) for p in listed] == pools
    assert sum(p.kind == "avg" for p in listed) == 14
    assert [(p.endpoint, p.inp[0], p.out[0], p.channels) for p in listed
            if p.kind == "max"] == MAX_POOLS
    assert all(p.padding == "VALID" and p.kernel == (3, 3)
               and p.stride == (2, 2) for p in listed if p.kind == "max")
    assert {(p.inp, p.channels) for p in listed if p.kind == "avg"} == {
        ((35, 35), 384), ((17, 17), 1024), ((8, 8), 1536)}
    assert inception_v4.spatial("Mixed_5e", 299, 299) == (35, 35)
    assert inception_v4.spatial("Mixed_7d", 299, 299) == (8, 8)
    assert inception_v4.channels("Mixed_7d")["Mixed_7d"] == 1536


def test_the_smallest_input_reaches_mixed_7d():
    assert inception_v4.spatial("Mixed_7d", SIDE, SIDE) == (1, 1)
    with pytest.raises(ValueError):
        inception_v4.conv_shapes("Mixed_7d", SIDE - 1, SIDE - 1)


def test_counted_work_at_299():
    """24.50 GFLOP a view in the backbone's 149 convs, 24.63 with the
    scoring FCN at Mixed_5e and the head; a B=32 step 3x its forward,
    pinned with the parameter spec."""
    model = _file()["model"]
    backbone = sum(counting.conv_flops(c.cin, c.cout, c.kernel, c.out)
                   for c in inception_v4.conv_shapes("Mixed_7d", 299, 299))
    assert round(backbone / 1e9, 2) == 24.50
    per_view = counting.forward_flops(model, 1) / model["num_views"]
    assert round(per_view / 1e9, 2) == 24.63
    factored = sum(counting.conv_flops(c.cin, c.cout, c.kernel, c.out)
                   for c in inception_v4.conv_shapes("Mixed_7d", 299, 299)
                   if c.kernel[0] != c.kernel[1])
    assert round(factored / backbone, 2) == 0.42
    assert counting.train_step_flops(model, 32) == 28_368_718_258_176
    spec = ref.param_spec(model)
    rows = [[n, list(shape), role] for n, (shape, role) in spec.items()]
    assert len(spec) == 604
    assert hashlib.sha256(json.dumps(rows).encode()).hexdigest() == (
        "91169dba6b9698909eb81c4a695e57f0"
        "3fd7c33404a144f7ce2f9b4dbbd54e04")


def _float64_pair(monkeypatch):
    """The program's model and the reference at 75x75 in float64 (the
    program's `Logits` stays float32: its head pools in float32), with the
    same weights and the same dropout mask."""
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model

    monkeypatch.setattr(ref, "normalize", lambda v: v.to(
        torch.float64) / 255.0 * 2.0 - 1.0)
    model, cfg, w, views, opt = _tiny(torch.float64)
    m = build_model(cfg.replace(compute_dtype="float64")).double()
    m.Logits.float()
    m.load_state_dict(w, strict=True)
    m.train()
    keep = ref_train.dropout_keep(11, 0, (2, 1536), 0.8, "cpu")
    return model, m, w, views, opt, keep


def _program_forward(m, views):
    gen = torch.Generator().manual_seed(ref_train.dropout_seed(11, 0, 0))
    return m(views.double() / 255.0 * 2.0 - 1.0, generator=gen)


def test_train_forward_is_the_programs_in_float64(monkeypatch):
    """The train-mode forward with its dropout, program against
    reference."""
    model, m, w, views, _, keep = _float64_pair(monkeypatch)
    with torch.no_grad():
        lp, ep = _program_forward(m, views)
        lt, st = ref.forward(w, views, model, "train", layers.Exact, keep)
    assert (lp - lt).abs().max() <= 1e-5 * lt.abs().max()
    assert torch.allclose(ep["view_discrimination_scores"].double(), st,
                          atol=1e-6)


def test_train_gradients_are_the_programs_in_float64(monkeypatch):
    """The loss with its L2 term and every moving leaf's gradient, program
    (autograd through its train-mode modules) against reference."""
    model, m, w, views, opt, keep = _float64_pair(monkeypatch)
    labels = torch.tensor([3, 17])
    params = dict(m.named_parameters())
    lp, _ = _program_forward(m, views)
    l2 = sum(p.double().square().sum() for k, p in params.items()
             if k.endswith(".weight"))
    loss = (torch.nn.functional.cross_entropy(lp.double(), labels)
            + 0.5 * opt["weight_decay"] * l2)
    got = torch.autograd.grad(loss, list(params.values()))
    wr = {k: v.clone().requires_grad_(k in params) for k, v in w.items()}
    want_loss, _ = ref_train.loss(wr, views, labels, model, opt,
                                  layers.Exact, keep)
    want = torch.autograd.grad(want_loss, [wr[k] for k in params])
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()),
                                                 rel=1e-6)
    want = compare.leaf_norms(dict(zip(params, want)))
    leaves = compare.moving_leaves(want)
    assert len(leaves) > 250
    assert max(compare.leaf_gaps(compare.leaf_norms(dict(zip(params, got))),
                                 want, leaves)) < 1e-5


def test_average_pool_readers():
    """Both readers on canned records at the cell's sizes: the pools'
    device time a step, and their bound (3.90 ms at B=32) over it."""
    model = _file()["model"]
    kernels = {
        "void at::native::(anonymous namespace)::avg_pool2d_out_cuda_frame"
        "_nhwc<c10::BFloat16, float>": (140, 0.04),
        "void at::native::(anonymous namespace)::avg_pool2d_backward_out_"
        "cuda_frame_nhwc<c10::BFloat16, float>": (140, 0.06),
        "sm90_xmma_fprop_implicit_gemm_bf16bf16": (1490, 1.5)}
    records = {"kind": "train_stream", "model": model, "views_a_step": 384,
               "peaks": {"bfloat16": 989e12, "bytes": 3.35e12},
               "profile": {"steps": 10, "kernels": kernels}}
    ms = harness.reader("avgpool_ms_per_step.train").read(records)
    assert ms == pytest.approx(10.0)
    roof = harness.reader("avgpool_roofline.train")
    nbytes = roof.pool_bytes(model, 384)
    assert nbytes == 2 * 2 * 384 * (4 * 2 * 35 * 35 * 384
                                    + 7 * 2 * 17 * 17 * 1024
                                    + 3 * 2 * 8 * 8 * 1536)
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(3.8955, abs=1e-4)
    assert roof.read(records) == pytest.approx(100 * 3.8955 / 10.0,
                                               abs=1e-3)
    empty = dict(records, profile=dict(records["profile"], kernels={
        k: v for k, v in kernels.items() if "avg_pool" not in k}))
    for name in ("avgpool_ms_per_step.train", "avgpool_roofline.train"):
        assert harness.reader(name).read(empty) is None
        assert harness.reader(name).read(dict(records, profile=None)) is None
    v1 = harness.load_json(harness.HERE / "configs"
                           / "mn40_12view.json")["model"]
    assert roof.read(dict(records, model=v1)) is None
