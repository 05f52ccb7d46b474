"""The plain reference against the program on the CPU at B=2, 3 views of
max(64, the backbone's MIN_SIZE) squared, in float32: the eval-mode and
folded forwards, the train-mode forward with its dropout, and one train
step's loss and gradients, for every configuration file."""

import dataclasses

import pytest
import torch

from benchmark import compare, harness
from benchmark.reference import gvcnn as ref, layers, train as ref_train
from benchmark.inputs import make_views
from benchmark.tests import tiny
from benchmark.weights import make_weights

CONFIGS = sorted(p.stem for p in (harness.HERE / "configs").glob("*.json"))


def _setup(name):
    from gvcnn_tf_tpu_torch import get_config

    file = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    side = tiny.size(file["model"])
    model = dict(file["model"], num_views=3, height=side, width=side,
                 compute_dtype="float32")
    cfg = get_config(file["port_config"])
    cfg = cfg.replace(compute_dtype="float32", data=dataclasses.replace(
        cfg.data, num_views=3, height=side, width=side, batch_size=2,
        num_classes=model["num_classes"]),
        train=dataclasses.replace(cfg.train, seed=11))
    w = make_weights(ref.param_spec(model), 123, "cpu")
    views = make_views(torch.Generator().manual_seed(5),
                       (2, 3, side, side, 3), "cpu")
    return cfg, model, w, views, file["optimizer"]


@pytest.mark.parametrize("name", CONFIGS)
def test_forwards_match(name):
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model
    from gvcnn_tf_tpu_torch.utils import fold_batch_norm

    cfg, model, w, views, opt = _setup(name)
    m = build_model(cfg)
    m.load_state_dict(w, strict=True)
    x = views.float() / 255.0 * 2.0 - 1.0
    with torch.no_grad():
        m.eval()
        lp, ep = m(x)
        lr, sr = ref.forward(w, views, model, "eval", layers.Exact)
        scale = lr.abs().max()
        assert (lp - lr).abs().max() <= 1e-4 * scale
        assert torch.allclose(ep["view_discrimination_scores"], sr,
                              atol=1e-5)
        lf, _ = ref.forward(w, views, model, "folded", layers.Exact)
        fold_batch_norm(m)
        lpf, _ = m(x)
        assert (lpf - lf).abs().max() <= 1e-4 * scale
    m.load_state_dict(w)
    m.train()
    keep = ref_train.dropout_keep(11, 0, (2, ref.param_spec(model)[
        "Logits.weight"][0][1]), 0.8, "cpu")
    gen = torch.Generator().manual_seed(ref_train.dropout_seed(11, 0, 0))
    lp, _ = m(x, generator=gen)
    lt, _ = ref.forward(w, views, model, "train", layers.Exact, keep)
    assert (lp - lt).abs().max() <= 1e-4 * lt.abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_one_train_step_matches(name):
    from gvcnn_tf_tpu_torch.train import create_train_state, train_step

    cfg, model, w, views, opt = _setup(name)
    state = create_train_state(cfg, "cpu")
    state.model.load_state_dict(w, strict=True)
    labels = torch.tensor([3, 17])
    mets = train_step(state, {"views": views, "label": labels}, cfg)
    trainable = [n for n, _ in state.model.named_parameters()]
    out = ref_train.train(w, trainable, [{"views": views, "label": labels}],
                          model, opt, 11, layers.Exact)
    # float32 rounding: ResNet's 53 train-mode BatchNorms over 24 values a
    # channel at 2x2 (the program's one-pass variance, the reference's
    # two-pass one) move the loss by ~1.4e-5.
    assert float(mets["loss"]) == pytest.approx(out["losses"][0], rel=1e-4)
    prog = compare.leaf_norms(dict(zip(trainable,
                                       state.optimizer.slots["trace"])))
    want = compare.leaf_norms(out["grads"])
    leaves = compare.moving_leaves(want)
    # Within 1%: ResNet's BatchNorms at this size move its leaves by up to
    # 0.43% in float32 (Inception's by under 0.01%).
    assert max(compare.leaf_gaps(prog, want, leaves)) < 1e-2
    params = dict(state.model.named_parameters())
    moved = compare.leaf_norms({k: params[k] - w[k] for k in trainable})
    want = compare.leaf_norms({k: out["params"][k] - w[k]
                               for k in trainable})
    assert max(compare.leaf_gaps(moved, want, leaves)) < 1e-2
