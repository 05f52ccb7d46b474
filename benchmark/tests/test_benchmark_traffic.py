"""Each traffic kind's seeded inputs repeat exactly, and every seed gets
the same work."""

import numpy as np
import torch

from benchmark import inputs, program
from benchmark.tests import tiny
from benchmark.traffic import eval_pass, train_stream


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def test_train_stream_inputs_repeat():
    a = train_stream.inputs(tiny.context("mn40_12view.train_b32", seed=7))
    b = train_stream.inputs(tiny.context("mn40_12view.train_b32", seed=7))
    c = train_stream.inputs(tiny.context("mn40_12view.train_b32", seed=8))
    assert _same(a, b) and not _same(a[1], c[1])
    assert a[1].dtype == np.uint8 and a[1].shape == (12, 2, 64, 64, 3)


def test_eval_pass_inputs_and_rows_repeat():
    ctx = tiny.context("mn40_12view.eval_b32", seed=7)
    assert _same(eval_pass.inputs(ctx), eval_pass.inputs(ctx))
    rows = eval_pass.pass_rows(4, 2, 5)
    assert rows.tolist() == [0, 1, 2, 3, 0, -1]
    batches = list(eval_pass.batches(np.arange(4), np.arange(4), 2, 5))
    assert [b["views"].tolist() for b in batches] == [[0, 1], [2, 3], [0]]


def test_weights_repeat_and_follow_their_roles():
    ctx = tiny.context("mn40_12view.train_b32", seed=7)
    a, b = program.weights(ctx), program.weights(ctx)
    assert _same(a, b)
    assert (a["InceptionV1.Conv2d_1a_7x7.BatchNorm.running_var"] > 0).all()
    assert inputs.seed_of(2 ** 31 + 5, "x") != inputs.seed_of(2 ** 31 + 6, "x")
