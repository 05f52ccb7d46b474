"""The output check catches a timed path broken underneath: a whole run
on the CPU at the tiny size (the look for a card skipped), with one fault
planted in the program, comes out not correct; the same run unbroken
comes out correct (`benchmark/faults.py` holds the faults).
And the control, the reference in float8 put in the
program's place, fails the cell's limits."""

import importlib

import numpy as np
import pytest

from benchmark import faults
from benchmark.tests import tiny

TRAIN = "mn40_12view.train_b32"
EVAL = "mn40_12view.eval_b32"


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_runs_are_correct(cell):
    result, checks, _ = tiny.run(cell)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0


def test_a_step_that_leaves_the_state_unchanged():
    with faults.unchanged():
        result, checks, _ = tiny.run(TRAIN)
    assert not result["correct"]
    assert checks["change_gap_median"][0] == pytest.approx(1.0)


@pytest.mark.parametrize("fault", ["half_loss", "stale_half"])
def test_a_step_on_half_the_batch(fault):
    with faults.FAULTS[fault]():
        result, checks, _ = tiny.run(TRAIN)
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", ["rolled", "padded_flip"])
def test_a_scored_answer_altered(fault):
    with faults.FAULTS[fault]():
        result, checks, _ = tiny.run(EVAL)
    assert not result["correct"], checks
    if fault == "padded_flip":       # the padded batch's own number
        value, limit = checks["last_batch_excess"]
        assert value > limit


def test_half_of_each_scored_batch_left_out(monkeypatch):
    ev = importlib.import_module("gvcnn_tf_tpu_torch.eval")
    make = ev.DevicePrefetcher

    def halved(batches, *a, **kw):
        def cut():
            for b in batches:
                n = max(len(b["label"]) // 2, 1)
                yield {k: np.asarray(v)[:n] for k, v in b.items()}
        return make(cut(), *a, **kw)

    monkeypatch.setattr(ev, "DevicePrefetcher", halved)
    result, checks, _ = tiny.run(EVAL)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", [TRAIN, EVAL])
def test_the_float8_control_fails_the_limits(cell):
    from benchmark import harness

    ctx = tiny.context(cell)
    driver = importlib.import_module(
        f"benchmark.traffic.{ctx.traffic['kind']}")
    limits = harness.load_json(harness.HERE / "limits" / f"{cell}.json")
    fp8 = driver.controls(ctx)["fp8"]
    assert any(fp8[k] > v["limit"] for k, v in limits.items()), fp8
