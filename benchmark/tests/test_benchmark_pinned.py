"""What the benchmark reads must not move when its reference or its
counting is rewritten: the parameter spec (names, shapes and roles, in
order; the same seed then makes the same weights) and the counted FLOPs
of a B=32 train step, pinned for each configuration at the values they
had when the benchmark's cells were measured."""

import hashlib
import json

import pytest

from benchmark import counting, harness
from benchmark.reference import gvcnn

PINNED = {
    "mn40_12view": dict(
        entries=236, flops=3_561_119_809_536,
        spec="4417040994462f909f5a7039fcb7225f"
             "2bbddb37b43ce991eb5b5e13fa68eba6"),
    "mn40_12view_resnet50": dict(
        entries=288, flops=8_403_206_406_144,
        spec="6500df2eedc0914af25b9e6abe94eff8"
             "b7b50ec314c492f7b9b1f1ca25815d4b"),
    "mn40_12view_inception_v4": dict(
        entries=604, flops=28_368_718_258_176,
        spec="91169dba6b9698909eb81c4a695e57f0"
             "3fd7c33404a144f7ce2f9b4dbbd54e04"),
}


def _model(config):
    return harness.load_json(harness.HERE / "configs"
                             / f"{config}.json")["model"]


def spec_digest(spec) -> str:
    """sha256 of [[name, shape, role], ...] in the spec's order."""
    rows = [[name, list(shape), role] for name, (shape, role) in spec.items()]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


@pytest.mark.parametrize("config", sorted(PINNED))
def test_param_spec_is_pinned(config):
    spec = gvcnn.param_spec(_model(config))
    assert len(spec) == PINNED[config]["entries"]
    assert spec_digest(spec) == PINNED[config]["spec"]


@pytest.mark.parametrize("config", sorted(PINNED))
def test_counted_flops_are_pinned(config):
    assert counting.train_step_flops(_model(config), 32) \
        == PINNED[config]["flops"]
