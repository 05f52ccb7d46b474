"""The port's load generator (tools/loadgen.py) on the CPU: `_pct` and
`run_load` are the JAX tool's source line for line, and they drive the
port's `InferenceEngine` (mn40_12view at 32x32, 2 views, fp32, buckets
{1, 2}) closed loop, open loop and through the CLI.
"""

import argparse
import dataclasses
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from gvcnn_tf_tpu.tools import loadgen as jax_loadgen  # noqa: E402
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.checkpoint import Checkpointer  # noqa: E402
from gvcnn_tf_tpu_torch.models.gvcnn import (  # noqa: E402
    build_model,
    init_weights,
)
from gvcnn_tf_tpu_torch.serve import InferenceEngine  # noqa: E402
from gvcnn_tf_tpu_torch.tools import loadgen  # noqa: E402
from gvcnn_tf_tpu_torch.tools.loadgen import _pct, run_load  # noqa: E402

V, H = 2, 32
FLAGS = ["--config", "mn40_12view", "--num_views", str(V), "--height",
         str(H), "--width", str(H), "--num_classes", "10"]


def _config(**data_kw):
    cfg = port_configs.get_config("mn40_12view")
    return cfg.replace(compute_dtype="float32", data=dataclasses.replace(
        cfg.data, height=H, width=H, num_views=V, batch_size=2, **data_kw))


@pytest.fixture(scope="module")
def engine():
    eng = InferenceEngine(_config(), serve_batch_size=2, buckets=(1, 2),
                          device="cpu")
    yield eng
    eng.close()


@pytest.mark.parametrize("name", ["_pct", "run_load"])
def test_the_jax_tool_s_source(name):
    assert inspect.getsource(getattr(loadgen, name)) == inspect.getsource(
        getattr(jax_loadgen, name))


def test_pct_nearest_rank():
    assert _pct([1.0, 9.0], 50) == 1.0
    assert _pct([1.0, 9.0], 99) == 9.0
    vals = sorted(np.arange(1, 101).astype(float))
    assert (_pct(vals, 50), _pct(vals, 99)) == (50.0, 99.0)
    assert np.isnan(_pct([], 50))


def test_report_shape_and_mixed_sizes(engine):
    """Closed loop, 3 clients mixing B=1 and B=2: both sizes run, the
    per-size counts add up, and the engine's own stats saw the traffic.

    At any speed: with no warm-up every client's first request is
    recorded, and clients 0 and 1 start on different sizes, so each size
    completes at least once however long a request takes on a loaded CPU
    (after a 0.2 s warm-up a 1 s window could close before a request of
    one size was sent).  The report rounds shapes/s and views/s to 0.01,
    so they agree to V + 1 half-granules, not to a relative bound."""
    before = engine.latency_stats().get("count", 0)
    rep = run_load(engine, num_clients=3, duration_s=1.0,
                   request_sizes=(1, 2), warmup_s=0.0)
    assert (rep["clients"], rep["request_sizes"]) == (3, [1, 2])
    assert rep["requests"] > 0 and rep["shapes_per_sec"] > 0
    assert rep["views_per_sec"] == pytest.approx(rep["shapes_per_sec"] * V,
                                                 rel=0, abs=0.005 * (V + 1))
    assert 0 < rep["p50_ms"] <= rep["p99_ms"]
    assert rep["b1_requests"] > 0 and rep["b2_requests"] > 0
    assert rep["b1_requests"] + rep["b2_requests"] == rep["requests"]
    assert "offered_rps" not in rep
    assert engine.latency_stats()["count"] >= min(before + rep["requests"],
                                                  1024)


def test_single_client_one_size(engine):
    rep = run_load(engine, num_clients=1, duration_s=0.5,
                   request_sizes=(1,), warmup_s=0.0)
    assert rep["requests"] == rep["b1_requests"] > 0
    assert "b2_p50_ms" not in rep


def test_open_loop(engine):
    """rate_rps > 0: Poisson arrivals at a low offered load; the report
    carries the offered and the achieved rate."""
    rep = run_load(engine, num_clients=2, duration_s=1.5,
                   request_sizes=(1,), warmup_s=0.2, rate_rps=6.0)
    assert rep["offered_rps"] == 6.0
    assert rep["requests"] > 0
    assert 0 < rep["achieved_rps"] <= 4 * rep["offered_rps"]
    assert rep["p50_ms"] <= rep["p99_ms"]


def test_uint8_wire_engine():
    """An engine on the uint8 wire takes run_load's float32 requests (it
    re-quantizes them on the host)."""
    eng = InferenceEngine(_config(transfer_dtype="uint8", dataset="procedural"),
                          serve_batch_size=2, buckets=(1, 2), device="cpu")
    try:
        rep = run_load(eng, num_clients=2, duration_s=0.5,
                       request_sizes=(1, 2), warmup_s=0.0)
    finally:
        eng.close()
    assert rep["requests"] > 0


def test_cli_on_the_cpu(tmp_path, capsys):
    cfg = port_configs.config_from_flags(
        port_configs.add_flags(argparse.ArgumentParser()).parse_args(FLAGS))
    Checkpointer(str(tmp_path)).save(1, {
        "step": 1, "model": init_weights(build_model(cfg), 0).state_dict()})
    loadgen.main(FLAGS + ["--checkpoint_dir", str(tmp_path), "--clients",
                          "2", "--duration", "0.5", "--request_sizes", "1,2",
                          "--serve_batch_size", "2", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["clients"] == 2 and rep["request_sizes"] == [1, 2]
    assert rep["requests"] > 0


def test_cli_refuses_the_card_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="never falls back"):
        loadgen.main(FLAGS + ["--checkpoint_dir", str(tmp_path)])
