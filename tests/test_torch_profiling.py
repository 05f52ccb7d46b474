"""The port's tracing and timing (utils/profiling.py) and the training
loop's profiled window, `train(profile_steps=(start, stop))`, on the CPU.

The window follows `gvcnn_tf_tpu/train.py`: capture from step `start`,
before its batch is fetched, to the end of step `stop - 1`.  The port
writes a Chrome trace under `train_logdir`, each step in a
`train_step {step}` span, so the test reads which steps a trace holds.
"""

import dataclasses
import importlib
import json

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.parallel import World  # noqa: E402
from gvcnn_tf_tpu_torch.utils import profile_trace, timed_steps  # noqa: E402

port_train = importlib.import_module("gvcnn_tf_tpu_torch.train")


def _cfg(logdir):
    cfg = port_configs.get_config("mn40_12view")
    return cfg.replace(
        compute_dtype="float32", raw_endpoint="Conv2d_2c_3x3",
        final_endpoint="Mixed_3b",
        data=dataclasses.replace(cfg.data, height=32, width=32, num_views=2,
                                 batch_size=2, synthetic_num_shapes=6),
        train=dataclasses.replace(cfg.train, train_logdir=str(logdir),
                                  log_every=1, checkpoint_every=2))


def _spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(e["name"] for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("train_step "))


def test_profiled_window_holds_exactly_its_steps(tmp_path):
    state, mets = port_train.train(_cfg(tmp_path), num_steps=4,
                                   profile_steps=(1, 3), device="cpu")
    assert state.step == 4
    traces = sorted(tmp_path.glob("*.json"))
    assert [p.name for p in traces] == ["trace_steps_1_3.json"]
    assert _spans(traces[0]) == ["train_step 1", "train_step 2"]
    assert port_train.trace_name((1, 3), World()) == "trace_steps_1_3.json"
    assert port_train.trace_name((1, 3), World(rank=1, size=2)) == \
        "trace_steps_1_3_rank1.json"


def test_a_run_resumed_past_the_window_captures_nothing(tmp_path):
    port_train.train(_cfg(tmp_path), num_steps=2, device="cpu")
    state, _ = port_train.train(_cfg(tmp_path), num_steps=4,
                                profile_steps=(1, 2), device="cpu")
    assert state.step == 4
    assert not list(tmp_path.glob("*.json"))


def test_a_run_ending_inside_the_window_writes_what_it_captured(tmp_path):
    port_train.train(_cfg(tmp_path), num_steps=2, profile_steps=(1, 5),
                     device="cpu")
    assert _spans(tmp_path / "trace_steps_1_5.json") == ["train_step 1"]


@pytest.mark.parametrize("window", [(-1, 2), (2, 2), (3, 1)])
def test_bad_windows_are_refused(tmp_path, window):
    with pytest.raises(ValueError, match="profile_steps"):
        port_train.train(_cfg(tmp_path), num_steps=1, profile_steps=window,
                         device="cpu")
    assert not (tmp_path / "metrics.jsonl").exists()


@pytest.mark.parametrize("name", [None, "window.json"])
def test_profile_trace_writes_a_chrome_trace(tmp_path, name):
    logdir = str(tmp_path / "logs")
    with profile_trace(logdir, **({"name": name} if name else {}),
                       device="cpu"):
        with torch.profiler.record_function("marked"):
            torch.ones(8, 8).matmul(torch.ones(8, 8))
    with open(tmp_path / "logs" / (name or "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "marked" in names
    assert any(n and "mm" in n for n in names)


@pytest.mark.parametrize("warmup,iters", [(3, 10), (0, 2)])
def test_timed_steps_calls_and_times(warmup, iters):
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return {"y": torch.full((4,), x * scale)}

    mean = timed_steps(fn, 2.0, warmup=warmup, iters=iters, scale=3.0)
    assert len(calls) == warmup + iters
    assert mean > 0
