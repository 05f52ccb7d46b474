"""The per-layer readers of the program's own spans and counters
(`gvcnn_tf_tpu_torch/utils/profiling.py`): the store filled through its
API, each reader's value, nothing in a cell of the other kind or from a
program without the store, and the readers in a traced run of each kind
on the CPU."""

import statistics
import time

import pytest
import torch

from benchmark import harness, tracing
from benchmark.tests import tiny
from gvcnn_tf_tpu_torch.utils import profiling

TRAIN = {"kind": "train_stream"}
EVAL = {"kind": "eval_pass"}
MS = 1_000_000
NAMES = ["step_host_ms.train", "prefetch_blocked_ms.train",
         "prefetch_busy_ms.train", "eval_setup_ms.eval", "state_build_s",
         "graph_capture_s"]


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.reset()
    yield
    profiling.reset()


def read(name, records):
    return harness.reader(name).read(records)


def _busy(ms):
    t = time.perf_counter() + ms / 1e3
    while time.perf_counter() < t:
        pass


def _step(host_ms, children=("graph.launch",), launch_ms=3.0):
    """One `train.step` call: `host_ms` of its own work, then its
    children, each `launch_ms` long."""
    with profiling.span("train.step") as s:
        _busy(host_ms)
        for name in children:
            with profiling.span(name):
                _busy(launch_ms)
    return s.id


def _self_ms(ids):
    recs = profiling.snapshot()["spans"]["train.step"]["records"]
    return [r["self_ns"] / MS for r in recs if r["id"] in ids]


def test_step_host_ms_is_the_median_replayed_call_less_its_launch():
    _step(1.0, ("graph.warmup",))
    _step(1.0, ("graph.capture", "graph.launch"))
    replayed = {_step(ms) for ms in (1.0, 2.0, 4.0)}
    want = statistics.median(_self_ms(replayed))
    assert read("step_host_ms.train", TRAIN) == pytest.approx(want)
    assert 1.5 < want < 50


def test_step_host_ms_stays_non_negative_under_a_long_launch():
    """A launch that covers almost the whole call, or reads longer than
    it (its clock read after the call's), leaves a small host time, never
    a negative one."""
    with profiling.span("train.step") as s:
        _busy(0.5)
        profiling.record("graph.launch", s.start_ns, profiling.now_ns())
    with profiling.span("train.step") as s:
        profiling.record("graph.launch", s.start_ns - MS,
                         profiling.now_ns() + 10 * MS)
    v = read("step_host_ms.train", TRAIN)
    assert 0 <= v < 0.5


def _record(name, ms):
    t0 = profiling.now_ns()
    profiling.record(name, t0, t0 + ms * MS)


def test_the_prefetcher_readers():
    for ms in (2, 4, 9):
        _record("prefetch.produce", ms)
    for ms in (6, 2):
        _record("prefetch.blocked", ms)
    for _ in range(4):
        _record("prefetch.next", 1)
    _step(0.1)
    assert read("prefetch_busy_ms.train", TRAIN) == pytest.approx(4.0)
    # Every wait and batch lies before the first step.
    assert read("prefetch_blocked_ms.train", TRAIN) is None
    for ms in (6, 2):
        _record("prefetch.blocked", ms)
    for _ in range(4):
        _record("prefetch.next", 1)
    assert read("prefetch_blocked_ms.train", TRAIN) == pytest.approx(2.0)
    profiling.reset()
    _step(0.1)
    for _ in range(4):                  # no batch had to wait
        _record("prefetch.next", 1)
    assert read("prefetch_blocked_ms.train", TRAIN) == 0.0


def test_prefetch_blocked_leaves_the_set_up_s_waits_out():
    """Waits before the first step that set nothing up (the warm-up's and
    the capture's, and the batches they took) are not counted."""
    _record("prefetch.blocked", 30)
    _record("prefetch.next", 31)
    _step(0.1, ("graph.warmup",))
    _record("prefetch.blocked", 20)
    _record("prefetch.next", 21)
    _step(0.1, ("graph.capture", "graph.launch"))
    _record("prefetch.next", 1)
    _step(0.1)
    _record("prefetch.blocked", 3)
    for _ in range(3):
        _record("prefetch.next", 1)
    _step(0.1)
    assert read("prefetch_blocked_ms.train", TRAIN) == pytest.approx(1.0)


def test_eval_setup_ms_is_the_median_pass_set_up():
    for ms in (30, 10, 20):
        t0 = profiling.now_ns()
        profiling.record("eval.setup", t0, t0 + ms * MS)
    assert read("eval_setup_ms.eval", EVAL) == pytest.approx(20.0)


def test_set_up_readers_leave_the_kernels_build_out():
    t0 = profiling.now_ns()
    profiling.record("train.create_state", t0, t0 + 1500 * MS)
    with profiling.span("graph.warmup"):
        _busy(2)
        with profiling.span("kernels.build"):
            _busy(20)
    t0 = profiling.now_ns()
    profiling.record("graph.capture", t0, t0 + 2000 * MS)
    warm = profiling.snapshot()["spans"]["graph.warmup"]
    assert 2 * MS <= warm["self_ns"] < warm["total_ns"] - 20 * MS
    for records in (TRAIN, EVAL):
        assert read("state_build_s", records) == pytest.approx(1.5)
        assert read("graph_capture_s", records) == pytest.approx(
            2.0 + warm["self_ns"] / 1e9)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_gives_nothing(name, monkeypatch):
    assert read(name, TRAIN) is None and read(name, EVAL) is None
    _step(0.1, ("graph.warmup",))
    _step(0.1)
    for n in ("prefetch.produce", "prefetch.blocked", "prefetch.next",
              "eval.setup", "train.create_state", "graph.capture"):
        _record(n, 1)
    kind = EVAL if name.endswith(".eval") else TRAIN
    assert read(name, kind) is not None
    other = TRAIN if kind is EVAL else EVAL
    if name.endswith((".train", ".eval")):
        assert read(name, other) is None
    assert read(name, {"kind": "serve_open"}) is None
    # A program without the store (the parent of this change).
    monkeypatch.delattr(profiling, "snapshot")
    assert read(name, kind) is None


@pytest.mark.parametrize("cell,found", [
    ("mn40_12view.train_b32", {"prefetch_blocked_ms.train",
                               "prefetch_busy_ms.train", "state_build_s"}),
    ("mn40_12view.eval_b32", {"eval_setup_ms.eval", "state_build_s"})])
def test_a_traced_run_on_the_cpu_reports_the_program_s_spans(cell, found):
    """On the CPU no graph is captured, so the graph readers find
    nothing; the others read the run's spans."""
    result, _, _ = tiny.run(cell, trace=True)
    metrics = result["metrics"]
    assert found <= set(metrics)
    assert not ({"step_host_ms.train", "graph_capture_s"} & set(metrics))
    for name in found:
        assert metrics[name]["value"] >= 0


def test_the_profiled_window_holds_no_event_of_the_program():
    """The benchmark's own profiler session is not the program's: the
    program's spans are recorded in its store and emit no profiler event
    there, so the device-trace readers read what they read before."""
    w = tracing.ProfiledWindow(tracing.Spans(), "cpu")
    w.start()
    with profiling.span("train.step"):
        with profiling.span("graph.launch", call="a step"):
            torch.ones(4).add_(1)
        profiling.count("eval.rows", 4)
    w.stop()
    names = {e.name for e in w.prof.events()}
    assert tracing.WINDOW in names
    assert not {n for n in names if n.split(".")[0] in (
        "train", "graph", "prefetch", "eval", "serve", "kernels")}
    assert profiling.snapshot()["spans"]["graph.launch"]["count"] == 1
