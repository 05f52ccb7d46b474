"""The port's span and counter store (`utils/profiling.py`) and the spans
at its boundaries, on the CPU: nesting, parents and self time, a parent on
another thread, the ring's bound, threads recording at once, the
profiler's clock, ranges only in the program's own traces; then `train()`,
the prefetcher, `evaluate()`, `CapturedCall`, the compiled step and the
engine's `/stats`.

mn40_12view narrowed to 32x32, 2 views, float32, up to Mixed_3b.
"""

import dataclasses
import importlib
import json
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.data import DevicePrefetcher  # noqa: E402
from gvcnn_tf_tpu_torch.serve import InferenceEngine  # noqa: E402
from gvcnn_tf_tpu_torch.utils import graphs, profiling  # noqa: E402
from gvcnn_tf_tpu_torch.utils.profiling import SpanStore  # noqa: E402

port_train = importlib.import_module("gvcnn_tf_tpu_torch.train")
port_eval = importlib.import_module("gvcnn_tf_tpu_torch.eval")
MS = 1_000_000


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.reset()
    yield
    profiling.reset()


def _records(snap, name):
    return snap["spans"][name]["records"]


def _sleep_ms(ms):
    t = time.perf_counter() + ms / 1e3
    while time.perf_counter() < t:
        pass


# ---------------------------------------------------------------- the store

def test_nesting_parents_and_self_time():
    store = SpanStore()
    with store.span("outer", step=3) as outer:
        _sleep_ms(2)
        with store.span("inner") as inner:
            _sleep_ms(6)
        _sleep_ms(2)
    snap = store.snapshot()
    [o], [i] = _records(snap, "outer"), _records(snap, "inner")
    assert i["parent"] == outer.id and o["parent"] is None
    assert inner.id == i["id"] and o["attrs"] == {"step": 3}
    assert o["start_ns"] <= i["start_ns"] < i["end_ns"] <= o["end_ns"]
    dur = o["end_ns"] - o["start_ns"]
    assert o["self_ns"] == dur - (i["end_ns"] - i["start_ns"])
    assert 3.5 * MS < o["self_ns"] < dur - 5.5 * MS
    assert i["self_ns"] == i["end_ns"] - i["start_ns"]
    s = snap["spans"]["outer"]
    assert (s["count"], s["total_ns"], s["self_ns"], s["max_ns"]) == (
        1, dur, o["self_ns"], dur)
    assert snap["clock"] == "unix_ns"


def test_a_parent_on_another_thread_by_id():
    """A span on another thread names its parent by id: linked, and its
    time is taken out of the parent's self time; `record` adds a span
    that ended already."""
    store = SpanStore()
    with store.span("request") as req:
        t0 = profiling.now_ns()

        def device():
            store.record("queue", t0, profiling.now_ns(), parent=req.id)
            with store.span("forward", parent=req.id):
                _sleep_ms(5)

        th = threading.Thread(target=device)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    snap = store.snapshot()
    [r] = _records(snap, "request")
    [q], [f] = _records(snap, "queue"), _records(snap, "forward")
    assert q["parent"] == f["parent"] == r["id"]
    assert q["thread"] == f["thread"] != r["thread"]
    covered = (q["end_ns"] - q["start_ns"]) + (f["end_ns"] - f["start_ns"])
    assert r["self_ns"] == r["end_ns"] - r["start_ns"] - covered


def test_the_ring_keeps_the_last_records_and_every_total():
    store = SpanStore(ring=8)
    for k in range(20):
        with store.span("s", k=k):
            pass
    s = store.snapshot()["spans"]["s"]
    assert s["count"] == 20
    assert [r["attrs"]["k"] for r in s["records"]] == list(range(12, 20))
    assert [dict(zip(profiling.FIELDS, r)) for r in store.records("s")] == \
        s["records"]
    assert store.records("none") == []
    store.count("c", 3)
    store.count("c")
    assert store.snapshot()["counters"] == {"c": 4}
    store.reset()
    assert store.snapshot() == {"clock": "unix_ns", "spans": {},
                                "counters": {}}


def test_threads_record_at_once():
    """16 threads, more than the cores, each nest spans and count with a
    short switch interval: no record, total or count is lost and every
    child names its own thread's parent."""
    store = SpanStore(ring=100_000)
    n, per = 16, 500
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with store.span("a") as a:
                    with store.span("b") as b:
                        assert b.parent == a.id
                    store.count("n")

        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    snap = store.snapshot()
    assert snap["counters"]["n"] == n * per
    a, b = snap["spans"]["a"], snap["spans"]["b"]
    assert a["count"] == b["count"] == len(a["records"]) == n * per
    parents = {r["id"]: r["thread"] for r in a["records"]}
    assert all(parents[r["parent"]] == r["thread"] for r in b["records"])
    assert a["self_ns"] == a["total_ns"] - b["total_ns"]


def _names(prof):
    return {e.name for e in prof.events()}


def test_a_profiler_session_the_program_did_not_open_sees_no_span():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("program.outer"):
            with profiling.span("program.inner"):
                torch.ones(4).add_(1)
    assert not {n for n in _names(prof) if n.startswith("program.")}
    assert profiling.snapshot()["spans"]["program.inner"]["count"] == 1


def test_profile_trace_holds_every_span_and_the_counters(tmp_path):
    profiling.count("before", 2)
    with profiling.profile_trace(str(tmp_path), "t.json", device="cpu"):
        with profiling.span("program.outer"):
            with profiling.span("program.inner"):
                torch.ones(4).add_(1)
            profiling.count("inside")
    trace = json.loads((tmp_path / "t.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"program.outer", "program.inner"} <= names
    assert trace["program_counters"] == {
        "start": {"before": 2}, "end": {"before": 2, "inside": 1}}
    assert profiling.STORE.traces == 0
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("program.after"):
            pass
    assert "program.after" not in _names(prof)


def test_spans_are_on_the_profilers_clock():
    """A span's start lies within 1 ms of a `record_function` entered at
    the same point, placed by the profile's `trace_start_ns()` plus its
    `time_range`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with profiling.span("program.marked"), \
                    record_function(f"marked {k}"):
                _sleep_ms(1)
    base = prof.profiler.kineto_results.trace_start_ns()
    starts = {e.name: base + e.time_range.start * 1e3
              for e in prof.events() if e.name.startswith("marked ")}
    recs = _records(profiling.snapshot(), "program.marked")
    assert len(recs) == len(starts) == 3
    for k, r in enumerate(recs):
        assert abs(r["start_ns"] - starts[f"marked {k}"]) < 1 * MS


# ----------------------------------------------------- the boundaries

def _cfg(logdir=None, batch_size=2):
    cfg = port_configs.get_config("mn40_12view")
    return cfg.replace(
        compute_dtype="float32", raw_endpoint="Conv2d_2c_3x3",
        final_endpoint="Mixed_3b",
        data=dataclasses.replace(cfg.data, height=32, width=32, num_views=2,
                                 batch_size=batch_size,
                                 synthetic_num_shapes=6),
        train=dataclasses.replace(cfg.train, train_logdir=str(logdir),
                                  log_every=1, checkpoint_every=0))


def test_train_records_its_steps_state_and_feed(tmp_path):
    state, _ = port_train.train(_cfg(tmp_path), num_steps=3,
                                profile_steps=(1, 2), device="cpu")
    snap = profiling.snapshot()
    spans = snap["spans"]
    assert spans["train.step"]["count"] == 3
    assert spans["train.create_state"]["count"] == 1
    assert spans["prefetch.next"]["count"] >= 3
    assert spans["prefetch.produce"]["count"] >= 3
    trace = json.loads((tmp_path / "trace_steps_1_2.json").read_text())
    steps = [e for e in trace["traceEvents"] if e.get("name") == "train.step"]
    assert len(steps) == 1
    assert {"train_step 1", "prefetch.next"} <= {
        e.get("name") for e in trace["traceEvents"]}


def _batches(n, size=2, delay=0.0):
    rs = np.random.RandomState(0)
    for _ in range(n):
        time.sleep(delay)
        yield {"views": rs.randint(0, 256, (size, 2, 8, 8, 3)).astype(
                   np.uint8),
               "label": rs.randint(0, 40, size)}


def test_a_slow_producer_blocks_the_consumer():
    with DevicePrefetcher(_batches(4, delay=0.05), torch.device("cpu"),
                          depth=1) as it:
        got = list(it)
    assert len(got) == 4
    snap = profiling.snapshot()
    assert snap["spans"]["prefetch.next"]["count"] == 5     # and the end
    blocked = snap["spans"]["prefetch.blocked"]
    assert blocked["count"] >= 3 and blocked["total_ns"] > 3 * 30 * MS
    nexts = {r["id"] for r in _records(snap, "prefetch.next")}
    assert all(r["parent"] in nexts for r in blocked["records"])
    produce = _records(snap, "prefetch.produce")
    assert len(produce) == 4
    assert {r["thread"] for r in produce}.isdisjoint(
        {r["thread"] for r in blocked["records"]})


def test_a_ready_producer_does_not_block():
    it = DevicePrefetcher(_batches(3), torch.device("cpu"), depth=3)
    try:
        deadline = time.time() + 30
        while it._queue.qsize() < 3 and time.time() < deadline:
            time.sleep(0.01)
        next(it)
        next(it)
    finally:
        it.close()
    snap = profiling.snapshot()
    assert snap["spans"]["prefetch.next"]["count"] == 2
    assert "prefetch.blocked" not in snap["spans"]


def test_evaluate_counts_its_rows_padding_and_set_up(tmp_path):
    cfg = _cfg(tmp_path)
    state = port_train.create_train_state(cfg, "cpu")
    host = list(_batches(3, size=2))
    host[-1] = {k: v[:1] for k, v in host[-1].items()}     # 5 shapes
    host = [{"views": np.repeat(np.repeat(b["views"], 4, 2), 4, 3),
             "label": b["label"]} for b in host]
    res = port_eval.evaluate(cfg, state=state, dataset_iter=iter(host),
                             device="cpu")
    assert res["count"] == 5
    snap = profiling.snapshot()
    assert snap["counters"]["eval.rows"] == 5
    assert snap["counters"]["eval.padded_rows"] == 1
    [setup], [drain] = (_records(snap, "eval.setup"),
                        _records(snap, "eval.drain"))
    assert setup["end_ns"] <= drain["start_ns"]
    first = min(_records(snap, "prefetch.next"), key=lambda r: r["start_ns"])
    assert first["parent"] == setup["id"]
    assert first["end_ns"] <= setup["end_ns"]


class _FakeGraph:
    """`torch.cuda.CUDAGraph`'s part in `CapturedCall` on the CPU: a
    capture runs the function, a replay runs it again into the outputs."""

    def __init__(self, call):
        self.call, self.fresh = call, False

    def register_generator_state(self, generator):
        pass

    def capture_begin(self, pool=None, capture_error_mode="global"):
        pass

    def capture_end(self):
        self.fresh = True

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        out = self.call.fn()
        for k in out:
            self.call.outputs[k].copy_(out[k])


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "_new_graph", _FakeGraph)
    monkeypatch.setattr(graphs, "capturable", lambda device: True)


def test_captured_call_spans_and_recaptures(fake_graphs):
    w = torch.ones(3)
    call = graphs.CapturedCall("double", lambda: {"y": call.inputs["x"] * w},
                               {"x": torch.zeros(3)}, device="cpu",
                               watch=lambda: [w])
    for k in range(4):
        out = call(x=torch.full((3,), float(k)))
    assert torch.equal(out["y"], torch.full((3,), 3.0))
    w.data = w.data.clone()             # a watched storage moves
    call(x=torch.ones(3))
    snap = profiling.snapshot()
    spans = snap["spans"]
    assert {n: spans[n]["count"] for n in
            ("graph.warmup", "graph.capture", "graph.launch")} == {
        "graph.warmup": 1, "graph.capture": 2, "graph.launch": 4}
    assert snap["counters"]["graph.recaptures"] == 1
    assert all(r["attrs"] == {"call": "double"}
               for n in ("graph.warmup", "graph.capture", "graph.launch")
               for r in spans[n]["records"])


def test_the_compiled_step_s_host_work_is_its_self_time(fake_graphs):
    """`train.step` holds the warm-up, then the capture and its launch,
    then a launch alone; its self time is the call less those."""
    cfg = _cfg()
    rs = np.random.RandomState(0)
    batch = {"views": torch.from_numpy(rs.randint(
                 0, 256, (2, 2, 32, 32, 3)).astype(np.uint8)),
             "label": torch.from_numpy(rs.randint(0, 40, 2))}
    state = port_train.create_train_state(cfg, "cpu")
    step = port_train.compile_train_step(state, cfg, batch)
    for _ in range(3):
        step(state, batch, cfg)
    snap = profiling.snapshot()
    steps = _records(snap, "train.step")
    assert len(steps) == 3
    kids = {}
    for name in ("graph.warmup", "graph.capture", "graph.launch"):
        for r in _records(snap, name):
            kids.setdefault(r["parent"], []).append(r)
    assert [sorted(k["name"] for k in kids[s["id"]]) for s in steps] == [
        ["graph.warmup"], ["graph.capture", "graph.launch"],
        ["graph.launch"]]
    for s in steps:
        inside = sum(k["end_ns"] - k["start_ns"] for k in kids[s["id"]])
        assert s["self_ns"] == s["end_ns"] - s["start_ns"] - inside >= 0


def _engine_cfg():
    cfg = port_configs.get_config("mn40_12view")
    return cfg.replace(compute_dtype="float32", data=dataclasses.replace(
        cfg.data, height=32, width=32, num_views=2, batch_size=2))


def test_stats_report_each_engine_s_own_requests(capfd):
    a = InferenceEngine(_engine_cfg(), serve_batch_size=4, device="cpu")
    b = InferenceEngine(_engine_cfg(), serve_batch_size=4, device="cpu")
    try:
        assert a.latency_stats() == {"count": 0}
        capfd.readouterr()
        rs = np.random.RandomState(0)
        for n in (3, 5):                # 3: one chunk padded to 4
            a.predict(rs.randint(0, 256, (n, 2, 32, 32, 3)).astype(np.uint8))
        b.predict(rs.randint(0, 256, (1, 2, 32, 32, 3)).astype(np.uint8))
        assert "/predict" not in capfd.readouterr().err
        sa, sb = a.latency_stats(), b.latency_stats()
    finally:
        a.close()
        b.close()
    # a: 3 -> [4 (1 padded)]; 5 -> [4, 1] (bucket 1, none padded)
    assert (sa["count"], sa["shapes"]) == (2, 8)
    assert (sa["queue_count"], sa["forward_count"]) == (3, 3)
    assert (sa["forward_rows"], sa["padded_rows"]) == (9, 1)
    assert sa["padded_share"] == round(1 / 9, 4)
    assert (sb["count"], sb["shapes"], sb["forward_count"]) == (1, 1, 1)
    assert (sb["padded_rows"], sb["padded_share"]) == (0, 0.0)
    for s in (sa, sb):
        assert 0 < s["p50_ms"] <= s["p99_ms"]
        assert 0 <= s["queue_p50_ms"] <= s["queue_p99_ms"]
        assert 0 < s["forward_p50_ms"] <= s["forward_p99_ms"] <= s["p99_ms"]
        assert s["serve_batch_size"] == 4
    snap = profiling.snapshot()
    reqs = {r["id"]: r for r in _records(snap, "serve.request")}
    for name in ("serve.queue", "serve.forward"):
        for r in _records(snap, name):
            req = reqs[r["parent"]]
            assert r["thread"] != req["thread"]
            assert req["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
                req["end_ns"]
