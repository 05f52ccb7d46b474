"""The port's CUDA graphs (`gvcnn_tf_tpu_torch/utils/graphs.py`) and what
they need of the train step, on the CPU.

A CPU has no CUDA graph, so the entry points run eagerly here.  The
graphs' plumbing is driven through `Recorder`, which the `recorder`
fixture puts in place of `torch.cuda.CUDAGraph` (with `capturable` true
for the CPU): a capture runs the function (a CPU cannot record without
running it) and that run stands for the replay that follows it; every
later replay runs the captured function again on the static buffers and
writes its results into the static outputs.  Nothing on the main path can
select it.  The tests hold, bit for bit (`torch.equal`):

- the optimizer's device scalars (-lr, Adam's bias corrections as 0-d
  fp32 tensors) against the Python-float update they replace, and
  `_foreach_mul` / `_foreach_div` by a 0-d fp32 tensor against the scalar;
- one generator a microbatch, reseeded before the step's device work,
  against one generator reseeded right before each draw;
- the compiled step against `train_step` (on the CPU it is `train_step`;
  through the recorder: the static input copy, fresh metrics, the lr and
  the seeds written before each replay, the launch counters advanced per
  replay), the engine's buckets, `evaluate` and the training loop;
- recapture when a watched storage moves, a failed capture's error, the
  caches computed while capturing, and the JAX step tracked by the
  recorded step as `test_torch_train.py` tracks it with the eager step.
The card's own checks are in `tests/test_torch_cuda_kernels.py` and
`chip_smoke.py` phase 19.
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_optimizer_ref import python_float_update  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import (  # noqa: E402
    jax_to_state_dict,
    state_dict_to_jax,
)
from gvcnn_tf_tpu_torch.ops import (  # noqa: E402
    grouping_kernel,
    launched,
    launches,
    stem_kernel,
)
from gvcnn_tf_tpu_torch.utils import graphs  # noqa: E402

jax_train = importlib.import_module("gvcnn_tf_tpu.train")
port_train = importlib.import_module("gvcnn_tf_tpu_torch.train")
port_gvcnn = importlib.import_module("gvcnn_tf_tpu_torch.models.gvcnn")
port_eval = importlib.import_module("gvcnn_tf_tpu_torch.eval")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(out):
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return [] if out is None else [out]


class Recorder:
    """`torch.cuda.CUDAGraph`'s part in `CapturedCall`, on the CPU (see the
    module docstring)."""

    def __init__(self, call):
        self.call = call
        self.generators = []
        self.fresh = False
        self.modes = []

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.modes.append(capture_error_mode)

    def capture_end(self):
        self.fresh = True

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        for static, new in zip(_leaves(self.call.outputs),
                               _leaves(self.call.fn())):
            static.copy_(new)


@pytest.fixture
def recorder(monkeypatch):
    made = []

    def new_graph(call):
        made.append(Recorder(call))
        return made[-1]

    monkeypatch.setattr(graphs, "_new_graph", new_graph)
    monkeypatch.setattr(graphs, "capturable", lambda device: True)
    return made


@pytest.fixture
def counted(monkeypatch):
    """The plain versions count as the kernels do where they launch."""
    stem, group = stem_kernel._stem_forward, grouping_kernel._forward

    def stem_counted(x, *a, **kw):
        launches[stem_kernel.kernel_name(x.dtype)] += 1
        return stem(x, *a, **kw)

    def group_counted(*a, **kw):
        launches[grouping_kernel.KERNEL_NAME] += 1
        return group(*a, **kw)

    monkeypatch.setattr(stem_kernel, "_stem_forward", stem_counted)
    monkeypatch.setattr(grouping_kernel, "_forward", group_counted)


def _counts():
    return launched("stem_conv7x7s2"), launched("group_and_fuse")


def _tiny(mod=port_configs, keep=0.5, flip=False, **train_kw):
    """mn40_12view cut to Mixed_3b, 32x32, 2 views, B = 4, fp32; dropout
    at `keep`; with `flip` the decoded loader's on-card flip."""
    cfg = mod.get_config("mn40_12view")
    data = dict(height=32, width=32, num_views=2, batch_size=4)
    if flip:
        data.update(loader="decoded", augment=True, device_flip=True,
                    transfer_dtype="uint8")
    return cfg.replace(
        compute_dtype="float32", dropout_keep_prob=keep,
        raw_endpoint="Conv2d_2c_3x3", final_endpoint="Mixed_3b",
        data=dataclasses.replace(cfg.data, **data),
        train=dataclasses.replace(cfg.train, **train_kw))


def _batches(cfg, n, seed=0, uint8=False):
    d = cfg.data
    rs = np.random.RandomState(seed)
    shape = (d.batch_size, d.num_views, d.height, d.width, 3)
    out = []
    for _ in range(n):
        v = (rs.randint(0, 256, shape).astype(np.uint8) if uint8
             else rs.uniform(-1, 1, shape).astype(np.float32))
        out.append({"views": torch.from_numpy(v), "label": torch.from_numpy(
            rs.randint(0, d.num_classes, d.batch_size))})
    return out


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for k in a.optimizer.slots:
        for x, y in zip(a.optimizer.slots[k], b.optimizer.slots[k]):
            assert torch.equal(x, y), k
    assert (a.step, a.optimizer.count) == (b.step, b.optimizer.count)


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("clip", [0.0, 0.7])
@pytest.mark.parametrize("kind", ["momentum", "sgd", "adam"])
def test_device_scalar_optimizer_is_the_python_float_update(kind, clip):
    """5 updates with -lr and the bias corrections read from 0-d fp32
    tensors equal the Python-float update bit for bit (a decaying,
    warmed-up rate, so -lr is no round number)."""
    tc = port_configs.TrainConfig(
        optimizer=kind, learning_rate=0.1, lr_decay_steps=2,
        lr_decay_rate=0.94, warmup_steps=3, grad_clip_norm=clip)
    rs = np.random.RandomState(7)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    start = [rs.randn(*s).astype(np.float32) for s in shapes]
    got = port_train.Optimizer([torch.from_numpy(p.copy()) for p in start],
                               tc)
    ref = port_train.Optimizer([torch.from_numpy(p.copy()) for p in start],
                               tc)
    for count in range(5):
        grads = [torch.from_numpy(rs.randn(*s).astype(np.float32))
                 for s in shapes]
        got.step(grads)
        python_float_update(ref, grads, count)
        for a, b in zip(got.params, ref.params):
            assert torch.equal(a, b), count
    for k in got.slots:
        for a, b in zip(got.slots[k], ref.slots[k]):
            assert torch.equal(a, b), k
    assert float(got.neg_lr) == np.float32(-got.schedule(4))
    assert got.count == 5


@pytest.mark.parametrize("op", ["mul", "div"])
def test_foreach_by_a_0d_tensor_is_by_the_scalar(op):
    """`_foreach_mul` / `_foreach_div` by a 0-d fp32 tensor holding a
    Python float give the bits of the same call by the float."""
    rs = np.random.RandomState(3)
    xs = [torch.from_numpy(rs.randn(*s).astype(np.float32))
          for s in [(64,), (7, 9), (3, 5, 2)]]
    fn = getattr(torch, f"_foreach_{op}")
    for value in (-0.1 * 0.94 ** 3, 1.0 - 0.999 ** 7, -1e-3 / 3):
        by_tensor = fn(xs, torch.tensor(value, dtype=torch.float32))
        for a, b in zip(fn(xs, value), by_tensor):
            assert torch.equal(a, b), value


# ------------------------------------------------------------ the step

def test_microbatch_generators_draw_todays_masks(monkeypatch):
    """accumulate_steps = 2 with dropout and the on-card flip: one
    generator a microbatch (and one for the flip), reseeded before the
    device work, gives the step that one generator reseeded right before
    each draw gives, over two steps."""
    cfg = _tiny(flip=True, accumulate_steps=2)
    batches = _batches(cfg, 2, uint8=True)
    new = port_train.create_train_state(cfg, "cpu")
    want = [port_train.train_step(new, b, cfg) for b in batches]

    old = port_train.create_train_state(cfg, "cpu")
    g = torch.Generator()
    old.generators, old.flip_generator = [g, g], g
    micro = [0]
    real_dropout, real_flip = port_gvcnn.dropout, port_train._draw_flip

    def dropout(x, keep_prob, generator, rows=None):
        generator.manual_seed(port_train.dropout_seed(
            cfg.train.seed, old.step, micro[0]))
        micro[0] += 1
        return real_dropout(x, keep_prob, generator, rows)

    def draw_flip(state, config, shape):
        micro[0] = 0
        port_train._seed_flip(state, config)
        return real_flip(state, config, shape)

    monkeypatch.setattr(port_gvcnn, "dropout", dropout)
    monkeypatch.setattr(port_train, "_draw_flip", draw_flip)
    got = [port_train.train_step(old, b, cfg) for b in batches]
    assert micro[0] == 2
    for a, b in zip(got, want):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    _same_state(old, new)


def test_compile_train_step_on_the_cpu_is_train_step():
    cfg = _tiny()
    batches = _batches(cfg, 3)
    ref = port_train.create_train_state(cfg, "cpu")
    state = port_train.create_train_state(cfg, "cpu")
    step = port_train.compile_train_step(state, cfg, batches[0])
    assert step.graph is None
    for b in batches:
        want = port_train.train_step(ref, b, cfg)
        got = step(state, b, cfg)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    _same_state(state, ref)


def _resident(cfg, n=3, seed=5):
    """Batches of a staged split: the split's views and labels, and each
    step's indices."""
    d = cfg.data
    rs = np.random.RandomState(seed)
    views = torch.from_numpy(rs.randint(
        0, 256, (10, d.num_views, d.height, d.width, 3)).astype(np.uint8))
    labels = torch.from_numpy(rs.randint(0, d.num_classes, 10))
    return [{"views": views, "label": labels,
             "idx": torch.from_numpy(rs.permutation(10)[:d.batch_size])}
            for _ in range(n)]


VARIANTS = {
    "momentum_dropout": (dict(), False),
    "adam_flip_accumulate": (dict(optimizer="adam", accumulate_steps=2,
                                  lr_decay_steps=1, lr_decay_rate=0.9,
                                  warmup_steps=2), True),
    "resident_remat": (dict(), "resident"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_recorded_step_is_the_eager_step(recorder, counted, variant):
    """4 calls of the compiled step through the recorder (the warm-up, a
    capture and its replay, two replays) equal 4 eager steps bit for bit:
    metrics, parameters, statistics, slots; each step moves the launch
    counters as the eager step does (one K2 and one K1 a microbatch, K2
    twice under `remat_until`, which recomputes the stem), and the graph is
    captured once."""
    kw, mode = VARIANTS[variant]
    cfg = _tiny(flip=mode is True, **kw)
    if mode == "resident":
        cfg = cfg.replace(remat_until="MaxPool_3a_3x3")
        batches = _resident(cfg, 4)
    else:
        batches = _batches(cfg, 4, uint8=mode is True)
    ref = port_train.create_train_state(cfg, "cpu")
    state = port_train.create_train_state(cfg, "cpu")
    step = port_train.compile_train_step(state, cfg, batches[0])
    for b in batches:
        before = _counts()
        want = port_train.train_step(ref, b, cfg)
        eager = tuple(a - c for a, c in zip(_counts(), before))
        before = _counts()
        got = step(state, b, cfg)
        assert tuple(a - c for a, c in zip(_counts(), before)) == eager
        k = cfg.train.accumulate_steps
        assert eager == (2 * k if cfg.remat_until else k, k)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    _same_state(state, ref)
    assert (step.graph.captures, step.graph.replays) == (1, 3)
    [rec] = recorder
    k = max(cfg.train.accumulate_steps, 1)
    assert rec.generators == state.generators[:k] + [state.flip_generator]
    assert rec.modes == ["thread_local"]
    assert list(step.graph.inputs) == (["idx"] if mode == "resident"
                                       else ["views", "label"])


def test_recorded_step_metrics_are_fresh(recorder):
    """The metrics of a replayed step are copies: the next replay leaves
    them as they were."""
    cfg = _tiny()
    batches = _batches(cfg, 4)
    state = port_train.create_train_state(cfg, "cpu")
    step = port_train.compile_train_step(state, cfg, batches[0])
    mets = [step(state, b, cfg) for b in batches[:3]]
    kept = {k: v.clone() for k, v in mets[1].items()}
    step(state, batches[3], cfg)
    for k in kept:
        assert torch.equal(mets[1][k], kept[k])
    assert mets[1]["loss"].data_ptr() != mets[2]["loss"].data_ptr()


def test_replays_read_the_rate_and_seeds_written_before_them(recorder,
                                                              monkeypatch):
    """Each replay reads -lr(count) and each microbatch's dropout seed as
    the host wrote them for that step (the recorder reruns the captured
    function, so its reads are the replay's)."""
    cfg = _tiny(accumulate_steps=2, lr_decay_steps=1, lr_decay_rate=0.5)
    batches = _batches(cfg, 4)
    state = port_train.create_train_state(cfg, "cpu")
    rates, seeds = [], []
    real_apply, real_dropout = port_train.Optimizer.apply, port_gvcnn.dropout

    def apply(self, grads):
        rates.append(float(self.neg_lr))
        return real_apply(self, grads)

    def dropout(x, keep_prob, generator, rows=None):
        seeds.append(generator.initial_seed())
        return real_dropout(x, keep_prob, generator, rows)

    monkeypatch.setattr(port_train.Optimizer, "apply", apply)
    monkeypatch.setattr(port_gvcnn, "dropout", dropout)
    step = port_train.compile_train_step(state, cfg, batches[0])
    for b in batches:
        step(state, b, cfg)
    sched = port_train.make_lr_schedule(cfg.train)
    assert rates == [float(np.float32(-sched(t))) for t in range(4)]
    assert seeds == [port_train.dropout_seed(cfg.train.seed, t, i)
                     for t in range(4) for i in range(2)]


def test_replays_advance_the_launch_counters(recorder, counted):
    """A capture launches nothing, so it puts the counters back; each
    replay adds what the capture moved, once."""
    cfg = _tiny()
    b = _batches(cfg, 1)[0]
    state = port_train.create_train_state(cfg, "cpu")
    step = port_train.compile_train_step(state, cfg, b)
    start = _counts()
    step(state, b, cfg)                        # the warm-up, eager
    assert _counts() == (start[0] + 1, start[1] + 1)
    graph = step.graph
    graph._capture()                           # a capture alone
    assert _counts() == (start[0] + 1, start[1] + 1)
    assert graph._delta == {"stem_conv7x7s2_f32": 1, "group_and_fuse_f32": 1}
    for n in range(2, 5):
        graph._replay()
        assert _counts() == (start[0] + n, start[1] + n)


def test_the_counter_carries_a_name_the_graphs_were_never_told(recorder):
    """The graphs snapshot, restore and add the launch counter as a whole:
    an entry point no module names before the call is put back after the
    capture and advanced by each replay like the kernels' own."""
    name = "an_entry_point_of_no_kernel_module"
    x = torch.zeros(3)

    def fn():
        launches[name] += 1
        return x + 1

    call = graphs.CapturedCall("counted", fn, {"x": x}, device="cpu")
    try:
        call(x=x)                              # the warm-up, eager
        assert launches[name] == 1
        call._capture()                        # a capture alone
        assert launches[name] == 1
        assert call._delta == {name: 1}
        for n in range(2, 5):
            call._replay()
            assert launches[name] == n
    finally:
        del launches[name]


# ------------------------------------------------------ graphs in general

def _eval_cfg():
    return _tiny(keep=1.0)


def _eval_model(cfg):
    model = port_gvcnn.init_weights(port_gvcnn.build_model(cfg), 0).eval()
    model.requires_grad_(False)
    return model


def test_a_moved_storage_recaptures_and_an_inplace_reload_does_not(
        recorder):
    """An eval graph keyed on the model's storages: weights loaded in place
    change the replayed answer without a capture; a parameter given new
    storage makes the next call capture again."""
    cfg = _eval_cfg()
    model = _eval_model(cfg)
    b = _batches(cfg, 1)[0]
    g = port_eval.eval_graph(model, b)
    with torch.no_grad():
        for _ in range(3):
            hits, logits = g(views=b["views"], label=b["label"])
        first = logits.clone()
        other = _eval_model(cfg.replace(train=dataclasses.replace(
            cfg.train, seed=1)))
        model.load_state_dict(port_gvcnn.init_weights(other, 1).state_dict())
        g(views=b["views"], label=b["label"])
        assert g.captures == 1 and not torch.equal(g.outputs[1], first)
        w = model.Logits.weight
        w.data = w.data.clone()
        g(views=b["views"], label=b["label"])
    assert (g.captures, g.replays) == (2, 4)
    assert port_eval.eval_graph(model, b) is g


def test_a_failed_capture_names_the_call_and_the_line(recorder, counted):
    """A capture that raises gives `GraphCaptureError` with the call's name
    and the port's line where it broke; the counters stay as they were and
    no graph is kept."""
    x = torch.zeros(1, 8, 8, 3)
    call = graphs.CapturedCall(
        "a stem at int8", lambda: stem_kernel.kernel_name(torch.int8),
        {"x": torch.zeros_like(x)}, device="cpu")
    before = _counts()
    with pytest.raises(graphs.GraphCaptureError,
                       match=r"capturing a stem at int8 as a CUDA graph "
                             r"failed at gvcnn_tf_tpu_torch/ops/"
                             r"stem_kernel\.py:\d+ in kernel_name.*"
                             r"TypeError"):
        call._capture()
    assert _counts() == before and call._graph is None


def test_the_caches_compute_while_capturing(monkeypatch):
    """While a graph is captured, the stem's packed weight and BatchNorm's
    scale and shift are computed, not looked up or stored."""
    from gvcnn_tf_tpu_torch.models.backbones import layers

    w = torch.randn(64, 3, 7, 7)
    bn = layers.BatchNorm(64).eval()
    with torch.no_grad():
        cached = stem_kernel._packed_weight(w)
        affine = bn.scale_shift()
        assert stem_kernel._packed_weight(w) is cached
        assert bn.scale_shift() is affine
        monkeypatch.setattr(stem_kernel, "capturing", lambda: True)
        monkeypatch.setattr(layers, "capturing", lambda: True)
        fresh = stem_kernel._packed_weight(w)
        assert fresh is not cached and torch.equal(fresh, cached)
        assert w._stem_packed[1] is cached
        again = bn.scale_shift()
        assert again is not affine and bn._affine[1] is affine
        for a, b in zip(again, affine):
            assert torch.equal(a, b)


# ------------------------------------------------------- the entry points

def test_a_dropped_graph_is_freed_without_the_collector(monkeypatch):
    """The graphs of a train step, an eval model and an engine bucket hold
    no reference cycle: with the garbage collector off, each is freed as
    soon as its owner drops it (a graph left for the collector would keep
    its memory pool, which a later capture cannot reach)."""
    import gc
    import weakref

    from gvcnn_tf_tpu_torch.serve import InferenceEngine

    cfg = _eval_cfg()
    b = _batches(cfg, 1)[0]
    engine = InferenceEngine(cfg, serve_batch_size=4, device="cpu")
    monkeypatch.setattr(graphs, "capturable", lambda device: True)
    was_on = gc.isenabled()
    gc.disable()
    try:
        state = port_train.create_train_state(cfg, "cpu")
        step = port_train.compile_train_step(state, cfg, b)
        step(state, b, cfg)                    # the warm-up
        refs = [weakref.ref(step.graph)]
        del step
        model = _eval_model(cfg)
        with torch.no_grad():
            port_eval.eval_graph(model, b)(views=b["views"], label=b["label"])
        refs += [weakref.ref(g) for g in port_eval._GRAPHS[model].values()]
        del model
        chunk = np.zeros((4, 2, 32, 32, 3), np.uint8)
        refs.append(weakref.ref(engine._graph(chunk)))
        engine.graphs.clear()
        assert [r() for r in refs] == [None] * 3
    finally:
        if was_on:
            gc.enable()
        engine.close()


def test_engine_replays_each_bucket(recorder):
    """The engine captures one graph a bucket at start-up (in one pool) and
    replays it for each request: the results are the eager engine's."""
    from gvcnn_tf_tpu_torch.serve import InferenceEngine

    cfg = _eval_cfg()
    views = np.random.RandomState(2).randint(
        0, 256, (5, 2, 32, 32, 3)).astype(np.uint8)
    engine = InferenceEngine(cfg, serve_batch_size=4, device="cpu")
    try:
        # Float requests go as float32 on this config's wire.
        u8, f32 = np.dtype(np.uint8), np.dtype(np.float32)
        assert set(engine.graphs) == {(1, u8), (4, u8), (1, f32), (4, f32)}
        assert all(g.captures == 1 and g.replays == 1
                   for g in engine.graphs.values())
        got = engine.predict(views)            # chunks of 4 and 1
        assert engine.graphs[(4, u8)].replays == 2
        assert engine.graphs[(1, u8)].replays == 2
        assert engine.graphs[(4, f32)].replays == 1
    finally:
        engine.close()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "capturable", lambda device: False)
        eager = InferenceEngine(cfg, serve_batch_size=4, device="cpu")
        try:
            assert eager.graphs == {}
            want = eager.predict(views)
        finally:
            eager.close()
    assert got == want


def test_evaluate_through_the_graph_scores_as_eager(recorder):
    """`evaluate` on 3 padded batches through the eval graph (the warm-up,
    a capture, a replay) gives the eager counts and logits."""
    cfg = _eval_cfg()
    d = cfg.data
    rs = np.random.RandomState(4)
    data = [{"views": rs.randint(0, 256, (n, 2, 32, 32, 3)).astype(np.uint8),
             "label": rs.randint(0, d.num_classes, n)} for n in (4, 4, 3)]
    variables = port_train.create_train_state(cfg, "cpu")
    results = []
    for capture in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if not capture:
                mp.setattr(graphs, "capturable", lambda device: False)
            with port_eval.recorded_logits() as seen:
                res = port_eval.evaluate(cfg, dataset_iter=iter(data),
                                         state=variables, per_class=True,
                                         device="cpu")
        results.append((res, torch.cat(seen)))
    (got, got_logits), (want, want_logits) = results
    assert got == want and got["count"] == 11
    assert torch.equal(got_logits, want_logits)
    [g] = port_eval._GRAPHS[variables.model].values()
    assert (g.captures, g.replays) == (1, 2)


def test_train_loop_runs_the_compiled_step(recorder, tmp_path, capsys):
    """`train()` on a device that captures runs the compiled step, logs it
    once, and ends where the eager loop ends."""
    cfg = _tiny(keep=0.5, train_logdir=str(tmp_path / "a"),
                checkpoint_every=0, log_every=1)
    data = [{k: v.numpy() for k, v in b.items()} for b in _batches(cfg, 4)]
    state, mets = port_train.train(cfg, num_steps=4, dataset_iter=iter(data),
                                   device="cpu")
    assert "the step runs as one CUDA graph" in capsys.readouterr().err
    assert len(recorder) == 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "capturable", lambda device: False)
        ref, ref_mets = port_train.train(
            cfg.replace(train=dataclasses.replace(
                cfg.train, train_logdir=str(tmp_path / "b"))),
            num_steps=4, dataset_iter=iter(data), device="cpu")
    assert mets == ref_mets
    _same_state(state, ref)


def test_recorded_step_tracks_the_jax_step(recorder):
    """Three steps of the compiled step (through the recorder) track the
    JAX package's jitted step on the same bridged weights and batches, at
    `test_torch_train.py`'s bounds."""
    kw = dict(learning_rate=0.01, accumulate_steps=2)
    jcfg, pcfg = _tiny(jax_configs, keep=1.0, **kw), _tiny(keep=1.0, **kw)
    model, tx, jstate = jax_train.create_train_state(jcfg, jax.random.key(0))
    jstep = jax.jit(jax_train.make_train_step(model, tx, jcfg))
    state = port_train.create_train_state(pcfg, "cpu")
    state.model.load_state_dict(jax_to_state_dict(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})))
    batches = _batches(pcfg, 3, seed=1)
    step = port_train.compile_train_step(state, pcfg, batches[0])
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, {"views": jnp.asarray(b["views"].numpy()),
                                    "label": jnp.asarray(b["label"].numpy())},
                           jax.random.key(1))
        pm = step(state, b, pcfg)
        for k in ("loss", "grad_norm", "accuracy"):
            assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-4), (
                i, k)
    assert step.graph.replays == 2
    got = dict(_flat(state_dict_to_jax(state.model.state_dict())))
    want = dict(_flat(jax.device_get({"params": jstate.params,
                                      "batch_stats": jstate.batch_stats})))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_graph_modules_import_no_jax():
    code = ("import sys, gvcnn_tf_tpu_torch.utils.graphs, "
            "gvcnn_tf_tpu_torch.train, gvcnn_tf_tpu_torch.serve, "
            "gvcnn_tf_tpu_torch.eval; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert 'gvcnn_tf_tpu' not in sys.modules, 'gvcnn_tf_tpu'")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
