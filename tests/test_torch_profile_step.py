"""`tools/profile_step.py` of the port on the CPU: per-layer attribution of
a real train step, forward and backward apart.

- The pins: `_LAYER` and `classify` are the JAX tool's, source for source.
- The layer keys: the layers that own time in the port's CPU profile of a
  tiny mn40_12view train step (fp32, B = 2, 2 views of 32x32) are the
  layers the JAX tool's `aggregate(parse_entry(flagship_hlo("train",
  ...)))` names at the same config (the JAX package's `get_config`
  patched to the tiny shapes for that call only); every layer with a conv
  (the convs, the Mixed blocks, the scoring FCN) and every pool shows both
  forward and backward time in the port; a conv's dgrad and wgrad
  (`convolution_backward`) always land under a layer.
- The stem op lands under Conv2d_1a_7x7's forward, the grouping op in its
  own row, and under `remat_until=MaxPool_3a_3x3` the prefix's rerun in
  the backward is tagged `recompute` (the stem op twice: fwd and
  recompute) and the layers after it have none.
- The card's parsing, on canned trace events: a kernel is tied to the
  range around its launch by correlation id, else through its external
  id; one with neither is `unattributed`; of several windows the fullest
  with the median time is read; the idle share of a window.
- The residual buckets add up to the step, the optimizer's `_foreach_`
  update is the tail, activation saves count a storage once and leave out
  parameters; `--trace` writes the JAX tool's format; `--mode fwd`;
  `--hlo-in` is refused.
"""

import dataclasses
import inspect
import json

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from gvcnn_tf_tpu.tools import profile_step as jax_ps  # noqa: E402
from gvcnn_tf_tpu_torch import get_config  # noqa: E402
from gvcnn_tf_tpu_torch.tools import profile_step as ps  # noqa: E402

B, V, HW = 2, 2, 32
CONV_LAYERS = ["Conv2d_1a_7x7", "Conv2d_2b_1x1", "Conv2d_2c_3x3",
               "GroupingModule"] + [f"Mixed_{b}" for b in (
                   "3b", "3c", "4b", "4c", "4d", "4e", "4f", "5b", "5c")]
POOLS = ["MaxPool_2a_3x3", "MaxPool_3a_3x3", "MaxPool_4a_3x3",
         "MaxPool_5a_2x2"]


def tiny(cfg, **kw):
    return cfg.replace(compute_dtype="float32", **kw,
                       data=dataclasses.replace(cfg.data, batch_size=B,
                                                num_views=V, height=HW,
                                                width=HW))


def _run(capsys, **kw):
    out = ps.run(device="cpu", top=1000, residual=True, windows=1, **kw)
    capsys.readouterr()
    return out


@pytest.fixture(scope="module")
def train_profile():
    """The CPU profile of one tiny train step, and its kernel rows."""
    cfg = tiny(get_config("mn40_12view"))
    dev = torch.device("cpu")
    fn, model, data = ps.make_step(cfg, "train", dev)
    fn()
    tracker = ps.LayerTracker(model, exclude=data)
    rows = ps.kernel_rows(ps.trace_events(fn, dev, tracker), dev)
    return rows, tracker


def test_layer_regex_and_classify_are_the_jax_tools():
    assert ps._LAYER.pattern == jax_ps._LAYER.pattern
    assert inspect.getsource(ps.classify) == inspect.getsource(
        jax_ps.classify)


def test_owned_layers_equal_the_jax_tools(train_profile, monkeypatch):
    import gvcnn_tf_tpu.configs as jax_configs

    rows, _ = train_profile
    port = {r["layer"] for r in ps.aggregate(rows)[0]
            if not r["layer"].startswith("(")}
    real = jax_configs.get_config
    monkeypatch.setattr(jax_configs, "get_config", lambda name: real(
        name).replace(data=dataclasses.replace(
            real(name).data, num_views=V, height=HW, width=HW)))
    hlo = jax_ps.flagship_hlo("train", B, "mn40_12view")
    want = {r["layer"] for r in jax_ps.aggregate(jax_ps.parse_entry(hlo))[0]
            if not r["layer"].startswith("(")}
    assert port == want
    assert port == set(CONV_LAYERS + POOLS + ["Logits"])


def test_every_conv_layer_and_pool_has_fwd_and_bwd(train_profile):
    rows, _ = train_profile
    by = {r["layer"]: r for r in ps.aggregate(rows)[0]}
    for layer in CONV_LAYERS + POOLS:
        assert by[layer]["fwd_ms"] > 0 and by[layer]["bwd_ms"] > 0, layer
        assert by[layer]["recompute_ms"] == 0 == by[layer]["other_ms"]


def test_conv_gradients_land_under_their_layers(train_profile):
    rows, tracker = train_profile
    grads = [r["op_name"] for r in rows
             if r["op_name"].endswith("aten::convolution_backward")]
    assert grads and all(
        ps.layer_and_phase(n) in {(k, "bwd") for k in CONV_LAYERS}
        for n in grads), grads
    # One dgrad/wgrad op a conv of the backbone and the FCN but the stem
    # (StemConvFunction's backward: one too), as many as the forward's.
    convs = sum(n for name, n in tracker.ops.items()
                if name.endswith("aten::convolution"))
    stems = sum(n for name, n in tracker.ops.items()
                if name.endswith("gvcnn::stem_conv7x7s2"))
    assert len(grads) == convs + stems


def test_the_hand_written_ops_land_in_their_rows(train_profile):
    rows, _ = train_profile
    stem = [ps.layer_and_phase(r["op_name"]) for r in rows
            if r["op_name"].endswith("gvcnn::stem_conv7x7s2")]
    group = [ps.layer_and_phase(r["op_name"]) for r in rows
             if r["op_name"].endswith("gvcnn::group_and_fuse")]
    assert stem == [("Conv2d_1a_7x7", "fwd")]
    assert group == [("(gvcnn::group_and_fuse)", "fwd")]


def test_remat_prefix_is_tagged_recompute(capsys):
    cfg = tiny(get_config("mn40_12view"), remat_until="MaxPool_3a_3x3")
    out = _run(capsys, cfg=cfg)
    by = {r["layer"]: r for r in out["layers_top"]}
    prefix = ["Conv2d_1a_7x7", "MaxPool_2a_3x3", "Conv2d_2b_1x1",
              "Conv2d_2c_3x3", "MaxPool_3a_3x3"]
    for layer in prefix:
        assert by[layer]["recompute_ms"] > 0, layer
        assert out["op_counts"][layer]["recompute"] > 0
    rest = [r for r in out["layers_top"] if r["layer"] not in prefix]
    assert rest and all(r["recompute_ms"] == 0 for r in rest)
    assert out["hand_written_kernels"]["stem"] == {
        "Conv2d_1a_7x7:fwd": 1, "Conv2d_1a_7x7:recompute": 1}
    assert out["residual"]["buckets_ms"]["layer_recompute"] > 0


def test_residual_buckets_and_activation_saves(capsys, tmp_path):
    cfg = tiny(get_config("mn40_12view"))
    trace = tmp_path / "t.json"
    out = _run(capsys, cfg=cfg, trace=str(trace))
    res = out["residual"]
    assert sum(res["buckets_ms"].values()) == pytest.approx(
        res["total_device_ms"], abs=0.01)
    assert res["total_device_ms"] == out["device_ms"]
    assert res["device_idle"] is None            # not measured on the CPU
    assert "unattributed" not in res["buckets_ms"]
    assert out["attributed_share"] == 1.0
    for k in ("layer_fwd", "layer_bwd", "optimizer_tail",
              "shared_other_fwd", "shared_other_bwd"):
        assert res["buckets_ms"][k] > 0, k
    saves = res["activation_save"]
    assert saves["tensors"] > 0 and saves["bytes"] > 0
    assert saves["top"][0]["mb"] >= saves["top"][-1]["mb"]
    assert out["kernels"] == out["dispatched_ops"]
    # The trace: one complete event a row, on the four phase tracks.
    events = json.loads(trace.read_text())["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == out["kernels"] and xs[0]["ts"] == 0.0
    assert {e["tid"] for e in xs} == {1, 2, 3}
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert names == {"fwd", "bwd", "other", "recompute"}


def test_activation_saves_count_a_storage_once():
    lin = torch.nn.Linear(8, 8)
    model = torch.nn.Sequential(lin, torch.nn.Tanh())
    x = torch.randn(4, 8)
    with ps.LayerTracker(model, exclude=[x]) as tr:
        y = model(x)
        z = y * y                            # saves y twice: one storage
        z.sum().backward()
    sizes = sorted(b for b, _, _ in tr.saved.values())
    # Tanh's output (4 x 8 fp32) once; x and the weight are left out.
    assert sizes == [4 * 8 * 4]
    assert lin.weight.grad is not None


def test_optimizer_update_is_the_tail():
    rows = [dict(op_name=n, ts=i, us=1.0, kernel=None) for i, n in
            enumerate(["train_step/jvp(GVCNN)/InceptionV1/Mixed_3b/aten::mm",
                       "train_step/transpose(jvp(GVCNN))/InceptionV1/"
                       "Mixed_3b/aten::mm",
                       "train_step/transpose(jvp())/aten::copy_",
                       "train_step/aten::_foreach_add_",
                       "train_step/aten::copy_"])]
    b = ps.residual_decomposition(rows)["buckets_ms"]
    assert b == {"layer_fwd": 0.001, "layer_bwd": 0.001,
                 "data_movement": 0.001, "optimizer_tail": 0.002}


def _ev(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid,
                args=args)


def test_kernels_are_tied_to_the_range_around_their_launch():
    cuda = torch.device("cuda", 0)
    fwd = "train_step/jvp(GVCNN)/InceptionV1/Conv2d_1a_7x7/gvcnn::stem"
    bwd = "train_step/transpose(jvp(GVCNN))/InceptionV1/Mixed_3b/aten::mm"
    events = [
        _ev("user_annotation", ps.WINDOW, 0, 100),
        _ev("user_annotation", fwd, 10, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=7),
        _ev("user_annotation", bwd, 30, 10, tid=2),
        _ev("cpu_op", "aten::mm", 31, 8, tid=2, **{"External id": 99}),
        _ev("kernel", "stem_conv_mma_kernel", 40, 5, tid=9, correlation=7),
        _ev("kernel", "sm90_gemm", 50, 6, tid=9, correlation=8,
            **{"External id": 99}),
        _ev("gpu_memset", "Memset", 60, 1, tid=9, correlation=9),
    ]
    rows = ps.kernel_rows(events, cuda)
    assert [(r["op_name"], r["us"], r["kernel"]) for r in rows] == [
        (fwd, 5, "stem_conv_mma_kernel"), (bwd, 6, "sm90_gemm"),
        (ps.UNATTRIBUTED, 1, "Memset")]
    # Busy 12 us of the window's 100.
    assert ps.device_idle(events) == pytest.approx(0.88)
    b = ps.residual_decomposition(rows)["buckets_ms"]
    assert b["unattributed"] == 0.001


def test_the_fullest_window_with_the_median_time_is_read():
    def window(*us):
        return [dict(op_name="x", ts=i, us=u, kernel="k")
                for i, u in enumerate(us)]

    lost, a, b, c = window(5), window(5, 5), window(6, 6), window(9, 9)
    assert ps.choose_window([lost, c, a, b]) is b
    assert ps.choose_window([a, lost]) is a
    with pytest.raises(RuntimeError, match="no event"):
        ps.choose_window([[], []])


def test_forward_mode(capsys):
    out = _run(capsys, mode="fwd", cfg=tiny(get_config("mn40_12view")))
    phases = {p for r in out["op_counts"].values() for p in r}
    assert phases <= {"fwd", "other"}
    by = {r["layer"]: r for r in out["layers_top"]}
    for layer in CONV_LAYERS + POOLS + ["Logits"]:
        assert by[layer]["fwd_ms"] > 0 and by[layer]["bwd_ms"] == 0
    assert out["residual"]["activation_save"]["tensors"] == 0


def test_hlo_in_is_refused(capsys):
    with pytest.raises(SystemExit):
        ps.main(["--hlo-in", "step.hlo", "--device", "cpu"])
    assert "--hlo-in" in capsys.readouterr().err


def test_cli_runs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(ps, "phase_config",
                        lambda name, batch, dev: tiny(get_config(name)))
    out = ps.main(["--device", "cpu", "--batch", "1", "--top", "3"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out and len(out["layers_top"]) == 3
    assert out["device"] == "cpu" and out["card"] is None
    assert out["timebase"] == "host op ranges (cpu)"
    assert "residual" not in out and out["batch"] == 2
