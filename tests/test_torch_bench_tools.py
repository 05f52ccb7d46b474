"""The port's step-analysis tools on the CPU: Inception-v1's
`start_endpoint`, the work count, `tools/bench_layers.py` and
`tools/bench_phases.py`.

- `start_endpoint` against JAX: the port's segment and the JAX package's
  on the same bridged weights (the full tower's, BatchNorm calibrated as in
  `tests/test_torch_backbones.py`), on the activation at the start
  endpoint, fp32, B = 2 at 32x32: features and every endpoint within
  1e-4 x max|ref| (the v1 parity tests' bound: fp32 summed in another
  order by XLA:CPU and oneDNN), in eval and in train mode.  Prefix then
  segment equals the full tower bit for bit (the same ops on the same
  tensors), in both modes; the segment's state_dict keys are the full
  tower's after the start.  Errors as in JAX.
- The count: K2 by hand (`stem_work`) equals flop_counter's count of its
  plain version's conv and the bytes of its inputs and output; under the
  counter the wrappers are one op whichever implementation runs (a tower's
  totals are the same with the stem's and the grouping head's forwards
  replaced by other implementations).  A truncated tower's conv FLOPs
  less their padded taps equal the JAX tower's `cost_analysis()` flops
  within 2%: XLA counts only the taps inside the input and adds one FLOP
  an element for BatchNorm, ReLU and the pool's compares (~0.9% here).
- `bench_layers.run`, both methods, and `bench_phases.run` on the CPU: the
  JAX tools' keys and this port's; the `--out` table; the peaks table;
  without `--device cpu` and without a card both raise.
- A child process imports the three tools, and the six of
  `tests/test_torch_profile_step.py` and `tests/test_torch_variant_tools.py`,
  and neither JAX nor the JAX package.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from gvcnn_tf_tpu.models.backbones.inception_v1 import (  # noqa: E402
    InceptionV1Base as JaxInceptionV1Base,
)
from gvcnn_tf_tpu_torch.bridge import state_dict_to_jax  # noqa: E402
from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import (  # noqa: E402
    ENDPOINTS,
    InceptionV1Base,
)
from gvcnn_tf_tpu_torch.ops import grouping_kernel, stem_kernel  # noqa: E402
from gvcnn_tf_tpu_torch.ops.grouping import (  # noqa: E402
    group_and_fuse as group_and_fuse_plain,
)
from gvcnn_tf_tpu_torch.ops.pool import same_pads  # noqa: E402
from gvcnn_tf_tpu_torch.tools import bench_layers, bench_phases  # noqa: E402
from gvcnn_tf_tpu_torch.tools.bench_layers import (  # noqa: E402
    count_work,
    grouping_work,
    stem_work,
)

from test_torch_backbones import assert_close_rel, calibrate_bn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, HW = 2, 32
FINAL = "Mixed_4b"
JAX_ROW_KEYS = ["endpoint", "ms", "sigma_ms", "noisy", "gflops",
                "attained_tflops", "frac_peak", "intensity",
                "roofline_bound_tflops", "frac_of_bound"]
JAX_SUMMARY_KEYS = ["backbone", "mode", "batch", "height", "dtype", "method",
                    "total_ms", "total_gflops", "mfu", "device"]


@pytest.fixture(scope="module")
def tower():
    """A calibrated port Inception-v1 through FINAL and a B = 2 input."""
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.uniform(-1, 1, (B, HW, HW, 3)).astype(
        np.float32))
    model = InceptionV1Base(final_endpoint=FINAL)
    calibrate_bn(model, x, rs)
    return model, x


def _segment(full, start, final=FINAL, **kw):
    seg = InceptionV1Base(final_endpoint=final, start_endpoint=start, **kw)
    sd = full.state_dict()
    keys = set(seg.state_dict())
    assert keys and keys < set(sd)
    inside = ENDPOINTS[ENDPOINTS.index(start) + 1:ENDPOINTS.index(final) + 1]
    assert {n.split(".")[0] for n in keys} <= set(inside)
    assert all(n in keys for n in sd if n.split(".")[0] in inside)
    seg.load_state_dict({k: v for k, v in sd.items() if k in keys})
    return seg


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("start,final,train", [
    ("MaxPool_3a_3x3", "Mixed_4b", False),
    ("Conv2d_2c_3x3", "Mixed_3c", True)])
def test_segment_matches_the_jax_segment(tower, start, final, train):
    """In train mode through Mixed_3c: its 4x4 maps give BatchNorm 32
    values a channel (Mixed_4b's 2x2 give 8, where both packages' fp32
    rounding of the batch statistics is amplified past the bound)."""
    full, x = tower
    with torch.no_grad():
        z = full.eval()(x)[1][start]
    seg = _segment(full, start, final).train(train)
    variables = state_dict_to_jax(seg.state_dict())
    jmodel = JaxInceptionV1Base(final_endpoint=final, start_endpoint=start)
    if train:
        (jf, jeps), _ = jax.jit(functools.partial(
            jmodel.apply, train=True, mutable=["batch_stats"]))(
                variables, _nhwc(z))
    else:
        jf, jeps = jax.jit(functools.partial(jmodel.apply, train=False))(
            variables, _nhwc(z))
    with torch.no_grad():
        feats, eps = seg(z)
    names = list(ENDPOINTS[ENDPOINTS.index(start) + 1:
                           ENDPOINTS.index(final) + 1])
    assert list(eps) == names and set(jax.device_get(jeps)) == set(names)
    assert_close_rel(_nhwc(feats), np.asarray(jf), msg="features")
    for k in names:
        assert_close_rel(_nhwc(eps[k]), np.asarray(jeps[k]), msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_prefix_then_segment_is_the_full_tower(tower, train):
    full, x = tower
    start = "Mixed_3b"
    prefix = InceptionV1Base(final_endpoint=start)
    prefix.load_state_dict({k: v for k, v in full.state_dict().items()
                            if k in prefix.state_dict()})
    seg = _segment(full, start)
    for m in (full, prefix, seg):
        m.train(train)
    with torch.no_grad():
        want, weps = full(x)
        z, peps = prefix(x)
        got, seps = seg(z)
    assert torch.equal(got, want)
    assert list(peps) + list(seps) == list(weps)
    for k, v in {**peps, **seps}.items():
        assert torch.equal(v, weps[k]), k


@pytest.mark.parametrize("kw,match", [
    (dict(start_endpoint="Mixed_9z"), "unknown endpoint"),
    (dict(start_endpoint="Mixed_4b"), "must precede"),
    (dict(start_endpoint="Mixed_4c"), "must precede"),
    (dict(start_endpoint="Mixed_3b", stem_space_to_depth=True), "no stem"),
    (dict(start_endpoint="Mixed_3b", remat_until="MaxPool_3a_3x3"),
     "remat_until"),
])
def test_bad_segments_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        InceptionV1Base(final_endpoint="Mixed_4b", **kw)


def test_remat_inside_a_segment_equals_the_plain_segment(tower):
    full, x = tower
    start = "MaxPool_3a_3x3"
    with torch.no_grad():
        z = full.eval()(x)[1][start]
    grads = []
    for remat in ("", "Mixed_3c"):
        seg = _segment(full, start, remat_until=remat)
        zz = z.clone().requires_grad_()
        seg.train()(zz)[0].square().sum().backward()
        grads.append([zz.grad] + [p.grad for p in seg.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- count

def test_stem_hand_count_equals_its_plain_version():
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 30, 34, 3).astype(np.float32))
    w = torch.from_numpy(rs.randn(64, 3, 7, 7).astype(np.float32))
    plain = count_work(lambda: stem_kernel.stem_conv_plain(x, w))
    out = stem_kernel.stem_conv_plain(x, w)
    flops, nbytes = stem_work(x, w)
    assert flops == plain.by_op["aten::convolution"][1] == plain.flops
    assert flops == 2 * 2 * 15 * 17 * 64 * 147
    assert nbytes == (x.numel() + w.numel() + out.numel()) * 4
    # Through the wrapper the counter sees the op once, with the hand count.
    op = count_work(lambda: stem_kernel.stem_conv(x, w))
    assert dict(op.by_op) == {bench_layers.STEM_OP: [1, flops, nbytes]}
    # The epilogue adds its scale and shift to the bytes.
    s = torch.ones(64)
    epi = count_work(lambda: stem_kernel.stem_conv(x, w, s, s, relu=True))
    assert epi.bytes == nbytes + 2 * 64 * 4 and epi.flops == flops


def test_grouping_counted_as_one_op():
    rs = np.random.RandomState(1)
    scores = torch.from_numpy(rs.rand(2, 5).astype(np.float32))
    descs = torch.from_numpy(rs.randn(2, 5, 16).astype(np.float32))
    got = count_work(lambda: grouping_kernel.group_and_fuse(scores, descs,
                                                            4))
    assert dict(got.by_op) == {bench_layers.GROUPING_OP: [
        1, *grouping_work(scores, descs, 4)]}
    assert grouping_work(scores, descs, 4) == (
        2 * 4 * 5 * 16 + 2 * 2 * 4 * 16,
        (2 * 5 + 2 * 5 * 16 + 2 * 16 + 2 * 4 + 2 * 4 * 5) * 4)


def _stem_by_unfold(x, weight, scale=None, shift=None, relu=False):
    """Another implementation of K2's function: im2col and a matmul, with
    the op's contract, a contiguous NHWC output (as the kernel's and the
    plain version's: the layout decides what autograd does downstream)."""
    ph = same_pads(x.shape[1], 7, 2)
    pw = same_pads(x.shape[2], 7, 2)
    xn = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                 (pw[0], pw[1], ph[0], ph[1]))
    cols = torch.nn.functional.unfold(xn, 7, stride=2)
    y = (weight.reshape(64, -1) @ cols).reshape(
        x.shape[0], 64, -(-x.shape[1] // 2), -(-x.shape[2] // 2))
    y = y.permute(0, 2, 3, 1).contiguous()
    if scale is not None:
        y = y * scale + shift
    return torch.relu(y) if relu else y


def _grouping_twice(scores, descs, num_group, weight_mode):
    group_and_fuse_plain(scores, descs, num_group, weight_mode)
    fused, weights, scheme = group_and_fuse_plain(scores, descs, num_group,
                                                  weight_mode)
    return fused, weights, scheme.contiguous()


@pytest.mark.parametrize("train", [False, True])
def test_totals_do_not_depend_on_the_kernels_implementation(monkeypatch,
                                                            train):
    """A GVCNN forward (and backward) counted with the plain versions under
    the ops, then with other implementations: the same totals."""
    import dataclasses

    from gvcnn_tf_tpu_torch import configs
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights

    cfg = configs.get_config("mn40_12view")
    cfg = cfg.replace(compute_dtype="float32", data=dataclasses.replace(
        cfg.data, height=HW, width=HW, num_views=3))
    model = init_weights(build_model(cfg), 0).train(train)
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (B, 3, HW, HW, 3)).astype(np.float32))

    def call():
        model.zero_grad(set_to_none=True)
        logits, _ = model(x, generator=torch.Generator().manual_seed(0))
        if train:
            logits.sum().backward()
        return logits

    want = count_work(call)
    assert want.by_op[bench_layers.STEM_OP][0] == 1
    assert want.by_op[bench_layers.GROUPING_OP][0] == 1
    monkeypatch.setattr(stem_kernel, "_stem_forward", _stem_by_unfold)
    monkeypatch.setattr(grouping_kernel, "_forward", _grouping_twice)
    got = count_work(call)
    assert (got.flops, got.bytes) == (want.flops, want.bytes)
    assert dict(got.by_op) == dict(want.by_op)


def _valid_taps(size, k, s):
    lo = same_pads(size, k, s)[0]
    return sum(sum(0 <= o * s - lo + t < size for t in range(k))
               for o in range(-(-size // s)))


def test_conv_flops_agree_with_xla_cost_analysis():
    x = np.random.RandomState(3).uniform(-1, 1, (1, 64, 64, 3)).astype(
        np.float32)
    final = "Conv2d_2c_3x3"
    jm = JaxInceptionV1Base(final_endpoint=final)
    v = jax.jit(functools.partial(jm.init, train=False))(
        {"params": jax.random.key(0)}, x)
    cost = jax.jit(functools.partial(jm.apply, train=False)).lower(
        v, x).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    port = InceptionV1Base(final_endpoint=final).eval()
    with torch.no_grad():
        work = count_work(lambda: port(torch.from_numpy(x)))
    # (input size, kernel, stride, in, out channels) of the tower's convs.
    convs = [(64, 7, 2, 3, 64), (16, 1, 1, 64, 64), (16, 3, 1, 64, 192)]
    full = sum(2 * co * ci * (-(-n // s) * k) ** 2
               for n, k, s, ci, co in convs)
    inside = sum(2 * co * ci * _valid_taps(n, k, s) ** 2
                 for n, k, s, ci, co in convs)
    assert work.flops == full
    assert abs(cost["flops"] - inside) <= 0.02 * inside, (cost["flops"],
                                                          inside)


# ------------------------------------------------------------ the tools

def _check_rows(rows, summary, method, endpoints):
    assert [r["endpoint"] for r in rows] == endpoints
    keys = JAX_ROW_KEYS if method == "marginal" else (
        ["endpoint", "cum_ms"] + [k for k in JAX_ROW_KEYS[1:]
                                  if k not in ("sigma_ms", "noisy")])
    for r in rows:
        assert list(r)[:len(keys)] == keys
        assert r["device_ms"] is None and r["frac_of_bound_device"] is None
        assert r["gflops"] >= 0 and r["bound_ms"] > 0
    conv = [r for r in rows if not r["endpoint"].startswith("MaxPool")]
    assert all(r["gflops"] > 0 for r in conv)
    assert all(k in summary for k in JAX_SUMMARY_KEYS)
    assert summary["method"] == method and summary["device"] == "cpu"
    assert summary["card"] is None and summary["total_device_ms"] is None
    assert summary["mfu"] > 0 and summary["total_gbytes"] > 0


@pytest.mark.parametrize("method,mode", [("marginal", "train"),
                                         ("truncated", "fwd")])
def test_bench_layers_runs_on_the_cpu(tmp_path, capsys, method, mode):
    eps = ["Conv2d_1a_7x7", "MaxPool_2a_3x3", "Mixed_3b"]
    out = tmp_path / "layers.md"
    rows, summary = bench_layers.main([
        "--device", "cpu", "--batch", "2", "--height", "32", "--width",
        "32", "--dtype", "float32", "--mode", mode, "--iters", "2",
        "--method", method, "--endpoints", ",".join(eps), "--merge", "1x1",
        "--out", str(out)])
    _check_rows(rows, summary, method, eps)
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert "port runs the branches unmerged" in printed[0]["note"]
    assert printed[1:] == rows + [{"summary": summary}]
    table = out.read_text().splitlines()
    assert table[0].startswith("# Per-layer timing: inception_v1 " + mode)
    assert "unfused" in table[2]
    assert table[4].startswith("| endpoint | ms |")
    assert [line.split(" | ")[0] for line in table[6:9]] == [
        f"| {e}" for e in eps]
    assert table[10].startswith("Total: ")


def test_bench_layers_falls_back_to_truncated(capsys):
    rows, summary = bench_layers.run(
        "resnet50", batch=1, height=32, width=32, dtype="float32",
        mode="fwd", iters=2, endpoints=["block1"], device="cpu")
    assert summary["method"] == "truncated" and "cum_ms" in rows[0]
    notes = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"note"')]
    assert notes[1] == {"note": "resnet50 has no start_endpoint segment "
                                "support; falling back to --method "
                                "truncated"}


def test_peaks_by_card(monkeypatch):
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert bench_layers.device_peaks(cuda, "bfloat16")["flops"] == 989e12
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    peak = bench_layers.device_peaks(cuda, "float32")
    assert (peak["flops"], peak["bytes"]) == (495e12, 3.35e12)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert bench_layers.device_peaks(cuda, "float32")["flops"] == 67e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "Some Card")
    with pytest.raises(ValueError, match="Some Card"):
        bench_layers.device_peaks(cuda, "bfloat16")
    assert bench_layers.device_peaks(torch.device("cpu"), "bfloat16")[
        "flops"] == 1e12


def test_device_time_keeps_the_most_complete_profiler_window(monkeypatch):
    """A window that lost device records reads low: only the fullest of the
    windows count, and a count that is no multiple of the calls asks for
    more windows; among the fullest windows the median sum is the reading,
    not the largest (the profiler is stubbed: no card here)."""
    windows = iter([{"k": [5.0, 5.0], "m": [1.0]},        # lost records
                    {"k": [5.0, 5.0, 5.0], "m": [1.0]},
                    {"k": [9.0]},
                    {"k": [5.0, 5.0, 5.0], "m": [1.0, 1.0, 1.0]}])
    monkeypatch.setattr(bench_layers, "kernel_durations_us",
                        lambda fn, calls: next(windows))
    cuda = torch.device("cuda", 0)
    assert bench_layers.device_seconds(lambda: None, cuda, calls=3) == (
        pytest.approx(6e-6))
    # Three full windows of 18, 30 and 21 us: their median, 21 us over 3
    # calls (their largest would read 30).
    windows = iter([{"k": [6.0, 6.0, 6.0]}, {"k": [10.0, 10.0, 10.0]},
                    {"k": [7.0, 7.0, 7.0]}])
    monkeypatch.setattr(bench_layers, "kernel_durations_us",
                        lambda fn, calls: next(windows))
    assert bench_layers.device_seconds(lambda: None, cuda, calls=3) == (
        pytest.approx(7e-6))
    monkeypatch.setattr(bench_layers, "kernel_durations_us",
                        lambda fn, calls: {})
    with pytest.raises(RuntimeError, match="no kernel"):
        bench_layers.device_seconds(lambda: None, cuda, calls=3)
    assert bench_layers.device_seconds(lambda: None, torch.device("cpu")) \
        is None


@pytest.mark.parametrize("tool", [bench_layers, bench_phases])
def test_without_a_card_the_tools_raise(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main(["--iters", "1"])


def test_bench_phases_on_the_cpu(capsys):
    out = bench_phases.main(["--device", "cpu", "--iters", "1"])
    assert list(out)[:9] == [
        "config", "batch_shapes", "fwd_ms", "grad_ms", "full_ms",
        "bwd_minus_fwd_ms", "optimizer_state_ms", "device",
        "weight_decay_in_full_only"]
    assert (out["config"], out["batch_shapes"], out["device"]) == (
        "mn40_12view", 2, "cpu")
    assert out["shape"] == [12, 64, 64] and out["compute_dtype"] == "float32"
    assert out["bwd_minus_fwd_ms"] == pytest.approx(
        out["grad_ms"] - out["fwd_ms"], abs=2e-3)
    assert out["launches_per_call"] == {k: {}
                                        for k in ("fwd", "grad", "full")}
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out


def test_the_tools_import_no_jax():
    tools = ["bench_layers", "bench_phases", "analyze_collectives",
             "profile_step", "dump_ops", "check_wire_fusion",
             "bench_variants", "bench_stem", "bench_backend_flags"]
    code = ("import sys, " + ", ".join(f"gvcnn_tf_tpu_torch.tools.{t}"
                                       for t in tools) + "; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert 'gvcnn_tf_tpu' not in sys.modules, 'gvcnn_tf_tpu'")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
