"""The port's variant and segment tools on the CPU: `tools/bench_variants`,
`bench_stem`, `bench_backend_flags`, `check_wire_fusion` and `dump_ops`,
and `build_model`'s line for the JAX package's Pallas switches.

- Pins: `VARIANTS` and `variant_config` are the JAX tool's, the text of the
  block byte for byte and the values equal.
- `bench_variants` on the CPU (tiny mn40_12view: fp32, 2 views of 32x32):
  the JAX tool's keys, the first step's loss printed, `same_program_as` on
  every merge_* row and on pallas_grouping (and on the rows that equal an
  earlier one once those knobs are reset), the wire rows on their wire.
- `check_wire_fusion`: the verdict is "not fused", and the uint8 wire's
  extra buffers are exactly the ops of `normalize_views` (to fp32, / 255,
  x 2, - 1: four fp32 views-sized outputs) and the model's cast to its
  compute dtype (one more), derived by hand; the rest of the two tables
  is equal.
- `dump_ops`: its histogram equals `WorkCounter`'s calls by op, and its
  relayout list holds each cast, copy, clone and cat the segment ran.
- `bench_stem` and `bench_backend_flags` run with `--device cpu` (no
  timing asserted); a setting that raises restores every attribute it set;
  an unknown setting is an error row; the tf32 row is fp32-only and not
  exact.
- Without a card each of the six new tools raises unless given
  `--device cpu`.
"""

import dataclasses
import inspect
import json
import math

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from gvcnn_tf_tpu.tools import bench_variants as jax_bv  # noqa: E402
from gvcnn_tf_tpu_torch import configs  # noqa: E402
from gvcnn_tf_tpu_torch.models.gvcnn import build_model  # noqa: E402
from gvcnn_tf_tpu_torch.tools import (  # noqa: E402
    bench_backend_flags,
    bench_stem,
    bench_variants,
    check_wire_fusion,
    dump_ops,
    profile_step,
)
from gvcnn_tf_tpu_torch.tools.bench_layers import WorkCounter  # noqa: E402

JAX_ROW_KEYS = ["variant", "step_ms", "views_per_sec", "step_gflops",
                "speedup_vs_baseline"]


def tiny(name="mn40_12view", dtype="float32"):
    cfg = configs.get_config(name)
    return cfg.replace(compute_dtype=dtype, data=dataclasses.replace(
        cfg.data, num_views=2, height=32, width=32))


def _block(module):
    """The text from VARIANTS' comment to the end of `variant_config`."""
    src = inspect.getsource(module)
    start = src.index("# (name, config overrides)")
    end = src.index("\n\n\ndef ", src.index("def variant_config"))
    return src[start:end]


def test_variants_are_the_jax_tools():
    assert _block(bench_variants) == _block(jax_bv)
    assert bench_variants.VARIANTS == jax_bv.VARIANTS
    assert inspect.getsource(bench_variants.variant_config) == (
        inspect.getsource(jax_bv.variant_config))


def test_same_program_rows():
    base = configs.get_config("mn40_12view")
    first = {}
    marked = {}
    for name, over in bench_variants.VARIANTS:
        key = bench_variants.same_program(
            bench_variants.variant_config(base, over))
        first.setdefault(key, name)
        if first[key] != name:
            marked[name] = first[key]
    merges = [n for n, _ in bench_variants.VARIANTS if "merge" in n
              and "s2d" not in n]
    assert all(marked[n] == "baseline" for n in merges), marked
    assert marked["pallas_grouping"] == "baseline"
    assert marked["s2d_stem"] == "baseline"
    assert marked["wire_f32"] == "baseline"    # merge_1x1 on the f32 wire
    for n in ("remat", "remat_until_2a", "wire_bf16", "wire_uint8",
              "wire_uint8_flip"):
        assert n not in marked


def test_bench_variants_on_the_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(bench_variants, "base_config",
                        lambda name, dev: tiny(name))
    monkeypatch.setattr(bench_variants, "CHUNK", 1)
    out = tmp_path / "v.md"
    names = ["baseline", "merge_full", "pallas_grouping", "wire_uint8",
             "wire_uint8_flip"]
    rows = bench_variants.main(["--device", "cpu", "--batch", "1",
                                "--iters", "2", "--variants",
                                ",".join(names), "--out", str(out)])
    assert [r["variant"] for r in rows] == names
    for r in rows:
        assert list(r)[:5] == JAX_ROW_KEYS
        assert math.isfinite(r["first_loss"]) and r["step_gflops"] > 0
    by = {r["variant"]: r for r in rows}
    assert by["merge_full"]["same_program_as"] == "baseline"
    assert by["pallas_grouping"]["same_program_as"] == "baseline"
    assert "same_program_as" not in by["wire_uint8"]
    # Same seeded weights, same views: the same program, the same loss.
    assert by["merge_full"]["first_loss"] == by["baseline"]["first_loss"]
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert printed == rows
    table = out.read_text().splitlines()
    assert table[0] == ("# Train-step variants: mn40_12view (batch 1, cpu, "
                        "host clock)")
    assert len(table) == 4 + len(names) + 1


def test_wire_batch_is_the_wire():
    cpu = torch.device("cpu")
    for wire, dtype in (("uint8", torch.uint8), ("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        cfg = bench_variants.variant_config(tiny(), {"transfer_dtype": wire})
        views = bench_variants.wire_batch(cfg, cpu)["views"]
        assert views.dtype == dtype and views.shape == (8, 2, 32, 32, 3)


def test_uint8_wire_adds_the_normalization_buffers(capsys):
    cfg = tiny(dtype="bfloat16")
    report = check_wire_fusion.run(cfg, batch=2, device="cpu")
    capsys.readouterr()
    ref, u8 = report["wire_bfloat16"], report["wire_uint8"]
    n = 2 * 2 * 32 * 32 * 3
    assert report["views_elements"] == n
    # By hand: views.to(float32) / 255 * 2 - 1 (utils/images.py), then the
    # model's cast of the folded views to bf16 (GVCNN._fold).
    want = [("aten::_to_copy", "float32"), ("aten::div", "float32"),
            ("aten::mul", "float32"), ("aten::sub", "float32"),
            ("aten::_to_copy", "bfloat16")]
    assert [(r["op"], r["dtype"]) for r in u8[:5]] == want
    assert all(r["elements"] == n for r in u8[:5])
    strip = [{k: v for k, v in r.items() if k != "name"} for r in u8[5:]]
    assert strip == [{k: v for k, v in r.items() if k != "name"}
                     for r in ref]
    assert report["uint8_extra_materializations"] == 5
    assert report["uint8_extra_bytes"] == 4 * 4 * n + 2 * n
    assert report["verdict"].startswith("NOT FUSED: uint8 wire "
                                        "materializes 5 extra")


def test_dump_ops_histogram_equals_the_work_count(tmp_path, capsys):
    full = tmp_path / "ops.txt"
    out = dump_ops.main(["--device", "cpu", "--batch", "2", "--height",
                         "32", "--width", "32", "--endpoint", "Mixed_3c",
                         "--full-ops", str(full)])
    capsys.readouterr()
    assert out["segment"] == ["Mixed_3b", "Mixed_3c"]
    rec = dump_ops.segment_ops("inception_v1", "Mixed_3c", "Mixed_3b",
                               batch=2, height=32, width=32, mode="train",
                               device="cpu")
    assert isinstance(rec, WorkCounter)
    counts = {k: v[0] for k, v in rec.by_op.items()}
    assert dump_ops.summarize(rec)["op_histogram"] == counts
    assert out["op_histogram"] == counts
    assert sum(counts.values()) == len(rec.records) == out["ops"]
    assert len(full.read_text().splitlines()) == out["ops"]
    kinds = {r["kind"] for r in out["relayout"]}
    assert {"cast", "cat"} <= kinds
    n_cat = counts["aten::cat"]
    assert len(out["concatenates"]) == n_cat == 1
    cat = out["concatenates"][0]
    assert cat["shape"] == [2, 480, 4, 4]
    assert [s[1] for s in cat["operands"]] == [128, 192, 96, 64]
    casts = sum(r["kind"] == "cast" for r in out["relayout"])
    assert casts == counts["aten::_to_copy"]


def test_dump_ops_fwd_has_no_backward(capsys):
    out = dump_ops.main(["--device", "cpu", "--batch", "1", "--height",
                         "32", "--width", "32", "--mode", "fwd",
                         "--start", "", "--endpoint", "MaxPool_2a_3x3"])
    capsys.readouterr()
    assert out["segment"] == ["", "MaxPool_2a_3x3"]
    assert not any("backward" in k for k in out["op_histogram"])
    assert out["op_histogram"]["gvcnn::stem_conv7x7s2"] == 1


def test_bench_stem_on_the_cpu(capsys):
    lines = bench_stem.main(["--device", "cpu", "--batch", "2", "--height",
                             "32", "--iters", "2"])
    capsys.readouterr()
    assert [r["dtype"] for r in lines] == ["bfloat16", "float32"]
    assert [r["kernel"] for r in lines] == ["stem_conv7x7s2_bf16",
                                            "stem_conv7x7s2_f32"]
    for r in lines:
        for k in ("kernel_ms", "library_ms", "speedup", "max_abs_dev",
                  "rel_dev"):
            assert k in r
        assert "xla_ms" not in r and "pallas_ms" not in r
        assert r["device"] == "cpu" and r["kernel_launches"] == 0
        # On the CPU the wrapper runs the plain version: F.conv2d itself.
        assert r["rel_dev"] < 1e-2


def test_cudnn_stem_routes_the_wrapper_and_restores_it():
    from gvcnn_tf_tpu_torch.ops import stem_kernel

    kernel = stem_kernel._stem_forward
    x = torch.rand(1, 16, 16, 3)
    w = torch.rand(64, 3, 7, 7)
    with bench_stem.cudnn_stem():
        assert stem_kernel._stem_forward is not kernel
        assert torch.equal(stem_kernel.stem_conv(x, w),
                           stem_kernel.stem_conv_plain(x, w))
    assert stem_kernel._stem_forward is kernel


def test_bench_stem_train_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench_stem, "get_config", lambda name: tiny(name))
    monkeypatch.setattr(bench_variants, "CHUNK", 1)
    lines = bench_stem.run(batch=2, height=16, iters=1, train=True,
                           device="cpu")
    capsys.readouterr()
    steps = {r["variant"]: r for r in lines if "variant" in r}
    assert set(steps) == {"stem_kernel", "stem_cudnn"}
    assert steps["stem_kernel"]["first_loss"] == (
        steps["stem_cudnn"]["first_loss"])
    assert "k2_worth_ms" in lines[-1]


def test_backend_flags_on_the_cpu(capsys, tmp_path):
    before = (torch.backends.cudnn.benchmark,
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    out = tmp_path / "f.md"
    rows = bench_backend_flags.run(tiny(), batch=1, iters=1, device="cpu",
                                   chunk=1, out=str(out))
    capsys.readouterr()
    assert [r["name"] for r in rows] == ["default", "cudnn_benchmark",
                                         "cudnn_deterministic", "tf32"]
    assert all("step_ms" in r for r in rows)
    assert [r["exact"] for r in rows] == [True, True, True, False]
    assert rows[0]["vs_default"] == 1.0
    after = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    assert after == before
    assert "tf32" not in {n for n, _, _ in bench_backend_flags.settings_for(
        tiny(dtype="bfloat16"))}
    assert out.read_text().count("\n| ") == 1 + 4     # header, 4 rows


def test_backend_settings_are_restored_after_an_error(monkeypatch, capsys):
    before = torch.backends.cudnn.benchmark
    monkeypatch.setattr(bench_backend_flags, "SETTINGS", [
        ("default", {}, True),
        ("broken", {"cudnn.benchmark": not before, "cudnn.no_such": 1},
         True)])
    rows = bench_backend_flags.run(tiny(), batch=1, iters=1, device="cpu",
                                   chunk=1, names=["default", "broken",
                                                   "nonesuch"])
    capsys.readouterr()
    assert torch.backends.cudnn.benchmark == before
    assert rows[1]["error"].startswith("AttributeError: torch.backends."
                                       "cudnn.no_such")
    assert rows[2]["error"].startswith("unknown setting 'nonesuch'")
    with pytest.raises(RuntimeError, match="boom"):
        with bench_backend_flags.applied({"cudnn.benchmark": not before}):
            assert torch.backends.cudnn.benchmark != before
            raise RuntimeError("boom")
    assert torch.backends.cudnn.benchmark == before


@pytest.mark.parametrize("flag", ["stem_pallas", "use_pallas_grouping"])
def test_build_model_logs_the_pallas_switches(capsys, flag):
    cfg = configs.get_config("mn40_12view").replace(
        merge_inception_branches="none", **{flag: True})
    build_model(cfg)
    err = capsys.readouterr().err.splitlines()
    assert err == [f"[gvcnn_tf_tpu_torch] {flag}=True: the port has no "
                   "switch for its kernels; a CUDA tensor always goes "
                   "through the hand-written CUDA kernel and a CPU tensor "
                   "through the plain version"]


def test_build_model_is_quiet_without_them(capsys):
    cfg = configs.get_config("mn40_12view").replace(
        merge_inception_branches="none")
    assert not (cfg.stem_pallas or cfg.use_pallas_grouping)
    build_model(cfg)
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("tool", [profile_step, dump_ops, check_wire_fusion,
                                  bench_variants, bench_stem,
                                  bench_backend_flags])
def test_without_a_card_the_new_tools_raise(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main(["--batch", "1"])
