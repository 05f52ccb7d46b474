"""The data-parallel step's collective audit (`parallel/collectives.py`'s
`CollectiveRecorder`, `tools/analyze_collectives.py`) on 2 gloo ranks on
the CPU, both `bn_sync` modes in one spawn.

- local: exactly one device all-reduce a step, the flat buffer: every
  parameter's gradient, loss, accuracy and every BatchNorm's running
  statistics, fp32.
- global: that buffer without the statistics, plus one all-reduce of each
  train-mode BatchNorm's per-channel sums (2C + 1 values) in the forward
  and one in its backward: 1 + 2 x the BatchNorm calls the step makes.
- Gradient bytes are the parameters' fp32 bytes; the loop's host-group
  calls are reported apart from the step's, which makes none.
- Against the JAX tool (`gvcnn_tf_tpu/tools/analyze_collectives.py`'s
  `collect(sharded_step_hlo(2, bn_sync=...))`, the same config at the same
  tiny shapes over 2 of the 8 virtual CPU devices): in local mode both
  programs make one all-reduce of the same bytes; in global mode both send
  the same bytes, less one count element a BatchNorm call and direction
  that the port's all-reduces carry beside (sum, sum of squares) and the
  JAX program knows when it compiles.  The op counts differ: the port makes
  1 + 2 x 58, one all-reduce a BatchNorm call and direction, eagerly; XLA's
  all-reduce combiner merges independent reductions (an Inception block's
  parallel branches, the last statistics into the gradient buffer) into
  about 60 small ops beside the gradient buffer.
- `scaling_model` (mirrors `tests/test_analyze_collectives.py::
  test_scaling_model_monotone`): efficiency falls and both cost terms grow
  with n over 2, 4 and 8 cards; the report's keys are the JAX tool's with
  NVLink terms in place of ICI ones.
"""

import json

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from gvcnn_tf_tpu_torch.models.gvcnn import build_model  # noqa: E402
from gvcnn_tf_tpu_torch.tools import analyze_collectives as ac  # noqa: E402

JAX_KEYS = ["devices", "bn_sync", "collective_ops", "op_kinds",
            "allreduce_bytes_total", "allreduce_mbytes", "top_ops",
            "step_ms_measured", "scaling_model_worst_case", "note"]


@pytest.fixture(scope="module")
def recorded():
    return ac.audit(2, ("local", "global"), timeout=300)


@pytest.fixture(scope="module")
def jax_ops():
    """{mode: the JAX program's collectives}, at the port's audit shapes."""
    from gvcnn_tf_tpu.tools.analyze_collectives import (
        collect,
        sharded_step_hlo,
    )

    return {m: collect(sharded_step_hlo(2, bn_sync=m))
            for m in ("local", "global")}


def _device_ops(rec):
    return [o for o in rec["step"] if o["group"] == "device"]


def test_gradient_bytes_are_the_parameters_fp32_bytes(recorded):
    model = build_model(ac.audit_config(2, "local"))
    want = sum(p.numel() for p in model.parameters()) * 4
    for rec in recorded.values():
        assert rec["param_dtypes"] == ["torch.float32"]
        assert rec["param_bytes"] == want


def test_local_mode_makes_one_flat_all_reduce(recorded):
    rec = recorded["local"]
    ops = _device_ops(rec)
    assert len(ops) == 1
    (op,) = ops
    assert (op["op"], op["reduce_op"], op["site"], op["dtype"]) == (
        "all_reduce", "sum", "mean_across_ranks_", "float32")
    assert op["bytes"] == rec["param_bytes"] + 2 * 4 + rec["bn_stat_bytes"]
    assert op["bytes"] == 4 * op["numel"]


def test_global_mode_adds_two_all_reduces_per_batchnorm(recorded):
    rec = recorded["global"]
    ops = _device_ops(rec)
    flat = [o for o in ops if o["site"] == "mean_across_ranks_"]
    assert len(flat) == 1
    assert flat[0]["bytes"] == rec["param_bytes"] + 2 * 4
    bn = [o for o in ops if o["site"].startswith("sum_across_ranks")]
    assert rec["train_bn_calls"] > 50
    assert len(ops) == len(flat) + len(bn) == 1 + 2 * rec["train_bn_calls"]
    fwd = [o for o in bn if o["site"] == "sum_across_ranks"]
    assert len(fwd) == rec["train_bn_calls"]
    # Each BatchNorm's (sum, sum of squares, count): 2C + 1 fp32 values.
    assert all(o["numel"] % 2 == 1 and o["dtype"] == "float32" for o in bn)
    assert sorted(o["numel"] for o in fwd) == sorted(
        o["numel"] for o in bn if o["site"] != "sum_across_ranks")


def test_local_mode_sends_the_jax_program_s_one_buffer(recorded, jax_ops):
    cfg = ac.audit_config(2, "local")
    assert (cfg.data.height, cfg.data.num_views, cfg.data.batch_size) == (
        64, 4, 2)
    (mine,) = _device_ops(recorded["local"])
    (theirs,) = jax_ops["local"]
    assert theirs["op"] == "all-reduce"
    assert mine["bytes"] == theirs["bytes"]


def test_global_mode_sends_the_jax_program_s_bytes_in_more_ops(recorded,
                                                                jax_ops):
    rec, theirs = recorded["global"], jax_ops["global"]
    mine = _device_ops(rec)
    assert {o["op"] for o in theirs} == {"all-reduce"}
    counts = 4 * 2 * rec["train_bn_calls"]
    assert sum(o["bytes"] for o in mine) - counts == sum(
        o["bytes"] for o in theirs)
    # The gradient buffer: the port's one flat all-reduce; XLA splits it in
    # two and merges the last statistics into the smaller part.
    flat = [o["bytes"] for o in mine if o["site"] == "mean_across_ranks_"]
    big = sorted(o["bytes"] for o in theirs)[-2:]
    assert big[0] < 0.02 * big[1]
    assert 0 <= sum(big) - flat[0] < 0.05 * sum(
        o["bytes"] for o in mine if o["site"] != "mean_across_ranks_")
    # Side by side: 1 + 2 x 58 against XLA's combined ops.
    assert len(mine) == 1 + 2 * rec["train_bn_calls"] == 117
    assert len(theirs) < len(mine)
    assert len(theirs) <= 80


def test_the_loop_s_host_calls_are_apart(recorded):
    for rec in recorded.values():
        assert [o for o in rec["step"] if o["group"] == "host"] == []
        assert [(o["site"], o["reduce_op"], o["group"]) for o in
                rec["loop"]] == [("barrier", "sum", "host"),
                                 ("agree_max", "max", "host")]


@pytest.mark.parametrize("mode", ["local", "global"])
def test_report_keeps_the_jax_keys_with_nvlink_terms(recorded, mode):
    out = ac.report(recorded[mode], 2, mode, step_ms=40.0)
    assert list(out)[:11] == JAX_KEYS[:8] + [
        "nvlink_gbps_assumed"] + JAX_KEYS[8:]
    assert "ici_gbps_assumed" not in out
    assert out["nvlink_gbps_assumed"] == ac.NVLINK_GBPS == 450.0
    assert out["op_kinds"] == ["all_reduce"]
    assert out["collective_ops"] == len(_device_ops(recorded[mode]))
    assert out["allreduce_bytes_total"] == sum(
        o["bytes"] for o in _device_ops(recorded[mode]))
    assert [r["devices"] for r in out["scaling_model_worst_case"]] == [
        2, 4, 8]
    assert "not a measurement" in out["note"] and "past 8" in out["note"]
    json.dumps(out)


def test_scaling_model_monotone():
    rows = ac.scaling_model(int(22.8e6), 40.0, n_ops=117)
    eff = [r["dp_efficiency"] for r in rows]
    assert all(0 < e <= 1 for e in eff)
    assert eff == sorted(eff, reverse=True) and eff[0] > eff[-1]
    for key in ("allreduce_ms", "latency_ms"):
        vals = [r[key] for r in rows]
        assert vals == sorted(vals) and vals[0] < vals[-1]
    # 2 (n-1)/n of the bytes over 450 GB/s, 2 (n-1) hops at 1 us an op.
    n8 = rows[-1]
    assert n8["allreduce_ms"] == pytest.approx(
        2 * 7 / 8 * 22.8e6 / 450e9 * 1e3, abs=1e-4)
    assert n8["latency_ms"] == pytest.approx(117 * 14 * 1e-3, abs=1e-4)
    # Overlap hides the exposed time.
    hidden = ac.scaling_model(int(22.8e6), 40.0, overlap_frac=1.0)
    assert all(r["dp_efficiency"] == 1.0 for r in hidden)


def test_without_step_ms_or_a_card_it_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ac.main(["--devices", "2"])
    with pytest.raises(ValueError, match="--step-ms"):
        ac.main(["--devices", "2", "--device", "cpu"])


def test_recorders_nest_and_stop_at_the_block(monkeypatch):
    """Both recorders of a nested pair see a call made inside both blocks,
    only the outer one a call after the inner block, neither a call after
    both (`dist.all_reduce` stubbed: no process group here)."""
    from gvcnn_tf_tpu_torch.parallel import World, collectives

    sent = []
    monkeypatch.setattr(collectives.dist, "all_reduce",
                        lambda t, op=None, group=None: sent.append(group))
    world = World(group="devices", host_group="host", size=2)
    grads = [torch.ones(3), torch.ones(2, 2, dtype=torch.float32)]
    with collectives.CollectiveRecorder() as outer:
        with collectives.CollectiveRecorder() as inner:
            collectives.mean_across_ranks_(grads, world)
        collectives.agree_max(1, world)
    collectives.barrier(world)
    assert sent == ["devices", "host", "host"]
    assert inner.ops == [dict(op="all_reduce", reduce_op="sum",
                              site="mean_across_ranks_", group="device",
                              dtype="float32", numel=7, bytes=28)]
    assert outer.ops == inner.ops + [dict(
        op="all_reduce", reduce_op="max", site="agree_max", group="host",
        dtype="int64", numel=1, bytes=8)]
    assert collectives._RECORDERS == []
