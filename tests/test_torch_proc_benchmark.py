"""The port's GVCNN-vs-MVCNN study tool (tools/proc_benchmark.py) on the
CPU: the same configs as the JAX tool's (train_logdir aside: the port keeps
it under the temp directory), a 2-step `run_one` of each family at 32x32, 2
views, that prints the JAX tool's keys, the aggregation, and `--out` /
`--jsonl` writing only where they are told.
"""

import dataclasses
import inspect
import json
import os
import re
import tempfile

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from gvcnn_tf_tpu.tools import proc_benchmark as jax_pb  # noqa: E402
from gvcnn_tf_tpu_torch.tools import proc_benchmark as pb  # noqa: E402

TINY = ["--height", "32", "--num_views", "2", "--train_shapes", "8",
        "--eval_shapes", "6", "--batch", "4", "--steps", "2", "--device",
        "cpu"]


def _args(argv):
    a = pb._parser().parse_args(argv)
    a.width = a.width or a.height
    return a


def _jax_keys():
    src = inspect.getsource(jax_pb.run_one)
    block = src[src.index("out = {"):src.index("}", src.index("out = {"))]
    return re.findall(r'"([\w@]+)":', block)


@pytest.mark.parametrize("argv", [
    [], ["--hard"],
    ["--hard", "--num_classes", "40", "--height", "64", "--num_views", "4",
     "--batch", "8", "--steps", "30", "--learning_rate", "3e-4"]])
@pytest.mark.parametrize("model,seed", [("gvcnn", 0), ("mvcnn", 3)])
def test_config_equals_jax(argv, model, seed):
    a = _args(argv)
    got = dataclasses.asdict(pb._config(model, a, seed))
    want = dataclasses.asdict(jax_pb._config(model, a, seed))
    got_dir = got["train"].pop("train_logdir")
    want_dir = want["train"].pop("train_logdir")
    assert got == want
    assert want_dir == f"/tmp/gvcnn_proc/{model}_s{seed}"
    assert got_dir == os.path.join(tempfile.gettempdir(), "gvcnn_proc",
                                   f"{model}_s{seed}")


@pytest.mark.parametrize("model", ["gvcnn", "mvcnn"])
def test_run_one_prints_the_jax_tool_s_keys(model, capsys):
    out = pb.run_one(model, _args(TINY + ["--hard"]), 0)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert list(out) == _jax_keys()
    assert (out["model"], out["seed"], out["count"], out["steps"]) == (
        model, 0, 6, 2)
    assert 0.0 <= out["top1"] <= 1.0 and 0.0 <= out["retrieval_mAP"] <= 1.0


def _fake_run_one(model, a, seed):
    return {"model": model, "seed": seed, "top1": 0.5 + 0.1 * seed,
            "count": 6, "retrieval_mAP": 0.25 * (seed + 1),
            "precision@5": 0.2, "final_train_acc": 1.0,
            "train_seconds": 1.0, "steps": a.steps}


def test_out_and_jsonl_write_only_where_told(tmp_path, monkeypatch):
    """--out appends the markdown table and --jsonl the result lines, each
    to its own path; nothing else appears in the working directory, and a
    second run appends."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pb, "run_one", _fake_run_one)
    md, jl = tmp_path / "out" / "study.md", tmp_path / "out" / "study.jsonl"
    md.parent.mkdir()
    argv = TINY + ["--seeds", "0,1", "--hard", "--out", str(md), "--jsonl",
                   str(jl)]
    pb.main(argv)
    assert sorted(os.listdir(tmp_path)) == ["out"]
    assert sorted(os.listdir(md.parent)) == ["study.jsonl", "study.md"]
    text = md.read_text()
    assert "## Procedural benchmark (HARD) (2 views, 32x32" in text
    assert ", cpu)" in text
    lines = [json.loads(x) for x in jl.read_text().splitlines()]
    assert lines[0]["device"] == "cpu" and lines[0]["steps"] == 2
    assert [x["model"] for x in lines[1:]] == ["gvcnn", "gvcnn", "mvcnn",
                                               "mvcnn", "gvcnn", "mvcnn"]
    pb.main(argv)
    assert len(jl.read_text().splitlines()) == 2 * len(lines)
    assert md.read_text().count("## Procedural benchmark") == 2


def test_aggregate_is_the_jax_tool_s(capsys, monkeypatch):
    """More than one seed: mean +- sample std per model, as the JAX tool
    prints it."""
    monkeypatch.setattr(pb, "run_one", _fake_run_one)
    pb.main(TINY + ["--seeds", "0,1,2", "--models", "gvcnn"])
    agg = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert agg == {"model": "gvcnn", "seeds": [0, 1, 2],
                   "top1": "0.6000+-0.1000",
                   "retrieval_mAP": "0.5000+-0.2500",
                   "precision@5": "0.2000+-0.0000"}


def test_main_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="never falls back"):
        pb.main(["--steps", "1"])
