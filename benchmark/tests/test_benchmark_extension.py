"""A cell, a traffic mix of an existing kind and a per-layer metric are
added with new files only: in a copy of the benchmark, the harness finds
them by name with no edit to any file that was there (BENCHMARK.json
gains entries, as a later PR's does)."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

READER = '''"""Steps the window ran (a test's throwaway metric)."""


def read(records):
    return float(records["steps"]) if records.get("steps") else None
'''

DRIVE = r'''
import json, time
from benchmark import harness
from benchmark.tests import tiny
shrink = tiny.SHRINK["train_stream"]
result, checks, _ = harness.execute(
    "mn40_12view.train_added", 77, 0.5, True, t_start=time.perf_counter(),
    device="cpu", shrink=shrink)
print(json.dumps({"here": str(harness.HERE), "result": result}))
'''


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root).as_posix(): p.read_bytes()
              for p in (root / "benchmark").rglob("*") if p.is_file()}

    mix = json.loads((root / "benchmark/traffic/train_stream_b32.json")
                     .read_text())
    (root / "benchmark/traffic/train_stream_added.json").write_text(
        json.dumps(dict(mix, pool_batches=3)))
    (root / "benchmark/limits/mn40_12view.train_added.json").write_bytes(
        (root / "benchmark/limits/mn40_12view.train_b32.json").read_bytes())
    (root / "benchmark/metrics/steps_seen.train.py").write_text(READER)
    bench["workloads"].append({
        "name": "mn40_12view.train_added", "config": "mn40_12view",
        "traffic": "train_stream_added", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_views_per_s":
            m["workloads"].append("mn40_12view.train_added")
    bench["per_layer"].append({
        "name": "steps_seen.train", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "the device",
        "moves": "train_views_per_s",
        "workloads": ["mn40_12view.train_added"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["here"] == str(root / "benchmark")
    assert line["result"]["metrics"]["steps_seen.train"]["value"] >= 1
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "mn40_12view.eval_b32", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "mn40_12view.eval_b32", "--seed", "1", "--seconds", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()
