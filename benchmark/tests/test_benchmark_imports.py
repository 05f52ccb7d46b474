"""What the benchmark loads: no JAX and no JAX package in any process it
runs (top-level module names compared whole), and nothing of the program
in its plain reference."""

import subprocess
import sys

from benchmark import harness

BANNED = sorted(harness.BANNED)


def _modules(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, check=True,
        timeout=300)
    return set(out.stdout.split())


def test_harness_and_the_program_it_drives_load_no_jax():
    loaded = _modules(
        "import benchmark.run, benchmark.harness, benchmark.calibrate\n"
        "import benchmark.counting, benchmark.traffic.train_stream\n"
        "import benchmark.traffic.eval_pass\n"
        "import gvcnn_tf_tpu_torch.train, gvcnn_tf_tpu_torch.eval\n"
        "import gvcnn_tf_tpu_torch.serve, gvcnn_tf_tpu_torch.bridge\n"
        "import json\n"
        "from benchmark import harness\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "[harness.reader(m['name']) for m in b['per_layer']]")
    assert "gvcnn_tf_tpu_torch" in loaded
    assert not loaded & set(BANNED), loaded & set(BANNED)


def test_reference_loads_nothing_of_the_program():
    loaded = _modules(
        "import benchmark.reference.gvcnn, benchmark.reference.train\n"
        "import benchmark.reference.layers, benchmark.reference.resnet50\n"
        "import benchmark.reference.inception_v1")
    assert not loaded & (set(BANNED) | {"gvcnn_tf_tpu_torch"})


def test_banned_names_are_compared_whole():
    assert "gvcnn_tf_tpu" in harness.BANNED
    assert "gvcnn_tf_tpu_torch" not in harness.BANNED
    assert harness.banned_modules() == [] or "jax" in sys.modules
