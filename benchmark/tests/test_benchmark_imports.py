"""What the benchmark loads: no JAX and no JAX package in any process it
runs (top-level module names compared whole), and nothing of the program
in its plain reference."""

import subprocess
import sys

from benchmark import harness

BANNED = sorted(harness.BANNED)


def _imports(folder):
    """`import` lines for every module of `benchmark/<folder>`."""
    return "".join(f"import benchmark.{folder}.{p.stem}\n" for p in sorted(
        (harness.HERE / folder).glob("*.py")) if p.stem != "__init__")


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
        "import benchmark.counting\n" + _imports("traffic")
        + "import gvcnn_tf_tpu_torch.train, gvcnn_tf_tpu_torch.eval\n"
        "import gvcnn_tf_tpu_torch.serve, gvcnn_tf_tpu_torch.bridge\n"
        "import json\n"
        "from benchmark import harness\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "[harness.reader(m['name']) for m in b['per_layer']]")
    assert "gvcnn_tf_tpu_torch" in loaded
    assert not loaded & set(BANNED), loaded & set(BANNED)


def test_reference_loads_nothing_of_the_program():
    """Every module of the reference: its own, and each backbone file,
    loaded by name as a run loads it (which also checks its interface)."""
    own = ("gvcnn", "layers", "train")
    backbones = sorted(p.stem for p in (harness.HERE / "reference").glob(
        "*.py") if p.stem not in own + ("__init__",))
    assert {"inception_v1", "resnet50"} <= set(backbones)
    loaded = _modules(
        "".join(f"import benchmark.reference.{m}\n" for m in own)
        + "from benchmark.reference.gvcnn import backbone\n"
        + "".join(f"backbone({b!r})\n" for b in backbones))
    assert not loaded & (set(BANNED) | {"gvcnn_tf_tpu_torch"})


def test_banned_names_are_compared_whole():
    assert "gvcnn_tf_tpu" in harness.BANNED
    assert "gvcnn_tf_tpu_torch" not in harness.BANNED
    assert harness.banned_modules() == [] or "jax" in sys.modules
