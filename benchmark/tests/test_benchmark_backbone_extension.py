"""A configuration whose backbone the reference lacks is added with new
files only: in a copy of the benchmark, a throwaway backbone file with a
1x3 conv, a 3x1 'VALID' stride-2 conv, a 'VALID' 3x3/2 max pool at an odd
size and a 3x3/1 'SAME' average pool, and a configuration file that names
it, are found by name; its weights, counted FLOPs and forwards come out
right with no edit to any file that was there.  A backbone name with no
file, or one that lacks the interface, is refused."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

BACKBONE = '''"""A throwaway backbone (a test's): rectangular and 'VALID'
convs, a 'VALID' max pool and a TF-Slim 'SAME' average pool."""

from benchmark.reference.layers import ConvShape, avg_pool, max_pool, out_hw

NAME = "TinyValid"
BN_SCALE = True
BN_EPS = 1e-4
MIN_SIZE = 7
# (endpoint, op, cout, kernel, stride, padding)
PLAN = (("Conv2d_1a_1x3", "conv", 8, (1, 3), 1, "SAME"),
        ("Conv2d_1b_3x1", "conv", 12, (3, 1), 2, "VALID"),
        ("MaxPool_2a_3x3", "max", None, 3, 2, "VALID"),
        ("AvgPool_2b_3x3", "avg", None, 3, 1, "SAME"),
        ("Conv2d_2c_1x1", "conv", 16, 1, 1, "SAME"))


def _walk(final, h, w):
    ch = 3
    for name, op, cout, k, s, pad in PLAN:
        ho, wo = out_hw(h, w, k, s, pad)
        yield name, op, ch, cout or ch, k, s, pad, (ho, wo)
        ch, h, w = cout or ch, ho, wo
        if name == final:
            return


def channels(final):
    return {name: cout for name, _, _, cout, *_ in _walk(final, 99, 99)}


def conv_shapes(final, h, w):
    return [ConvShape(f"{NAME}.{name}", cin, cout,
                      (k, k) if isinstance(k, int) else k,
                      (s, s), out)
            for name, op, cin, cout, k, s, _, out in _walk(final, h, w)
            if op == "conv"]


def spatial(endpoint, h, w):
    return [out for name, *_, out in _walk(endpoint, h, w)][-1]


def forward(net, x, final, taps):
    ends = {}
    for name, op, _, _, k, s, pad, _ in _walk(final, *x.shape[2:]):
        if op == "conv":
            x = net.conv_bn(x, f"{NAME}.{name}", s, padding=pad)
        elif op == "max":
            x = max_pool(x, k, s, pad)
        else:
            x = avg_pool(x, k, s, pad, count_include_pad=False)
        if name in taps:
            ends[name] = x
    return x, ends
'''

MODEL = {"family": "gvcnn", "backbone": "tiny_valid", "num_views": 2,
         "height": 75, "width": 75, "num_classes": 5, "num_group": 8,
         "raw_endpoint": "MaxPool_2a_3x3", "final_endpoint": "Conv2d_2c_1x1",
         "compute_dtype": "float32", "dropout_keep_prob": 0.8}

# 75x75 -> 1x3 'SAME' 75x75 -> 3x1 'VALID' /2 37x38 -> 3x3 'VALID' /2 18x18
# -> 3x3/1 'SAME' 18x18 -> 1x1 18x18; the score FCN on the max pool's 12
# channels; 2 views a shape, 2 shapes.
HAND_FLOPS = 2 * (2 * (2 * 3 * 8 * 1 * 3 * 75 * 75
                       + 2 * 8 * 12 * 3 * 1 * 37 * 38
                       + 2 * 12 * 16 * 18 * 18
                       + 2 * 12 * 128 * 18 * 18 + 2 * 128 * 18 * 18)
                  + 2 * 16 * 5)

DRIVE = r'''
import json
import torch
from benchmark import counting, harness
from benchmark.inputs import make_views
from benchmark.reference import gvcnn, layers
from benchmark.weights import make_weights

model = harness.load_json(
    harness.HERE / "configs" / "tiny_valid_cfg.json")["model"]
spec = gvcnn.param_spec(model)
w = make_weights(spec, 2147483659, "cpu")
views = make_views(torch.Generator().manual_seed(3), (2, 2, 75, 75, 3), "cpu")
out = {"here": str(harness.HERE),
       "backbone": gvcnn.backbone("tiny_valid").__file__,
       "shapes": {k: list(v.shape) for k, v in w.items()},
       "roles": {k: r for k, (_, r) in spec.items()},
       "flops": counting.forward_flops(model, 2)}
with torch.no_grad():
    for mode in ("train", "eval", "folded"):
        lg, sc = gvcnn.forward(w, views, model, mode, layers.Exact)
        out[mode] = {"shape": list(lg.shape), "scores": list(sc.shape),
                     "finite": bool(lg.isfinite().all()),
                     "logits": lg.tolist()}
refused = {}
for name in ("no_such_backbone", "half_done", "gvcnn", "layers", "../x"):
    other = dict(model, backbone=name)
    for what, call in (("spec", lambda: gvcnn.param_spec(other)),
                       ("count", lambda: counting.forward_flops(other, 1))):
        try:
            call()
            refused[f"{name}.{what}"] = False
        except harness.Refused:
            refused[f"{name}.{what}"] = True
out["refused"] = refused
print(json.dumps(out))
'''


def test_a_new_backbone_is_added_with_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    before = {p.relative_to(root).as_posix(): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}

    (root / "benchmark/reference/tiny_valid.py").write_text(BACKBONE)
    (root / "benchmark/reference/half_done.py").write_text(
        'NAME = "HalfDone"\n')
    cfg = json.loads((root / "benchmark/configs/mn40_12view.json")
                     .read_text())
    (root / "benchmark/configs/tiny_valid_cfg.json").write_text(
        json.dumps(dict(cfg, model=MODEL)))

    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["here"] == str(root / "benchmark")
    assert got["backbone"] == str(root / "benchmark/reference/tiny_valid.py")

    shapes, roles = got["shapes"], got["roles"]
    assert shapes["TinyValid.Conv2d_1a_1x3.conv.weight"] == [8, 3, 1, 3]
    assert shapes["TinyValid.Conv2d_1b_3x1.conv.weight"] == [12, 8, 3, 1]
    assert shapes["TinyValid.Conv2d_2c_1x1.conv.weight"] == [16, 12, 1, 1]
    assert shapes["GroupingModule.Conv2d_score_1x1.conv.weight"] == [
        128, 12, 1, 1]
    assert shapes["Logits.weight"] == [5, 16]
    # BN_SCALE: the backbone's BatchNorms have a scale, the head's none.
    assert roles["TinyValid.Conv2d_1b_3x1.BatchNorm.scale"] == "bn_scale"
    assert "GroupingModule.Conv2d_score_1x1.BatchNorm.scale" not in roles
    assert got["flops"] == HAND_FLOPS

    for mode in ("train", "eval", "folded"):
        assert got[mode]["shape"] == [2, 5] and got[mode]["finite"], mode
        assert got[mode]["scores"] == [2, 2]
    # Folding BN_EPS into the 'VALID' and rectangular convs changes
    # nothing but rounding.
    ev, fo = got["eval"]["logits"], got["folded"]["logits"]
    top = max(abs(v) for row in ev for v in row)
    assert max(abs(a - b) for ra, rb in zip(ev, fo)
               for a, b in zip(ra, rb)) <= 1e-4 * top
    assert all(got["refused"].values()), got["refused"]

    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel
