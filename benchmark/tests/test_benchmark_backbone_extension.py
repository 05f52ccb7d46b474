"""A configuration whose backbone the reference lacks is added with new
files only: in a copy of the benchmark, a throwaway backbone file with a
1x3 conv, a 3x1 'VALID' stride-2 conv, a 'VALID' 3x3/2 max pool at an odd
size and a 3x3/1 'SAME' average pool, and a configuration file that names
it, are found by name; its weights, counted FLOPs and forwards come out
right with no edit to any file that was there.  A backbone name with no
file, or one that lacks the interface, is refused.  A second throwaway
backbone holds one residual block of Inception-ResNet-v2's form, whose
up-projection is a conv with a bias and no BatchNorm (`ConvShape.bn`
false, `Net.conv_bias`): its weight and bias are made, loaded by the
port's names, counted, trained and left out of the L2 term as TF-Slim
does."""

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


def _checkout(tmp_path):
    """(a copy of the benchmark's files, {path: bytes} of each)."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    return root, {p.relative_to(root).as_posix(): p.read_bytes()
                  for p in root.rglob("*") if p.is_file()}


def _add_config(root, name, model):
    cfg = json.loads((root / "benchmark/configs/mn40_12view.json")
                     .read_text())
    (root / f"benchmark/configs/{name}.json").write_text(
        json.dumps(dict(cfg, model=model)))


def _drive(root, script) -> dict:
    """The last line of `script` run in `root`, as JSON."""
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _unchanged(root, before):
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel


def test_a_new_backbone_is_added_with_new_files(tmp_path):
    root, before = _checkout(tmp_path)
    (root / "benchmark/reference/tiny_valid.py").write_text(BACKBONE)
    (root / "benchmark/reference/half_done.py").write_text(
        'NAME = "HalfDone"\n')
    _add_config(root, "tiny_valid_cfg", MODEL)

    got = _drive(root, DRIVE)
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
    _unchanged(root, before)


RESIDUAL = '''"""A throwaway backbone (a test's): a 'VALID' stem, one residual block
of Inception-ResNet-v2's form (two conv + BN + ReLU branches,
concatenated, a 1x1 up-conv with a bias and no BatchNorm, relu(x + s up))
and a 1x1 conv + BN + ReLU after it; it always runs to Conv2d_7b_1x1."""

import torch
import torch.nn.functional as F

from benchmark.reference.layers import ConvShape, out_hw

NAME = "TinyResidual"
BN_SCALE = False
BN_EPS = 1e-3
MIN_SIZE = 3
SCALE = 0.17
BLOCK = f"{NAME}.Block35_1"
# (name, cin, cout, kernel, bn) of the block's convs in order; the
# branches' 8 + 12 channels are concatenated for the up-conv.
BLOCK_CONVS = (("Branch_0_Conv2d_1x1", 16, 8, 1, True),
               ("Branch_1_Conv2d_0a_1x1", 16, 8, 1, True),
               ("Branch_1_Conv2d_0b_3x3", 8, 12, 3, True),
               ("Conv2d_1x1", 20, 16, 1, False))


def channels(final):
    return {"Conv2d_1a_3x3": 16, "Block35_1": 16, "Conv2d_7b_1x1": 24}


def spatial(endpoint, h, w):
    return out_hw(h, w, 3, 2, "VALID")


def conv_shapes(final, h, w):
    hw = spatial(final, h, w)
    return ([ConvShape(f"{NAME}.Conv2d_1a_3x3", 3, 16, (3, 3), (2, 2), hw)]
            + [ConvShape(f"{BLOCK}.{n}", i, o, (k, k), (1, 1), hw, bn)
               for n, i, o, k, bn in BLOCK_CONVS]
            + [ConvShape(f"{NAME}.Conv2d_7b_1x1", 16, 24, (1, 1), (1, 1),
                         hw)])


def forward(net, x, final, taps):
    ends = {}
    x = ends["Conv2d_1a_3x3"] = net.conv_bn(x, f"{NAME}.Conv2d_1a_3x3", 2,
                                            padding="VALID")
    b0 = net.conv_bn(x, f"{BLOCK}.Branch_0_Conv2d_1x1")
    b1 = net.conv_bn(net.conv_bn(x, f"{BLOCK}.Branch_1_Conv2d_0a_1x1"),
                     f"{BLOCK}.Branch_1_Conv2d_0b_3x3")
    up = net.conv_bias(torch.cat([b0, b1], 1), f"{BLOCK}.Conv2d_1x1")
    x = ends["Block35_1"] = F.relu(x + SCALE * up)
    x = ends["Conv2d_7b_1x1"] = net.conv_bn(x, f"{NAME}.Conv2d_7b_1x1")
    return x, {t: ends[t] for t in taps}
'''

RESIDUAL_MODEL = dict(MODEL, backbone="tiny_residual",
                      raw_endpoint="Block35_1",
                      final_endpoint="Conv2d_7b_1x1")
UP = "TinyResidual.Block35_1.Conv2d_1x1"

# 75x75 -> 3x3 'VALID' /2 37x37; the block's convs, the up-conv 20 -> 16
# among them, and the 1x1 to 24 at 37x37; the score FCN on the block's 16
# channels; 2 views a shape, 2 shapes.
RESIDUAL_FLOPS = 2 * (2 * 2 * 37 * 37 * (3 * 16 * 9 + 16 * 8 + 16 * 8
                                         + 8 * 12 * 9 + 20 * 16 + 16 * 24
                                         + 16 * 128 + 128)
                      + 2 * 24 * 5)

DRIVE_RESIDUAL = r'''
import json
import torch
import torch.nn as nn
from benchmark import counting, harness
from benchmark.inputs import make_views
from benchmark.reference import gvcnn, layers, train
from benchmark.weights import make_weights
from gvcnn_tf_tpu_torch.models.backbones.layers import ConvBN

UP = "TinyResidual.Block35_1.Conv2d_1x1"
model = harness.load_json(
    harness.HERE / "configs" / "tiny_residual_cfg.json")["model"]
bb = gvcnn.backbone("tiny_residual")
spec = gvcnn.param_spec(model)
w = make_weights(spec, 2147483659, "cpu")
views = make_views(torch.Generator().manual_seed(3), (2, 2, 75, 75, 3), "cpu")
labels = torch.tensor([1, 3])


def put(root, name, mod):
    *path, last = name.split(".")
    for part in path:
        if not hasattr(root, part):
            root.add_module(part, nn.Module())
        root = getattr(root, part)
    root.add_module(last, mod)


# The port's modules under the reference's names: ConvBN for a conv with a
# BatchNorm, a bare nn.Conv2d with its bias for the up-conv.
port = nn.Module()
for c in bb.conv_shapes(model["final_endpoint"], 75, 75):
    if c.bn:
        put(port, c.name, ConvBN(c.cin, c.cout, c.kernel, c.stride,
                                 use_scale=bb.BN_SCALE))
    else:
        put(port, c.name + ".conv", nn.Conv2d(c.cin, c.cout, c.kernel))
put(port, "GroupingModule.Conv2d_score_1x1", ConvBN(16, 128, (1, 1)))
put(port, "GroupingModule.Conv2d_score_logit", nn.Conv2d(128, 1, 1))
put(port, "Logits", nn.Linear(24, 5))
port.load_state_dict(w, strict=True)

out = {"names": list(spec), "port_names": sorted(port.state_dict()),
       "shapes": {k: list(v.shape) for k, v in w.items()},
       "roles": {k: r for k, (_, r) in spec.items()},
       "up_bias_std": float(w[UP + ".conv.bias"].std()),
       "flops": counting.forward_flops(model, 2)}
with torch.no_grad():
    for mode in ("train", "eval", "folded"):
        lg, sc = gvcnn.forward(w, views, model, mode, layers.Exact)
        out[mode] = {"shape": list(lg.shape), "scores": list(sc.shape),
                     "finite": bool(lg.isfinite().all()),
                     "logits": lg.tolist()}
    x = torch.randn((2, 20, 9, 9), generator=torch.Generator().manual_seed(5))
    ys = [layers.Net(w, mode, layers.Exact, bb.BN_EPS).conv_bias(x, UP)
          for mode in ("train", "eval", "folded")]
    out["conv_bias_modes_equal"] = all(torch.equal(ys[0], y) for y in ys)
    want = torch.nn.functional.conv2d(x, w[UP + ".conv.weight"],
                                      w[UP + ".conv.bias"])
    out["conv_bias_gap"] = float((ys[0] - want).abs().max())

# The L2 term's share of each gradient: weight decay 1 against 0.
opt = harness.load_json(
    harness.HERE / "configs" / "tiny_residual_cfg.json")["optimizer"]
grads = []
for wd in (0.0, 1.0):
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss, _ = train.loss(params, views, labels, model,
                         dict(opt, weight_decay=wd), layers.Exact)
    grads.append(dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True))))
l2 = {}
for k in (UP + ".conv.weight", UP + ".conv.bias"):
    d = grads[1][k] - grads[0][k]
    l2[k] = {"gap_to_param": float((d - w[k]).abs().max()),
             "share": float(d.abs().max()), "param": float(w[k].abs().max())}
out["l2"] = l2
print(json.dumps(out))
'''


def test_a_conv_with_a_bias_and_no_batch_norm_is_added_with_new_files(
        tmp_path):
    root, before = _checkout(tmp_path)
    (root / "benchmark/reference/tiny_residual.py").write_text(RESIDUAL)
    _add_config(root, "tiny_residual_cfg", RESIDUAL_MODEL)

    got = _drive(root, DRIVE_RESIDUAL)
    names, shapes, roles = got["names"], got["shapes"], got["roles"]
    weight, bias = UP + ".conv.weight", UP + ".conv.bias"
    assert roles[weight] == "conv" and shapes[weight] == [16, 20, 1, 1]
    assert roles[bias] == "bias" and shapes[bias] == [16]
    assert names.index(bias) == names.index(weight) + 1
    assert not [n for n in names if n.startswith(UP + ".BatchNorm")]
    # The convs with a BatchNorm keep theirs (no scale: BN_SCALE false).
    assert roles["TinyResidual.Block35_1.Branch_0_Conv2d_1x1."
                 "BatchNorm.running_var"] == "bn_var"
    assert "TinyResidual.Block35_1.Branch_0_Conv2d_1x1.conv.bias" \
        not in roles
    # make_weights draws the bias by its role (std 0.1, clipped at 2 std);
    # the port's modules load exactly the spec's names, strictly.
    assert 0.02 < got["up_bias_std"] < 0.2
    assert got["port_names"] == sorted(names)
    assert got["flops"] == RESIDUAL_FLOPS

    for mode in ("train", "eval", "folded"):
        assert got[mode]["shape"] == [2, 5] and got[mode]["finite"], mode
        assert got[mode]["scores"] == [2, 2]
    ev, fo = got["eval"]["logits"], got["folded"]["logits"]
    top = max(abs(v) for row in ev for v in row)
    assert max(abs(a - b) for ra, rb in zip(ev, fo)
               for a, b in zip(ra, rb)) <= 1e-4 * top
    assert got["conv_bias_modes_equal"]
    assert got["conv_bias_gap"] <= 1e-5

    # 0.5 wd ||w||^2 adds wd w to the weight's gradient and nothing to the
    # bias's.
    l2w, l2b = got["l2"][weight], got["l2"][bias]
    assert l2w["gap_to_param"] <= 1e-5 * l2w["param"]
    assert l2w["share"] > 0.1 * l2w["param"]
    assert l2b["share"] <= 1e-6 * l2b["param"]
    _unchanged(root, before)
