"""The port's prediction (predict.py) and mesh tools (tools/render_meshes.py,
tools/make_demo_meshes.py) against the JAX package's, on the CPU.

The model is `tests/test_torch_eval.py`'s (mn40_12view with 10 classes,
cut to Mixed_3b, fp32, 32x32, 2 views, calibrated BN); one JAX `predict`
call scores three float view arrays, the renders of two OFF meshes and the
views of two PNG directories, and the port's `predict` takes each of the
three inputs its own way.  `class_index` must be equal (the fixture asserts
every top-2 margin is above 1e-3 of max|logit|); `probability` and
`view_scores` within 1e-5.  The mesh readers, the mesh discovery, the demo
meshes, the mesh renders and the PNG reader are compared exactly.
"""

import csv
import dataclasses
import importlib
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.models.gvcnn import init_model  # noqa: E402
from gvcnn_tf_tpu.predict import load_views as jax_load_views  # noqa: E402
from gvcnn_tf_tpu.predict import predict as jax_predict  # noqa: E402
from gvcnn_tf_tpu.predict import (  # noqa: E402
    render_mesh_views as jax_render_mesh_views,
)
from gvcnn_tf_tpu.tools import make_demo_meshes as jax_demo  # noqa: E402
from gvcnn_tf_tpu.tools import render_meshes as jax_meshes  # noqa: E402
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import (  # noqa: E402
    jax_to_state_dict,
    state_dict_to_jax,
)
from gvcnn_tf_tpu_torch.data.procedural import CLASSES  # noqa: E402
from gvcnn_tf_tpu_torch.models.gvcnn import build_model  # noqa: E402
from gvcnn_tf_tpu_torch.tools import make_demo_meshes as port_demo  # noqa: E402
from gvcnn_tf_tpu_torch.tools import render_meshes as port_meshes  # noqa: E402
from gvcnn_tf_tpu_torch.train import train as port_train  # noqa: E402
from test_torch_eval import _calibrate_bn, _config  # noqa: E402

# The port's __init__ exports a function named `predict`, as the JAX
# package's does.
port_predict_mod = importlib.import_module("gvcnn_tf_tpu_torch.predict")
V, H = 2, 32                          # test_torch_eval's sizes
TOL = dict(rtol=0, atol=1e-5)


def _write_meshes(root):
    paths = []
    for i, (name, build) in enumerate(CLASSES[4:6]):     # table, chair
        path = os.path.join(root, f"{name}.off")
        port_demo.write_off(path, *build(np.random.RandomState(i)))
        paths.append(path)
    return paths


def _write_view_dirs(root):
    from PIL import Image

    rs = np.random.RandomState(5)
    for shape in ("a", "b"):
        os.makedirs(os.path.join(root, shape))
        for i in range(V + 1):            # one more than V: the first V count
            img = rs.randint(0, 256, (H + 8, H, 3), np.uint8)
            Image.fromarray(img).save(os.path.join(root, shape,
                                                   f"view_{i:02d}.png"))
    return root


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    views = np.random.RandomState(3).uniform(-1, 1, (3, V, H, H, 3))
    return dict(views=views.astype(np.float32),
                mesh_files=_write_meshes(str(root)),
                view_dir=_write_view_dirs(str(root / "views")))


@pytest.fixture(scope="module")
def shared(inputs):
    """Calibrated JAX variables and the JAX records of every input."""
    jcfg, pcfg = _config(jax_configs), _config(port_configs)
    _, init_vars = init_model(jcfg, jax.random.key(1), (1, V, H, H, 3))
    model = build_model(pcfg).eval()
    model.load_state_dict(jax_to_state_dict(jax.device_get(init_vars)))
    mesh_views = jax_render_mesh_views(inputs["mesh_files"], V, H, H)
    dir_views = np.stack([
        jax_load_views(os.path.join(inputs["view_dir"], s), V, H, H)
        for s in ("a", "b")])
    every = np.concatenate([inputs["views"], mesh_views, dir_views])
    _calibrate_bn(model, torch.from_numpy(every), np.random.RandomState(0))
    with torch.no_grad():
        logits = model(torch.from_numpy(every))[0].numpy()
    top2 = np.sort(logits, -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3 * np.abs(logits).max()
    variables = state_dict_to_jax(model.state_dict())
    want = jax_predict(jcfg, views=every,
                       state=types.SimpleNamespace(**variables))
    return variables, {"views": want[:3], "mesh_files": want[3:5],
                       "view_dir": want[5:]}


def _same_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["class_index"] == w["class_index"]
        np.testing.assert_allclose(g["probability"], w["probability"], **TOL)
        np.testing.assert_allclose(g["view_scores"], w["view_scores"], **TOL)
        assert len(g["view_scores"]) == V


@pytest.mark.parametrize("kind", ["views", "mesh_files", "view_dir"])
def test_predict_equals_jax(shared, inputs, kind):
    variables, want = shared
    got = port_predict_mod.predict(_config(port_configs), state=variables,
                                   device="cpu", **{kind: inputs[kind]})
    _same_records(got, want[kind])
    names = {"views": ["shape_0", "shape_1", "shape_2"],
             "mesh_files": ["table", "chair"], "view_dir": ["a", "b"]}
    assert [r["shape"] for r in got] == names[kind]


def test_render_mesh_views_and_load_views_equal_jax(inputs):
    got = port_predict_mod.render_mesh_views(inputs["mesh_files"], V, H, H)
    want = jax_render_mesh_views(inputs["mesh_files"], V, H, H)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    d = os.path.join(inputs["view_dir"], "a")
    got = port_predict_mod.load_views(d, V, H, H)
    assert got.tobytes() == jax_load_views(d, V, H, H).tobytes()


def test_cli_writes_the_csv(tmp_path, inputs, monkeypatch):
    cfg = _config(port_configs)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, train_logdir=str(tmp_path / "run"), checkpoint_every=1))
    port_train(cfg, num_steps=1, device="cpu")
    monkeypatch.setitem(port_configs.CONFIGS, "tiny_predict", cfg)
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"c{i}" for i in range(10)) + "\n")
    out = tmp_path / "preds.csv"
    argv = ["--config", "tiny_predict", "--device", "cpu",
            "--output_csv", str(out), "--labels_file", str(labels)]
    for m in inputs["mesh_files"]:
        argv += ["--mesh_file", m]
    port_predict_mod.main(argv)
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    want = port_predict_mod.predict(cfg, mesh_files=inputs["mesh_files"],
                                    device="cpu")
    assert list(rows[0]) == ["shape", "class_index", "probability",
                             "class_name"]
    assert [r["shape"] for r in rows] == ["table", "chair"]
    for row, rec in zip(rows, want):
        assert int(row["class_index"]) == rec["class_index"]
        assert row["class_name"] == f"c{rec['class_index']}"
        assert float(row["probability"]) == pytest.approx(rec["probability"])


def test_predict_refuses_what_it_cannot_do(tmp_path, monkeypatch, shared):
    cfg = _config(port_configs)
    with pytest.raises(ValueError, match="need view_dir"):
        port_predict_mod.predict(cfg, state=shared[0], device="cpu")
    with pytest.raises(SystemExit):
        port_predict_mod.main(["--device", "cpu"])     # no input
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        port_predict_mod.load_views(str(tmp_path), V, H, H)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="never falls back"):
        port_predict_mod.main(["--mesh_file", "x.off"])


# ---------------------------------------------------------- mesh tools

_CUBE = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
         (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
_QUADS = [(0, 1, 2, 3), (4, 7, 6, 5), (0, 4, 5, 1), (1, 5, 6, 2),
          (2, 6, 7, 3), (3, 7, 4, 0)]


@pytest.mark.parametrize("one_line_header", [False, True])
def test_load_off_equals_jax(tmp_path, one_line_header):
    path = tmp_path / "cube.off"
    head = (f"OFF {len(_CUBE)} {len(_QUADS)} 0\n" if one_line_header
            else f"OFF\n# a comment\n{len(_CUBE)} {len(_QUADS)} 0\n")
    path.write_text(head + "".join(" ".join(map(str, v)) + "\n"
                                   for v in _CUBE)
                    + "".join("4 " + " ".join(map(str, q)) + "\n"
                              for q in _QUADS))
    verts, faces = port_meshes.load_mesh(str(path))
    jverts, jfaces = jax_meshes.load_off(str(path))
    assert faces.shape == (12, 3)                      # fan-triangulated
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)


def test_load_obj_equals_jax(tmp_path):
    path = tmp_path / "cube.obj"
    path.write_text("".join("v " + " ".join(map(str, v)) + "\n"
                            for v in _CUBE)
                    + "".join("f " + " ".join(f"{i + 1}//{i + 1}" for i in q)
                              + "\n" for q in _QUADS)
                    + "f -1 -2 -3\n")                 # relative indices
    verts, faces = port_meshes.load_mesh(str(path))
    jverts, jfaces = jax_meshes.load_obj(str(path))
    assert faces.shape == (13, 3)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    with pytest.raises(ValueError, match="unsupported"):
        port_meshes.load_mesh(str(tmp_path / "cube.stl"))


@pytest.mark.parametrize("split_dirs", [True, False])
def test_discover_meshes_equals_jax(tmp_path, split_dirs):
    for cls in ("chair", "table"):
        d = tmp_path / cls / "train" if split_dirs else tmp_path / cls
        d.mkdir(parents=True)
        for k in range(2):
            (d / f"{cls}_{k}.off").write_text("OFF\n0 0 0\n")
        (d / "notes.txt").write_text("")
        if split_dirs:
            (tmp_path / cls / "test").mkdir()
            (tmp_path / cls / "test" / f"{cls}_9.off").write_text("")
    got = port_meshes.discover_meshes(str(tmp_path), "train")
    assert got == jax_meshes.discover_meshes(str(tmp_path), "train")
    assert [(c, s) for c, s, _ in got] == [
        ("chair", "chair_0"), ("chair", "chair_1"), ("table", "table_0"),
        ("table", "table_1")]


def test_discover_meshes_refuses_a_mixed_tree(tmp_path):
    (tmp_path / "chair" / "train").mkdir(parents=True)
    (tmp_path / "table").mkdir()
    with pytest.raises(ValueError, match="mixed mesh tree"):
        port_meshes.discover_meshes(str(tmp_path), "train")


def test_demo_meshes_equal_jax(tmp_path):
    counts = [demo.generate(str(tmp_path / name), 1, 1, seed=2,
                            num_classes=40)
              for name, demo in (("port", port_demo), ("jax", jax_demo))]
    assert counts == [80, 80]
    found = [sorted(str(p.relative_to(tmp_path / name))
                    for p in (tmp_path / name).rglob("*.off"))
             for name in ("port", "jax")]
    assert found[0] == found[1] and len(found[0]) == 80
    for rel in found[0]:
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "jax" / rel).read_bytes()), rel
