"""The port's image-tree loaders against the JAX package's, on the CPU: the
native decode pool (`data/native_loader.py`, its C++ copy pinned), the
decode-once cache (`data/decoded_cache.py`) and its on-card flip in the
train step, the tools that write trees (`render_tree`, `export_tree`), the
library's build (first use, lock, host key, refusals) and the dispatch in
`make_dataset`.  Trees are small (40x40 PNG renders of the procedural
split, 3 views, 14 shapes: a ragged last batch at B = 4) and written from
a seed.  The JAX package's native library is compiled into a temporary
directory, never inside `gvcnn_tf_tpu/`.
"""

import dataclasses
import importlib
import inspect
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.data import decoded_cache as jax_cache  # noqa: E402
from gvcnn_tf_tpu.data import native_loader as jax_native  # noqa: E402
from gvcnn_tf_tpu.data.procedural import (  # noqa: E402
    build_procedural_split as jax_split,
)
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.data import decoded_cache  # noqa: E402
from gvcnn_tf_tpu_torch.data import make_dataset  # noqa: E402
from gvcnn_tf_tpu_torch.data import native_loader  # noqa: E402
from gvcnn_tf_tpu_torch.utils import device_flip  # noqa: E402
from gvcnn_tf_tpu_torch.utils.png import write_png  # noqa: E402

jax_pipeline = importlib.import_module("gvcnn_tf_tpu.data.pipeline")
port_train = importlib.import_module("gvcnn_tf_tpu_torch.train")

REPO = str(Path(__file__).resolve().parent.parent)
V, RES, SHAPES, CLASSES, B = 3, 40, 14, 10, 4
GEOM = dict(num_views=V, height=32, width=32, batch_size=B)


def write_png_tree(root, views, labels, names, ext="png"):
    """views (N, V, H, W, 3) uint8 -> root/<class>/<class>_NNNN/view_NN.*
    (render_tree's and export_tree's layout)."""
    for i, (vs, lbl) in enumerate(zip(views, labels)):
        d = Path(root) / names[lbl] / f"{names[lbl]}_{i:04d}"
        d.mkdir(parents=True, exist_ok=True)
        for k, img in enumerate(vs):
            write_png(str(d / f"view_{k:02d}.{ext}"), img)
    return str(root)


def procedural_tree(root, num_shapes=SHAPES, train=True, res=RES):
    views, labels = jax_split(num_views=V, height=res, width=res,
                              num_shapes=num_shapes, seed=0,
                              train_split=train, num_classes=CLASSES)
    names = [f"class{c:02d}" for c in range(CLASSES)]
    return write_png_tree(root, views, labels, names)


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's loader built from its own source into a temporary
    directory, with its Makefile's flags, and its module pointed at it."""
    out = tmp_path_factory.mktemp("jaxlib") / "libgvloader.so"
    src = Path(REPO) / "gvcnn_tf_tpu" / "data" / "native" / "loader.cc"
    subprocess.run(["g++", *native_loader.CXXFLAGS, "-shared", "-o",
                    str(out), str(src), *native_loader.LDLIBS], check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO_PATH", str(out))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_lib_err", None)
        assert jax_native.available(), jax_native._lib_err
        yield jax_native


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return procedural_tree(tmp_path_factory.mktemp("tree"))


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a["views"].dtype == b["views"].dtype
        assert a["views"].shape == b["views"].shape
        np.testing.assert_array_equal(a["views"], b["views"])
        np.testing.assert_array_equal(a["label"], b["label"])
        assert a["label"].dtype == b["label"].dtype


def test_loader_cc_is_the_jax_copy():
    ours = Path(native_loader._NATIVE_DIR) / "loader.cc"
    theirs = Path(REPO) / "gvcnn_tf_tpu" / "data" / "native" / "loader.cc"
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("raw", [False, True], ids=["float32", "uint8"])
def test_native_dataset_matches_jax(tree, jax_lib, train, raw):
    kw = dict(GEOM, train=train, num_epochs=2, seed=3, raw_uint8=raw,
              num_threads=2)
    _same_batches(list(native_loader.native_dataset(tree, **kw)),
                  list(jax_lib.native_dataset(tree, **kw)))


def test_native_dataset_shards_match_jax(tree, jax_lib):
    kw = dict(GEOM, train=False, num_epochs=1, shard_index=1, num_shards=2)
    _same_batches(list(native_loader.native_dataset(tree, **kw)),
                  list(jax_lib.native_dataset(tree, **kw)))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("raw", [False, True], ids=["float32", "uint8"])
def test_decoded_dataset_matches_jax(tree, jax_lib, tmp_path, train, raw):
    """The host flip (augment) included; each package over its own cache
    directory, so both build one."""
    kw = dict(GEOM, train=train, num_epochs=2, seed=1, raw_uint8=raw,
              augment=True)
    got = list(decoded_cache.decoded_dataset(
        tree, cache_dir=str(tmp_path / "port"), **kw))
    want = list(jax_cache.decoded_dataset(
        tree, cache_dir=str(tmp_path / "jax"), **kw))
    _same_batches(got, want)
    a, b = (sorted(os.listdir(tmp_path / d)) for d in ("port", "jax"))
    assert a == b and len(a) == 2            # the same key, file for file
    for name in a:
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("first", ["port", "jax"])
def test_each_package_reuses_the_other_s_cache(tree, jax_lib, tmp_path,
                                               first):
    geom = dict(num_views=V, height=24, width=24, cache_dir=str(tmp_path))
    builders = {"port": decoded_cache.build_decoded_cache,
                "jax": jax_cache.build_decoded_cache}
    second = "jax" if first == "port" else "port"
    data, meta = builders[first](tree, **geom)
    stamp = os.stat(data).st_mtime_ns
    assert builders[second](tree, **geom) == (data, meta)
    assert os.stat(data).st_mtime_ns == stamp   # read, not rebuilt
    assert len(os.listdir(tmp_path)) == 2


def test_decoded_cache_refuses_without_a_decoder(tree, tmp_path,
                                                 monkeypatch):
    """No native pool and no PIL: a refusal that names both."""
    def unavailable(num_threads=0):
        raise RuntimeError("native loader unavailable: missing libpng")

    monkeypatch.setattr(native_loader, "NativeDecoder", unavailable)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="neither is here.*libpng"):
        decoded_cache.build_decoded_cache(tree, num_views=V, height=16,
                                          width=16, cache_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []         # no tmp file left behind


def test_decoded_cache_decodes_with_pil_without_the_pool(tree, tmp_path,
                                                        monkeypatch, capsys):
    """No native pool, PIL present: the cache is built with PIL, the log
    says so, and at the tree's own size its bytes are the pool's."""
    want, _ = decoded_cache.build_decoded_cache(
        tree, num_views=V, height=RES, width=RES,
        cache_dir=str(tmp_path / "pool"))

    def unavailable(num_threads=0):
        raise RuntimeError("native loader unavailable: missing libjpeg's "
                           "header jpeglib.h\nmore output")

    monkeypatch.setattr(native_loader, "NativeDecoder", unavailable)
    got, _ = decoded_cache.build_decoded_cache(
        tree, num_views=V, height=RES, width=RES,
        cache_dir=str(tmp_path / "pil"))
    assert "decoded cache: decoding with PIL (native loader unavailable: " \
           "missing libjpeg's header jpeglib.h)" in capsys.readouterr().err
    assert Path(got).read_bytes() == Path(want).read_bytes()


def _data_cfg(mod, **kw):
    return dataclasses.replace(mod.DataConfig(), **dict(GEOM, **kw))


@pytest.mark.parametrize("loader", ["native", "decoded"])
@pytest.mark.parametrize("wire", ["auto", "uint8"])
def test_make_dataset_matches_jax(tree, jax_lib, loader, wire):
    """The dispatch passes the JAX package's arguments: train batches equal
    (decoded: verbatim, the flip is the step's, `device_flip` on by
    default)."""
    kw = dict(dataset_dir=tree, loader=loader, transfer_dtype=wire)
    got = make_dataset(_data_cfg(port_configs, **kw), train=True, seed=2)
    want = jax_pipeline.make_dataset(_data_cfg(jax_configs, **kw),
                                     train=True, seed=2)
    _same_batches([next(got) for _ in range(5)],
                  [next(want) for _ in range(5)])


def test_decoded_step_streams_verbatim_batches(tree):
    cfg = _data_cfg(port_configs, dataset_dir=tree, loader="decoded",
                    transfer_dtype="uint8")
    got = make_dataset(cfg, train=True, seed=4)
    want = decoded_cache.decoded_dataset(tree, train=True, seed=4,
                                         raw_uint8=True, augment=False,
                                         **GEOM)
    _same_batches([next(got) for _ in range(4)],
                  [next(want) for _ in range(4)])
    flipped = make_dataset(dataclasses.replace(cfg, device_flip=False),
                           train=True, seed=4)
    host = decoded_cache.decoded_dataset(tree, train=True, seed=4,
                                         raw_uint8=True, augment=True,
                                         **GEOM)
    _same_batches([next(flipped) for _ in range(4)],
                  [next(host) for _ in range(4)])


def test_device_flip_with_a_given_mask():
    views = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (3, 4, 5, 6, 3)).astype(np.uint8))
    mask = torch.tensor([[1, 0, 0, 1], [0, 0, 0, 0], [1, 1, 1, 0]],
                        dtype=torch.bool)
    got = device_flip(views, mask).numpy()
    want = views.numpy().copy()
    for s, v in zip(*np.nonzero(mask.numpy())):
        want[s, v] = want[s, v, :, ::-1]
    np.testing.assert_array_equal(got, want)


def _flip_cfg(tree, **kw):
    cfg = port_configs.get_config("mn40_12view")
    return cfg.replace(compute_dtype="float32", dropout_keep_prob=1.0,
                       data=_data_cfg(port_configs, dataset_dir=tree,
                                      loader="decoded", num_classes=CLASSES,
                                      transfer_dtype="uint8", **kw))


def test_flip_mask_is_half_and_fresh_each_step(tree):
    cfg = _flip_cfg(tree)
    state = port_train.create_train_state(cfg, "cpu")
    masks = []
    for step in range(40):
        state.step = step
        masks.append(port_train.flip_mask(state, cfg, (8, 12)))
    m = torch.stack(masks).float()
    # 3840 Bernoulli(0.5) draws: the mean within 5 standard deviations.
    assert abs(float(m.mean()) - 0.5) < 5 * 0.5 / np.sqrt(m.numel())
    assert not torch.equal(masks[0], masks[1])
    state.step = 0
    assert torch.equal(port_train.flip_mask(state, cfg, (8, 12)), masks[0])


def test_decoded_train_step_flips_on_the_device(tree):
    """A `loader="decoded"` step equals the unflipped step on the batch
    flipped by its mask; with `device_flip` off (or `augment` off) the
    step does not flip."""
    cfg = _flip_cfg(tree)
    batch = next(make_dataset(cfg.data, train=True, seed=0))
    batch = {"views": torch.from_numpy(batch["views"]),
             "label": torch.from_numpy(batch["label"]).long()}
    ref = port_train.create_train_state(cfg, "cpu")
    mask = port_train.flip_mask(ref, cfg, tuple(batch["views"].shape[:2]))
    assert 0 < int(mask.sum()) < mask.numel()
    flipped = {"views": device_flip(batch["views"], mask),
               "label": batch["label"]}
    plain = cfg.replace(data=dataclasses.replace(cfg.data, device_flip=False))
    results = {}
    for name, c, b in (("decoded", cfg, batch), ("by_hand", plain, flipped),
                       ("no_flip", plain, batch)):
        state = port_train.create_train_state(c, "cpu")
        results[name] = float(port_train.train_step(state, b, c)["loss"])
    assert results["decoded"] == results["by_hand"]
    assert results["decoded"] != results["no_flip"]


# ---------------------------------------------------------------------------
# The tools that write trees
# ---------------------------------------------------------------------------

def test_render_tree_matches_jax(tmp_path):
    from PIL import Image

    from gvcnn_tf_tpu.tools import render_meshes as jax_meshes
    from gvcnn_tf_tpu_torch.tools import make_demo_meshes, render_meshes

    make_demo_meshes.generate(str(tmp_path / "m"), 1, 0, num_classes=10)
    n = render_meshes.render_tree(str(tmp_path / "m"), str(tmp_path / "p"),
                                  num_views=2, res=32)
    assert n == jax_meshes.render_tree(str(tmp_path / "m"),
                                       str(tmp_path / "j"), num_views=2,
                                       res=32) == 10
    got = sorted(p.relative_to(tmp_path / "p")
                 for p in (tmp_path / "p").rglob("*.png"))
    assert got == sorted(p.relative_to(tmp_path / "j")
                         for p in (tmp_path / "j").rglob("*.png"))
    assert len(got) == 20
    for rel in got:
        a = np.asarray(Image.open(tmp_path / "p" / rel))
        b = np.asarray(Image.open(tmp_path / "j" / rel))
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_render_meshes_cli(tmp_path, capsys):
    from gvcnn_tf_tpu_torch.tools import make_demo_meshes, render_meshes

    make_demo_meshes.generate(str(tmp_path / "m"), 1, 0, num_classes=10)
    render_meshes.main(["--mesh_dir", str(tmp_path / "m"), "--output_dir",
                        str(tmp_path / "v"), "--num_views", "2", "--res",
                        "16"])
    assert "rendered 10 shapes" in capsys.readouterr().out
    assert len(list((tmp_path / "v").rglob("view_*.png"))) == 20


def _export(mod, out, **kw):
    return mod.export_tree(str(out), num_classes=CLASSES, num_views=V,
                           height=RES, width=RES, num_shapes=6, **kw)


# export_tree's JPEG tree through libjpeg (the card's machine: no PIL)
# against the JAX tool's PIL tree.  PIL here bundles its own libjpeg-turbo
# and the system's library is another build; with the same quantization
# tables and islow DCT both decode within one 8-bit level (measured: 0).
JPEG_LEVELS = 1


@pytest.mark.parametrize("encoder", ["PIL", "libjpeg"])
def test_export_tree_matches_jax(tmp_path, monkeypatch, encoder):
    from PIL import Image

    from gvcnn_tf_tpu.tools import export_renders as jax_export
    from gvcnn_tf_tpu_torch.tools import export_renders

    want = _export(jax_export, tmp_path / "j")
    if encoder == "libjpeg":
        monkeypatch.setitem(sys.modules, "PIL", None)
    got = _export(export_renders, tmp_path / "p")
    assert got.pop("encoder") == encoder
    assert {k: v for k, v in got.items() if k not in ("out", "jpeg_bytes")} \
        == {k: v for k, v in want.items() if k not in ("out", "jpeg_bytes")}
    monkeypatch.undo()
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*.jpg"))
    assert files == sorted(p.relative_to(tmp_path / "p")
                           for p in (tmp_path / "p").rglob("*.jpg"))
    worst = 0
    for rel in files:
        a = np.asarray(Image.open(tmp_path / "p" / rel), np.int16)
        b = np.asarray(Image.open(tmp_path / "j" / rel), np.int16)
        worst = max(worst, int(np.abs(a - b).max()))
        if encoder == "PIL":
            assert (tmp_path / "p" / rel).read_bytes() == (
                tmp_path / "j" / rel).read_bytes()
    assert worst <= JPEG_LEVELS


def test_bench_input_reports_the_jax_fields(tree):
    from gvcnn_tf_tpu.tools import bench_input as jax_bench
    from gvcnn_tf_tpu_torch.tools import bench_input

    def config(mod):
        cfg = mod.get_config("mn40_12view")
        return cfg.replace(data=_data_cfg(mod, dataset_dir=tree,
                                          loader="native"))

    got = bench_input.bench_input(config(port_configs), num_batches=4)
    want = jax_bench.bench_input(config(jax_configs), num_batches=4)
    assert set(got) == set(want)
    assert got["measured_batches"] == want["measured_batches"] == 4
    assert got["batch_geometry"] == [B, V, 32, 32, 3]
    assert got["views_per_sec"] > 0


# ---------------------------------------------------------------------------
# The library's build
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The native module with no library loaded and an empty build root."""
    monkeypatch.setattr(native_loader, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_libs", {})
    monkeypatch.setattr(native_loader, "_errors", {})
    monkeypatch.setattr(native_loader, "_target", None)
    return tmp_path


def _fake_cxx(path, target="-march= x86-64", error=""):
    path.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        case "$*" in *--help=target*) echo "{target}"; exit 0;; esac
        echo "{error}" >&2
        exit 1
        """))
    path.chmod(0o755)
    return str(path)


@pytest.mark.parametrize("error,names", [
    ("loader.cc:17:10: fatal error: jpeglib.h: No such file or directory",
     "jpeglib.h"),
    ("loader.cc:18:10: fatal error: png.h: No such file or directory",
     "png.h"),
    ("/usr/bin/ld: cannot find -ljpeg: No such file or directory",
     "libjpeg library"),
    ("/usr/bin/ld: cannot find -lpng: No such file or directory",
     "libpng library"),
])
def test_a_missing_dependency_is_named(fresh_build, monkeypatch, error,
                                       names):
    monkeypatch.setenv("CXX", _fake_cxx(fresh_build / "cxx", error=error))
    for call in (native_loader.library, lambda: native_loader.NativeDecoder(),
                 lambda: make_dataset(_data_cfg(
                     port_configs, dataset_dir=str(fresh_build),
                     loader="native"), train=True)):
        with pytest.raises(RuntimeError, match=f"unavailable: missing .*"
                                               f"{names}"):
            call()
    assert not native_loader.available()
    assert not list(native_loader.library_path().parent.glob("*.so*"))


def test_no_compiler_is_a_refusal(fresh_build, monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_loader.library()


def test_the_build_key_follows_the_host_cpu(fresh_build, monkeypatch):
    monkeypatch.setenv("CXX", _fake_cxx(fresh_build / "a",
                                        target="-march= skylake"))
    first = native_loader.library_path()
    monkeypatch.setattr(native_loader, "_target", None)
    monkeypatch.setenv("CXX", _fake_cxx(fresh_build / "b",
                                        target="-march= neoverse-v2"))
    second = native_loader.library_path()
    assert first != second
    assert first.parent.parent == second.parent.parent == (
        fresh_build / "build")


def test_concurrent_first_uses_build_once(tmp_path):
    """Two processes load the library from an empty build root at once:
    both get it, one library is published, no temporary file is left,
    and nothing was built at import."""
    code = textwrap.dedent(f"""\
        import sys
        from pathlib import Path
        from gvcnn_tf_tpu_torch.data import native_loader as n
        import gvcnn_tf_tpu_torch.data.pipeline
        import gvcnn_tf_tpu_torch.data.tfrecord
        import gvcnn_tf_tpu_torch.data.decoded_cache
        assert not n._libs and n._target is None    # nothing at import
        n.BUILD_ROOT = Path({str(tmp_path)!r})
        assert n.masked_crc32c(b"hello") == 0x191c1fbb
        n.NativeDecoder(1)
        print(n.library_path(n.RECORDS_LIB), n.library_path())
        """)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    for path in paths.pop().split():
        files = sorted(f.name for f in Path(path).parent.iterdir())
        assert files == [".lock", Path(path).name]


def test_the_file_loaders_import_no_tensorflow(tree, tmp_path):
    """make_dataset of each file loader, one batch each, in a process that
    imports neither TensorFlow, JAX nor the JAX package."""
    from gvcnn_tf_tpu_torch.data.tfrecord import build_tfrecords

    tfr = tmp_path / "tfr"
    build_tfrecords(tree, str(tfr), V, num_shards=2)
    code = textwrap.dedent(f"""\
        import dataclasses, sys
        from gvcnn_tf_tpu_torch.configs import DataConfig
        from gvcnn_tf_tpu_torch.data import make_dataset
        import gvcnn_tf_tpu_torch.tools.render_meshes
        import gvcnn_tf_tpu_torch.tools.export_renders
        import gvcnn_tf_tpu_torch.tools.bench_input
        import gvcnn_tf_tpu_torch.data.build_tfrecords
        for loader, root in (("native", {tree!r}), ("decoded", {tree!r}),
                             ("tfrecord", {str(tfr)!r})):
            cfg = dataclasses.replace(
                DataConfig(), dataset_dir=root, loader=loader, num_views={V},
                height=16, width=16, batch_size=2)
            b = next(iter(make_dataset(cfg, train=True)))
            assert b["views"].shape == (2, {V}, 16, 16, 3), loader
        for name in ("tensorflow", "jax", "gvcnn_tf_tpu", "PIL"):
            assert name not in sys.modules, name
        """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr


def test_native_dataset_is_the_jax_generator_s_body():
    """The port's dataset function is the JAX one with only its import
    line changed."""
    ours = inspect.getsource(native_loader.native_dataset)
    theirs = inspect.getsource(jax_native.native_dataset)
    swap = ("from gvcnn_tf_tpu.data.tfrecord import discover_shapes",
            "from gvcnn_tf_tpu_torch.data.tfrecord import discover_shapes")
    strip = lambda s: s.split('"""')[2]  # noqa: E731  (past the docstring)
    assert strip(ours) == strip(theirs.replace(*swap))
