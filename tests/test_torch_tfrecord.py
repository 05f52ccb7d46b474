"""The port's TFRecord path without TensorFlow (`data/tfrecord.py`,
`data/build_tfrecords.py`) against the JAX package's tf.data one, on the
CPU: files written by either package read by the other (records equal as
Examples), CRCs checked, eval batches equal to the tf.data reader's in
order on one shard and as a set over several, the geometry helpers against
TF's ops, and train mode held by contract (geometry, dtypes, ranges, crop
bounds, every record seen, shards disjoint, determinism under the seed),
since TF's random numbers cannot be matched.

Tolerances, eval batches against tf.data: float32 views within 1e-5 (read
at most 3.6e-7: the same bilinear weights summed in another order) and
uint8 views within one level (rounding ties of those floats); labels equal.
JPEG records: within 6 levels of 255 at any pixel and 1 level on average
(read 3.9-4.1 and 0.44-0.51 at 40x40 and 224x224): TF decodes JPEG with
libjpeg's fast integer DCT, its default, and the native pool (the JAX
package's own decoder) with the accurate one.
"""

import dataclasses
import glob
import importlib
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
tf = pytest.importorskip("tensorflow")

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.data import tfrecord as jax_tfr  # noqa: E402
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.data import make_dataset  # noqa: E402
from gvcnn_tf_tpu_torch.data import tfrecord as tfr  # noqa: E402
from test_torch_loaders import V, procedural_tree  # noqa: E402

jax_pipeline = importlib.import_module("gvcnn_tf_tpu.data.pipeline")
F32_TOL, U8_LEVELS = 1e-5, 1
JPEG_MAX_LEVELS, JPEG_MEAN_LEVELS = 6, 1
H = 32
SHAPES = 14


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A PNG tree (14 shapes, 40x40), its TFRecords written by each
    package (train: 3 shards; validation: 1 and 3 shards)."""
    root = tmp_path_factory.mktemp("tfr")
    tree = procedural_tree(root / "tree")
    out = {"tree": tree}
    for name, mod in (("port", tfr), ("jax", jax_tfr)):
        for split, shards in (("train", 3), ("validation", 1)):
            mod.build_tfrecords(tree, str(root / name), V, split_name=split,
                                num_shards=shards)
        mod.build_tfrecords(tree, str(root / f"{name}3"), V,
                            split_name="validation", num_shards=3)
        out[name] = str(root / name)
        out[f"{name}3"] = str(root / f"{name}3")
    return out


def _files(d, split="validation"):
    return sorted(glob.glob(os.path.join(d, f"{split}-*.tfrecord")))


def test_discover_shapes_is_the_jax_source():
    assert inspect.getsource(tfr.discover_shapes) == inspect.getsource(
        jax_tfr.discover_shapes)


def _tf_examples(files):
    return [tf.train.Example.FromString(r.numpy())
            for r in tf.data.TFRecordDataset(files)]


def _as_dict(ex):
    out = {}
    for k, f in ex.features.feature.items():
        kind = f.WhichOneof("kind")
        out[k] = list(getattr(f, kind).value)
    return out


@pytest.mark.parametrize("split", ["train", "validation"])
def test_tf_reads_the_port_s_files(trees, split):
    """TF's reader (CRCs checked) parses the port's files into the JAX
    package's Examples, record for record and file for file."""
    got = [_tf_examples([f]) for f in _files(trees["port"], split)]
    want = [_tf_examples([f]) for f in _files(trees["jax"], split)]
    assert [len(g) for g in got] == [len(w) for w in want]
    assert sum(len(g) for g in got) == SHAPES
    for g, w in zip(got, want):
        assert [_as_dict(a) for a in g] == [_as_dict(b) for b in w]
    ex = _as_dict(got[0][0])
    assert len(ex["image/encoded"]) == V and ex["image/format"] == [b"png"]
    assert open(os.path.join(trees["port"], "labels.txt")).read() == open(
        os.path.join(trees["jax"], "labels.txt")).read()


@pytest.mark.parametrize("split", ["train", "validation"])
def test_the_port_reads_tf_s_files(trees, split):
    for f in _files(trees["jax"], split):
        got = [tfr.decode_example(r) for r in tfr.read_records(f)]
        assert got == [_as_dict(e) for e in _tf_examples([f])]


def test_example_values_round_trip():
    feats = {"a": [b"", b"xyz"], "n": [0, 1, -1, 2 ** 40, -(2 ** 63)],
             "s": [b"id"]}
    ser = tfr.encode_example(feats)
    assert tfr.decode_example(ser) == feats
    assert _as_dict(tf.train.Example.FromString(ser)) == feats


@pytest.mark.parametrize("where", ["length", "data"])
def test_a_corrupted_record_is_refused(trees, tmp_path, where):
    raw = bytearray(open(_files(trees["port"])[0], "rb").read())
    raw[4 if where == "length" else 40] ^= 0x10
    bad = tmp_path / "bad.tfrecord"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=f"corrupted record \\({where}"):
        list(tfr.read_records(str(bad)))


def _kw(**kw):
    base = dict(num_views=V, height=H, width=H, batch_size=4, train=False,
                drop_remainder=False)
    base.update(kw)
    return base


def _close(got, want, raw):
    assert got["views"].dtype == want["views"].dtype
    assert got["views"].shape == want["views"].shape
    np.testing.assert_array_equal(got["label"], want["label"])
    assert got["label"].dtype == want["label"].dtype == np.int32
    diff = np.abs(got["views"].astype(np.float64) - want["views"])
    assert diff.max() <= (U8_LEVELS if raw else F32_TOL)


@pytest.mark.parametrize("pre", ["square", "slim"])
@pytest.mark.parametrize("raw", [False, True], ids=["float32", "uint8"])
def test_eval_batches_equal_tf_data_in_order(trees, pre, raw):
    kw = _kw(preprocessing=pre, raw_uint8=raw)
    got = list(tfr.tfrecord_dataset(_files(trees["port"]), **kw))
    want = list(jax_tfr.tfrecord_dataset(_files(trees["jax"]), **kw))
    assert [len(b["label"]) for b in got] == [4, 4, 4, 2]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, raw)


@pytest.mark.parametrize("num_shards", [1, 2])
def test_eval_batches_over_several_files_are_tf_data_s_set(trees,
                                                           num_shards):
    """Three files (and record-level shards of them): the same shapes and
    views as tf.data's, matched by label and pixels."""
    def per_shard(mod, d):
        recs = []
        for s in range(num_shards):
            for b in mod.tfrecord_dataset(
                    os.path.join(d, "validation-*.tfrecord"),
                    **_kw(shard_index=s, num_shards=num_shards)):
                recs += list(zip(b["label"], b["views"]))
        return recs

    got = per_shard(tfr, trees["port3"])
    want = per_shard(jax_tfr, trees["jax3"])
    assert len(got) == len(want) == SHAPES
    key = lambda r: (int(r[0]), r[1].round(3).tobytes())  # noqa: E731
    for (gl, gv), (wl, wv) in zip(sorted(got, key=key),
                                  sorted(want, key=key)):
        assert gl == wl
        assert np.abs(gv - wv).max() <= F32_TOL


def test_jpeg_records_are_within_the_stated_tolerance(trees, tmp_path):
    """A JPEG tree (export_tree) through both readers, to JPEG's stated
    tolerance (the two decoders' DCTs differ)."""
    from gvcnn_tf_tpu_torch.tools.export_renders import export_tree

    export_tree(str(tmp_path / "jpg"), num_classes=10, num_views=V,
                height=40, width=40, num_shapes=6)
    tfr.build_tfrecords(str(tmp_path / "jpg"), str(tmp_path / "r"), V,
                        split_name="validation", num_shards=1)
    files = _files(str(tmp_path / "r"))
    got = list(tfr.tfrecord_dataset(files, **_kw()))
    want = list(jax_tfr.tfrecord_dataset(files, **_kw()))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["label"], w["label"])
        levels = np.abs(g["views"].astype(np.float64) - w["views"]) * 127.5
        assert levels.max() <= JPEG_MAX_LEVELS
        assert levels.mean() <= JPEG_MEAN_LEVELS


@pytest.mark.parametrize("shape,fraction", [
    ((40, 40), 0.875), ((224, 224), 0.875), ((31, 57), 0.5),
    ((300, 280), 0.9), ((7, 9), 0.33), ((64, 48), 1.0)])
def test_central_crop_box_is_tf_s(shape, fraction):
    h, w = shape
    img = np.arange(h * w, dtype=np.float32).reshape(h, w, 1)
    want = tf.image.central_crop(img, central_fraction=fraction).numpy()
    top, left, ch, cw = tfr.central_crop_box(h, w, fraction)
    np.testing.assert_array_equal(img[top:top + ch, left:left + cw], want)


@pytest.mark.parametrize("shape", [(40, 40), (224, 224), (30, 90)])
def test_distorted_bounding_box_bounds(shape):
    """The crop's area is 10-100% of the image (min_object_covered 0.1 over
    area_range 0.05-1), its aspect within 3/4-4/3 up to the rounding of
    its width, it lies inside the image; draws vary and repeat with the
    seed."""
    h, w = shape
    boxes = []
    rng = np.random.RandomState(0)
    for _ in range(300):
        top, left, ch, cw = tfr.sample_distorted_bounding_box(h, w, rng)
        boxes.append((top, left, ch, cw))
        assert 0 <= top and top + ch <= h and 0 <= left and left + cw <= w
        assert 0.1 <= ch * cw / (h * w) <= 1.0
        if (ch, cw) != (h, w):
            assert 0.75 - 0.5 / ch <= cw / ch <= 1.333 + 0.5 / ch
    assert len(set(boxes)) > 50
    rng = np.random.RandomState(0)
    assert [tfr.sample_distorted_bounding_box(h, w, rng)
            for _ in range(300)] == boxes


@pytest.mark.parametrize("pre", ["square", "slim"])
@pytest.mark.parametrize("raw", [False, True], ids=["float32", "uint8"])
def test_train_mode_contract(trees, pre, raw):
    kw = _kw(train=True, drop_remainder=True, preprocessing=pre,
             raw_uint8=raw, seed=5, shuffle_buffer=8)
    pattern = os.path.join(trees["port"], "train-*.tfrecord")
    it = tfr.tfrecord_dataset(pattern, **kw)
    batches = [next(it) for _ in range(8)]          # past one epoch
    again = tfr.tfrecord_dataset(pattern, **kw)
    for b in batches:
        v = b["views"]
        assert v.shape == (4, V, H, H, 3)
        assert v.dtype == (np.uint8 if raw else np.float32)
        if not raw:
            assert -1.0 <= v.min() and v.max() <= 1.0
        assert b["label"].dtype == np.int32
        c = next(again)                             # determinism
        np.testing.assert_array_equal(c["views"], v)
        np.testing.assert_array_equal(c["label"], b["label"])
    other = next(tfr.tfrecord_dataset(pattern, **dict(kw, seed=6)))
    assert not np.array_equal(other["views"], batches[0]["views"])
    # The same record's views differ from eval's (crops and flips).
    want = list(jax_tfr.tfrecord_dataset(pattern, **dict(
        kw, seed=5, train=True)).__next__()["views"].shape)
    assert want == [4, V, H, H, 3]


@pytest.mark.parametrize("buffer", [1, 5, 1024])
def test_train_records_cover_each_epoch(trees, buffer):
    files = _files(trees["port"], "train")
    every = sorted(r for f in files for r in tfr.read_records(f))
    stream = tfr.record_stream(files, train=True, seed=1,
                               shuffle_buffer=buffer)
    epochs = [[next(stream) for _ in range(SHAPES)] for _ in range(3)]
    for e in epochs:
        assert sorted(e) == every
    assert epochs[0] != epochs[1] or buffer == 1


def test_two_shards_are_disjoint_and_cover_the_split(trees):
    files = _files(trees["port"], "train")
    shards = [list(tfr.record_stream(files, train=False, shard_index=s,
                                     num_shards=2)) for s in range(2)]
    assert len(shards[0]) == 7 and len(shards[1]) == 7
    assert not set(shards[0]) & set(shards[1])
    assert sorted(shards[0] + shards[1]) == sorted(
        r for f in files for r in tfr.read_records(f))
    # Train: each epoch shuffles the file order (the same on both
    # shards), so the shards' epochs are disjoint and cover the split.
    streams = [tfr.record_stream(files, train=True, seed=3, shard_index=s,
                                 num_shards=2) for s in range(2)]
    for _ in range(3):
        a, b = ([next(st) for _ in range(7)] for st in streams)
        assert not set(a) & set(b)
        assert sorted(a + b) == sorted(shards[0] + shards[1])


def _cfg(mod, d, **kw):
    return dataclasses.replace(mod.DataConfig(), dataset_dir=d,
                               num_views=V, height=H, width=H, batch_size=4,
                               **kw)


@pytest.mark.parametrize("loader", ["auto", "tfrecord"])
def test_make_dataset_eval_matches_jax(trees, loader):
    got = list(make_dataset(_cfg(port_configs, trees["port"], loader=loader),
                            train=False, num_epochs=1))
    want = list(jax_pipeline.make_dataset(
        _cfg(jax_configs, trees["jax"], loader=loader), train=False,
        num_epochs=1))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w, False)


def test_dataset_size_matches_jax(trees):
    for train in (True, False):
        for cheap in (True, False):
            assert jax_pipeline.dataset_size(
                _cfg(jax_configs, trees["jax"], loader="tfrecord"),
                train=train, cheap_only=cheap) == \
                tfr_size(trees["port"], train, cheap)
    from gvcnn_tf_tpu_torch.data import dataset_size

    assert dataset_size(_cfg(port_configs, trees["tree"], loader="native"),
                        cheap_only=True) == SHAPES


def tfr_size(d, train, cheap):
    from gvcnn_tf_tpu_torch.data import dataset_size

    return dataset_size(_cfg(port_configs, d, loader="tfrecord"),
                        train=train, cheap_only=cheap)


def test_make_dataset_without_records_raises(tmp_path):
    cfg = _cfg(port_configs, str(tmp_path), loader="tfrecord")
    with pytest.raises(FileNotFoundError, match="build_tfrecords"):
        make_dataset(cfg, train=True)


def test_build_tfrecords_cli(trees, tmp_path, capsys):
    from gvcnn_tf_tpu_torch.data import build_tfrecords

    build_tfrecords.main(["--image_dir", trees["tree"], "--output_dir",
                          str(tmp_path), "--num_views", str(V),
                          "--num_shards", "2", "--split_name",
                          "validation"])
    paths = capsys.readouterr().out.split()
    assert [os.path.basename(p) for p in paths] == [
        "validation-00000-of-00002.tfrecord",
        "validation-00001-of-00002.tfrecord"]
    assert sum(tfr.count_records(p) for p in paths) == SHAPES
    with pytest.raises(SystemExit, match="no shapes with >= 99 views"):
        build_tfrecords.main(["--image_dir", trees["tree"], "--output_dir",
                              str(tmp_path / "x"), "--num_views", "99"])


@pytest.fixture
def no_pool(tmp_path, monkeypatch):
    """A compiler that fails every build that links libjpeg (the card's
    machine: no jpeglib.h) and builds the rest with g++: the CRC library
    builds, the decode pool refuses."""
    from gvcnn_tf_tpu_torch.data import native_loader

    cxx = tmp_path / "cxx"
    cxx.write_text(
        '#!/bin/sh\n'
        'case "$*" in *-ljpeg*) echo "x.cc:1:10: fatal error: jpeglib.h: '
        'No such file or directory" >&2; exit 1;; esac\n'
        'exec g++ "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native_loader, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_libs", {})
    monkeypatch.setattr(native_loader, "_errors", {})
    monkeypatch.setattr(native_loader, "_target", None)
    return native_loader


@pytest.mark.parametrize("raw", [False, True], ids=["float32", "uint8"])
def test_the_reader_decodes_with_pil_without_the_pool(trees, no_pool, raw,
                                                      capsys):
    """Where libjpeg is missing but PIL imports, the reader decodes with
    PIL, says so, and yields the pool's batches exactly (PNG)."""
    kw = _kw(raw_uint8=raw)
    got = list(tfr.tfrecord_dataset(_files(trees["port"]), **kw))
    assert "tfrecord: decoding with PIL (native loader unavailable: " \
           "missing libjpeg's header jpeglib.h" in capsys.readouterr().err
    assert not no_pool.available()
    no_pool._libs.clear(), no_pool._errors.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("CXX")
        mp.setattr(no_pool, "_target", None)
        want = list(tfr.tfrecord_dataset(_files(trees["port"]), **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["views"], w["views"])
        np.testing.assert_array_equal(g["label"], w["label"])


def test_the_reader_refuses_without_pool_or_pil(trees, no_pool,
                                                monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="neither is here.*jpeglib.h"):
        tfr.tfrecord_dataset(_files(trees["port"]), **_kw())
