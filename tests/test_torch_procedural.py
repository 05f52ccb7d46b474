"""The port's procedural split (`gvcnn_tf_tpu_torch/data/procedural.py`) and
its dispatch against the JAX package's, on the CPU.

Exact: every mesh builder's vertices and faces, the renders, the split's
uint8 bytes and labels (10 classes easy and hard, 40 classes), the float
and raw-uint8 batches of train and eval (ragged tail) streams, the loader
dispatch, the class names and the disk cache's files.  A stream restored
from its `state_dict` mid-epoch continues with the same batches.  The
prefetcher ships uint8 views as uint8 whatever the float wire, and takes
depth 0 as 1.  Renders are 32x32 (16x16 for the cache), 2-4 views.
"""

import dataclasses
import importlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.data import procedural as jax_proc  # noqa: E402
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.data import (  # noqa: E402
    DevicePrefetcher,
    ProceduralStream,
    dataset_size,
    make_dataset,
)
from gvcnn_tf_tpu_torch.data import procedural as port_proc  # noqa: E402

jax_pipeline = importlib.import_module("gvcnn_tf_tpu.data.pipeline")


def _same(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b) == {"views", "label"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("index", range(len(jax_proc.CLASSES40)))
def test_mesh_builder_equals_jax(index):
    (name, build), (jname, jbuild) = (port_proc.CLASSES40[index],
                                      jax_proc.CLASSES40[index])
    assert name == jname
    verts, faces = build(np.random.RandomState(index))
    jverts, jfaces = jbuild(np.random.RandomState(index))
    assert verts.dtype == jverts.dtype and faces.dtype == jfaces.dtype
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)


def test_render_views_equal_jax():
    verts, faces = port_proc.CLASSES[5][1](np.random.RandomState(3))
    kw = dict(num_views=6, res=32, azimuth0=0.3, topdown_every=2,
              topdown_deg=85.0)
    got = port_proc.render_views(verts, faces, **kw)
    assert got.tobytes() == jax_proc.render_views(verts, faces, **kw).tobytes()
    assert np.abs(got[0] - got[2]).mean() > 0.003        # views differ


@pytest.mark.parametrize("num_classes,hard,train_split", [
    (10, False, True), (10, True, False), (40, False, True)])
def test_split_is_byte_identical_to_jax(num_classes, hard, train_split):
    kw = dict(num_views=4, height=32, width=32, num_shapes=num_classes + 3,
              seed=2, train_split=train_split, hard=hard,
              num_classes=num_classes)
    views, labels = port_proc.build_procedural_split(**kw)
    jviews, jlabels = jax_proc.build_procedural_split(**kw)
    assert views.dtype == jviews.dtype == np.uint8
    assert views.shape == (num_classes + 3, 4, 32, 32, 3)
    assert labels.dtype == jlabels.dtype
    assert views.tobytes() == jviews.tobytes()
    np.testing.assert_array_equal(labels, jlabels)


@pytest.mark.parametrize("raw_uint8", [False, True])
@pytest.mark.parametrize("train,extra", [
    (True, {}), (False, {}),
    (True, dict(shard_index=1, num_shards=3, hard=True, batch_size=2)),
])
def test_batches_are_byte_identical_to_jax(train, extra, raw_uint8):
    kw = dict(num_classes=10, num_views=2, height=32, width=32,
              batch_size=4, num_shapes=10, seed=3, train=train,
              num_epochs=2, raw_uint8=raw_uint8)
    kw.update(extra)
    got = list(port_proc.procedural_dataset(**kw))
    _same(got, list(jax_proc.procedural_dataset(**kw)))
    if not extra:
        # Train drops the ragged tail; eval yields it short.
        assert [len(b["label"]) for b in got] == (
            [4, 4] * 2 if train else [4, 4, 2] * 2)
    assert got[0]["views"].dtype == (np.uint8 if raw_uint8 else np.float32)


def test_stream_resumes_from_its_state():
    kw = dict(num_classes=10, num_views=2, height=32, width=32,
              batch_size=3, num_shapes=10, seed=4, raw_uint8=True)
    whole = ProceduralStream(**kw)
    ref = [next(whole) for _ in range(8)]
    part = ProceduralStream(**kw)
    for _ in range(4):                # 3 batches an epoch: mid-epoch 2
        next(part)
    buf = io.BytesIO()                # the serialisation a checkpoint uses
    torch.save(part.state_dict(), buf)
    buf.seek(0)
    resumed = ProceduralStream(**kw)
    resumed.load_state_dict(torch.load(buf, weights_only=True))
    _same([next(resumed) for _ in range(4)], ref[4:])


@pytest.mark.parametrize("num_classes", [10, 40])
def test_class_names_equal_jax(num_classes):
    names = port_proc.class_names(num_classes)
    assert names == jax_proc.class_names(num_classes)
    assert len(set(names)) == num_classes
    with pytest.raises(ValueError, match="10 or 40"):
        port_proc.class_table(num_classes + 1)


def test_disk_cache_round_trips(tmp_path, monkeypatch):
    monkeypatch.setenv("GVCNN_PROC_CACHE", str(tmp_path))
    kw = dict(num_views=2, height=16, width=16, num_shapes=3, seed=9,
              train_split=True)
    try:
        port_proc.build_procedural_split.cache_clear()
        views, labels = port_proc.build_procedural_split(**kw)
        files = list(tmp_path.glob("proc_*.npz"))
        assert len(files) == 1
        port_proc.build_procedural_split.cache_clear()
        again, again_labels = port_proc.build_procedural_split(**kw)
        assert again is not views and again.tobytes() == views.tobytes()
        np.testing.assert_array_equal(again_labels, labels)
        # The JAX package keys the same split to the same file.
        jax_proc.build_procedural_split.cache_clear()
        jviews, _ = jax_proc.build_procedural_split(**kw)
        assert jviews.tobytes() == views.tobytes()
        assert list(tmp_path.glob("proc_*.npz")) == files
    finally:
        port_proc.build_procedural_split.cache_clear()
        jax_proc.build_procedural_split.cache_clear()


@pytest.mark.parametrize("dataset,wire", [("procedural", "uint8"),
                                          ("procedural_hard", "float32")])
@pytest.mark.parametrize("train", [True, False])
def test_make_dataset_matches_jax_for_the_procedural_loader(dataset, wire,
                                                             train):
    kw = dict(height=32, width=32, num_views=2, batch_size=4,
              num_classes=10, synthetic_num_shapes=10, dataset=dataset,
              transfer_dtype=wire)
    cfg = dataclasses.replace(port_configs.DataConfig(), **kw)
    # The JAX package stages a uint8 train split on the device under
    # device_resident="auto" and shuffles it there; the port's make_dataset
    # streams it when it is given no device.
    jcfg = dataclasses.replace(jax_configs.DataConfig(), **kw,
                               device_resident="off")
    got = list(make_dataset(cfg, train=train, seed=5, num_epochs=1))
    _same(got, list(jax_pipeline.make_dataset(jcfg, train=train, seed=5,
                                              num_epochs=1)))
    assert dataset_size(cfg) == 10
    assert got[0]["views"].dtype == (np.uint8 if wire == "uint8"
                                     else np.float32)


def test_prefetcher_keeps_uint8_views_and_takes_depth_0_as_1():
    batches = [{"views": np.full((2, 1, 4, 4, 3), 200 + i, np.uint8),
                "label": np.arange(2, dtype=np.int32)} for i in range(3)]
    with DevicePrefetcher(iter(batches), torch.device("cpu"), "bfloat16",
                          depth=0) as it:
        got = list(it)
    assert len(got) == 3
    for i, b in enumerate(got):
        assert b["views"].dtype == torch.uint8
        assert bool((b["views"] == 200 + i).all())
