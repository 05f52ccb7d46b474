"""The port's card-resident train split (data/device_resident.py, the
gather in train.py's step, the prefetcher's pass-through) against the JAX
package's `device_resident_iter` and `_use_device_resident`, and against
the port's own streaming loader, on the CPU.

The split: `build_procedural_split` at 2 views, 32x32, 12 shapes, seed 3
(10 classes), as `tests/test_device_resident.py` builds it.  Everything
here is exact: the same indices, the same bytes, and train() runs whose
parameters and metrics are equal bit for bit (the gather hands the step
the bytes the stream would have copied).
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.data import device_resident as jax_dr  # noqa: E402
from gvcnn_tf_tpu.data.procedural import (  # noqa: E402
    build_procedural_split as jax_split,
)
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.checkpoint import Checkpointer  # noqa: E402
from gvcnn_tf_tpu_torch.data import (  # noqa: E402
    DevicePrefetcher,
    ProceduralStream,
    make_dataset,
)
from gvcnn_tf_tpu_torch.data import device_resident as port_dr  # noqa: E402
from gvcnn_tf_tpu_torch.data.procedural import (  # noqa: E402
    build_procedural_split,
)
from gvcnn_tf_tpu_torch.parallel import World  # noqa: E402

jax_pipeline = importlib.import_module("gvcnn_tf_tpu.data.pipeline")
port_pipeline = importlib.import_module("gvcnn_tf_tpu_torch.data.pipeline")
port_train = importlib.import_module("gvcnn_tf_tpu_torch.train")

SPLIT = dict(num_views=2, height=32, width=32, num_shapes=12, seed=3,
             num_classes=10)


def _split(train=True):
    return build_procedural_split(train_split=train, hard=False, **SPLIT)


def _resident(views, labels, **kw):
    return port_dr.device_resident_iter(views, labels, device="cpu", **kw)


# ------------------------------------------------------------ the iterator

@pytest.mark.parametrize("shard_index,num_shards", [(0, 1), (0, 2), (1, 2)])
def test_order_and_bytes_match_jax_and_the_stream(shard_index, num_shards):
    views, labels = _split()
    jviews, jlabels = jax_split(train_split=True, hard=False, **SPLIT)
    assert jviews.tobytes() == views.tobytes()
    shards = dict(shard_index=shard_index, num_shards=num_shards)
    kw = dict(batch_size=2, seed=SPLIT["seed"], train=True, num_epochs=2,
              **shards)
    want = jax_dr.device_resident_iter(jviews, jlabels, **kw)
    got = _resident(views, labels, **kw)
    stream = ProceduralStream(raw_uint8=True, **SPLIT, **{
        k: v for k, v in kw.items() if k != "seed"})
    n = 0
    for w, g, s in zip(want, got, stream, strict=True):
        np.testing.assert_array_equal(g["idx"], w["idx"])
        assert g["idx"].dtype == np.int32
        gathered = g["views"].index_select(0, torch.from_numpy(g["idx"]))
        assert gathered.numpy().tobytes() == s["views"].tobytes()
        assert gathered.numpy().tobytes() == np.asarray(
            w["views"])[w["idx"]].tobytes()
        np.testing.assert_array_equal(g["label"][g["idx"]].numpy(),
                                      s["label"])
        n += 1
    # Train drops each epoch's ragged tail.
    assert n == 2 * (len(range(shard_index, 12, num_shards)) // 2)


def test_eval_split_yields_its_tail_short():
    views, labels = _split(train=False)
    kw = dict(batch_size=5, seed=0, train=False, num_epochs=1)
    got = [b["idx"] for b in _resident(views, labels, **kw)]
    want = [b["idx"] for b in jax_dr.device_resident_iter(
        views, labels, **kw)]
    assert [len(i) for i in got] == [5, 5, 2]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape,chunks", [((64, 64), 5), ((16, 64), 1),
                                          ((3, 1000), 3)])
def test_stage_on_device_in_chunks(monkeypatch, shape, chunks):
    monkeypatch.setattr(port_dr, "_STAGE_CHUNK_BYTES", 1024)
    monkeypatch.setattr(jax_dr, "_STAGE_CHUNK_BYTES", 1024)
    arr = (np.arange(np.prod(shape)) % 251).astype(np.uint8).reshape(shape)
    cuts = port_dr._row_chunks(arr)
    assert len(cuts) == chunks
    # The JAX package's cut: nbytes // chunk + 1 parts by np.array_split.
    if arr.nbytes > 1024:
        parts = np.array_split(arr, arr.nbytes // 1024 + 1, axis=0)
        assert [hi - lo for lo, hi in cuts] == [len(p) for p in parts
                                                 if len(p)]
    out = port_dr.stage_on_device(arr, "cpu")
    assert out.dtype == torch.uint8 and out.numpy().tobytes() == arr.tobytes()
    np.testing.assert_array_equal(np.asarray(jax_dr.stage_on_device(arr)),
                                  out.numpy())


def test_state_dicts_share_one_format():
    views, labels = _split()
    kw = dict(batch_size=4, seed=3, train=True)
    stream = ProceduralStream(raw_uint8=True, **SPLIT, batch_size=4,
                              train=True)
    resident = _resident(views, labels, **kw)
    for _ in range(4):                  # into the second epoch
        next(stream), next(resident)
    a, b = stream.state_dict(), resident.state_dict()
    assert a.keys() == b.keys() and a["rng"].keys() == b["rng"].keys()
    assert (a["epoch"], a["start"]) == (b["epoch"], b["start"]) == (1, 4)
    assert torch.equal(a["order"], b["order"])
    assert torch.equal(a["rng"]["keys"], b["rng"]["keys"])
    # Each loads the other's and continues with the same batches.
    fresh_stream = ProceduralStream(raw_uint8=True, **SPLIT, batch_size=4,
                                    train=True)
    fresh_resident = _resident(views, labels, **kw)
    fresh_stream.load_state_dict(b)
    fresh_resident.load_state_dict(a)
    for _ in range(4):
        s, r = next(fresh_stream), next(fresh_resident)
        assert s["views"].tobytes() == views[r["idx"]].tobytes()


def test_prefetcher_passes_the_staged_split_by_reference():
    views, labels = _split()
    it = _resident(views, labels, batch_size=4, seed=3, train=True,
                   num_epochs=1)
    with DevicePrefetcher(it, torch.device("cpu"), "bfloat16") as pf:
        got = list(pf)
        state = pf.data_state
    assert len(got) == 3
    for b in got:
        assert b["views"].data_ptr() == it.views.data_ptr()
        assert b["label"].data_ptr() == it.labels.data_ptr()
        assert b["views"].dtype == torch.uint8
        assert b["idx"].dtype == torch.int64 and b["idx"].shape == (4,)
    assert (state["epoch"], state["start"]) == (0, 12)
    assert sorted(torch.cat([b["idx"] for b in got]).tolist()) == list(
        range(12))


# ---------------------------------------------------------------- the gate

def _data_cfg(mod, **kw):
    return dataclasses.replace(mod.DataConfig(), **{
        "dataset": "procedural", "num_views": 12, "height": 224,
        "width": 224, **kw})


@pytest.mark.parametrize("num_shapes", [128, 3000])    # 231 MB; 5.4 GB
@pytest.mark.parametrize("wire", ["uint8", "float32"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_gate_agrees_with_jax(monkeypatch, mode, train, wire, num_shapes):
    monkeypatch.setattr(jax, "process_count", lambda: 1)
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    kw = dict(device_resident=mode, transfer_dtype=wire,
              synthetic_num_shapes=num_shapes)
    want = jax_pipeline._use_device_resident(_data_cfg(jax_configs, **kw),
                                             train)
    assert port_pipeline._use_device_resident(
        _data_cfg(port_configs, **kw), train, 1) == want


def test_gate_refuses_on_over_several_ranks_as_jax_does(monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    kw = dict(device_resident="on", transfer_dtype="uint8")
    with pytest.raises(ValueError, match="single-process"):
        jax_pipeline._use_device_resident(_data_cfg(jax_configs, **kw), True)
    with pytest.raises(ValueError, match="single-process"):
        port_pipeline._use_device_resident(_data_cfg(port_configs, **kw),
                                           True, 2)
    # auto over 2 ranks streams in both.
    kw["device_resident"] = "auto"
    assert not jax_pipeline._use_device_resident(
        _data_cfg(jax_configs, **kw), True)
    assert not port_pipeline._use_device_resident(
        _data_cfg(port_configs, **kw), True, 2)


@pytest.mark.parametrize("size,bn_sync,want", [
    (1, "global", "on"), (2, "global", "off"), (1, "local", "off"),
    (2, "local", "off")])
def test_train_turns_it_off_over_ranks_and_local_bn(size, bn_sync, want):
    cfg = port_configs.get_config("mn40_12view").replace(bn_sync=bn_sync)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               device_resident="on"))
    d = port_train._rank_data_config(cfg, World(size=size))
    assert d.device_resident == want
    assert d.batch_size == cfg.data.batch_size // size


def test_make_dataset_stages_only_when_given_a_device():
    d = _data_cfg(port_configs, num_views=2, height=32, width=32,
                  batch_size=4, num_classes=10, synthetic_num_shapes=12,
                  transfer_dtype="uint8")
    assert isinstance(make_dataset(d, train=True), ProceduralStream)
    assert isinstance(make_dataset(d, train=False, device="cpu"),
                      ProceduralStream)
    it = make_dataset(d, train=True, device="cpu")
    assert isinstance(it, port_dr.DeviceResidentIter)
    assert it.staged_bytes == 12 * 2 * 32 * 32 * 3 + 12 * 8


# ------------------------------------------------------- train() and resume

def _cfg(logdir, mode, **train_kw):
    cfg = port_configs.get_config("mn40_12view")
    return cfg.replace(
        compute_dtype="float32", dropout_keep_prob=0.8,
        raw_endpoint="Conv2d_2c_3x3", final_endpoint="Mixed_3b",
        data=dataclasses.replace(
            cfg.data, dataset="procedural", num_classes=10, num_views=2,
            height=32, width=32, batch_size=4, synthetic_num_shapes=12,
            transfer_dtype="uint8", device_resident=mode),
        train=dataclasses.replace(
            cfg.train, train_logdir=str(logdir), log_every=1,
            checkpoint_every=2, optimizer="adam", learning_rate=1e-3,
            seed=3, **train_kw))


def _spy(monkeypatch):
    """The types of the iterators train() builds, in order."""
    seen, real = [], port_train.make_dataset

    def spy(*a, **kw):
        it = real(*a, **kw)
        seen.append(type(it).__name__)
        return it

    monkeypatch.setattr(port_train, "make_dataset", spy)
    return seen


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        torch.testing.assert_close(sb[k], sa[k], rtol=0, atol=0, msg=k)
    for k in ("mu", "nu"):
        for x, y in zip(a.optimizer.slots[k], b.optimizer.slots[k]):
            torch.testing.assert_close(y, x, rtol=0, atol=0)


def test_resident_train_equals_streaming_bit_for_bit(tmp_path, monkeypatch):
    seen = _spy(monkeypatch)
    runs = {mode: port_train.train(_cfg(tmp_path / mode, mode), num_steps=3,
                                   device="cpu") for mode in ("off", "on")}
    assert seen == ["ProceduralStream", "DeviceResidentIter"]
    (a, mets_a), (b, mets_b) = runs["off"], runs["on"]
    assert mets_a == mets_b and np.isfinite(mets_a["loss"])
    assert a.step == b.step == 3
    _assert_same_state(a, b)


@pytest.mark.parametrize("first,then", [("off", "on"), ("on", "on"),
                                        ("on", "off")])
def test_resume_across_transports_equals_an_uninterrupted_run(
        tmp_path, monkeypatch, first, then):
    # 12 shapes at B = 4: 3 steps an epoch, so 5 steps cross into the
    # second epoch's permutation.
    whole, _ = port_train.train(_cfg(tmp_path / "whole", "off"),
                                num_steps=5, device="cpu")
    seen = _spy(monkeypatch)
    port_train.train(_cfg(tmp_path / "run", first), num_steps=2,
                     device="cpu")
    resumed, _ = port_train.train(_cfg(tmp_path / "run", then), num_steps=5,
                                  device="cpu")
    kinds = {"off": "ProceduralStream", "on": "DeviceResidentIter"}
    assert seen == [kinds[first], kinds[then]]
    assert resumed.step == 5
    assert Checkpointer(str(tmp_path / "run")).steps() == [2, 4, 5]
    _assert_same_state(whole, resumed)


def test_cli_device_resident_on_stages(tmp_path, capsys):
    port_train.main([
        "--config", "mn40_12view", "--device", "cpu", "--num_views", "2",
        "--height", "32", "--width", "32", "--batch_size", "4",
        "--dataset", "procedural", "--device_resident", "on",
        "--how_many_training_steps", "2",
        "--train_logdir", str(tmp_path / "cli")])
    err = capsys.readouterr().err
    assert "device_resident: staged the train split on cpu" in err
    assert Checkpointer(str(tmp_path / "cli")).latest_step() == 2
