"""The port's input pipeline and metrics against the JAX package's copies:
the synthetic stream byte for byte, its saved position, the loader
dispatch and its refusals, the host-to-device prefetcher on the CPU, the
transfer-dtype rule and the metric writer."""

import dataclasses
import importlib
import io
import json
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu import metrics as jax_metrics  # noqa: E402
from gvcnn_tf_tpu.data.synthetic import (  # noqa: E402
    synthetic_dataset as jax_synthetic,
)
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch import metrics as port_metrics  # noqa: E402
from gvcnn_tf_tpu_torch.data import (  # noqa: E402
    DevicePrefetcher,
    SyntheticStream,
    make_dataset,
    synthetic_dataset,
)

jax_pipeline = importlib.import_module("gvcnn_tf_tpu.data.pipeline")


@pytest.mark.parametrize("kw", [
    dict(num_classes=5, num_views=3, height=12, width=20, batch_size=4,
         num_shapes=10, seed=3, num_epochs=3),
    dict(num_classes=40, num_views=12, height=17, width=9, batch_size=3,
         num_shapes=11, seed=0, train=False, num_epochs=2),
    dict(num_classes=4, num_views=2, height=8, width=8, batch_size=2,
         num_shapes=9, seed=1, num_epochs=2, shard_index=1, num_shards=2,
         noise=0.2),
])
def test_synthetic_stream_is_byte_identical_to_jax(kw):
    want = list(jax_synthetic(**kw))
    got = list(synthetic_dataset(**kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b) == {"views", "label"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()


def test_synthetic_stream_resumes_from_its_state():
    kw = dict(num_classes=5, num_views=2, height=8, width=8, batch_size=2,
              num_shapes=5, seed=4)
    whole = SyntheticStream(**kw)
    ref = [next(whole) for _ in range(7)]
    part = SyntheticStream(**kw)
    for _ in range(3):
        next(part)
    # Through the same serialisation a checkpoint uses.
    buf = io.BytesIO()
    torch.save(part.state_dict(), buf)
    buf.seek(0)
    resumed = SyntheticStream(**kw)
    resumed.load_state_dict(torch.load(buf, weights_only=True))
    for want in ref[3:]:
        got = next(resumed)
        assert got["views"].tobytes() == want["views"].tobytes()
        assert got["label"].tobytes() == want["label"].tobytes()


def test_make_dataset_matches_jax_for_the_synthetic_loader():
    cfg = dataclasses.replace(port_configs.DataConfig(), height=8, width=8,
                              num_views=2, batch_size=2)
    jcfg = dataclasses.replace(jax_configs.DataConfig(), height=8, width=8,
                               num_views=2, batch_size=2)
    got = make_dataset(cfg, train=True, seed=5)
    want = jax_pipeline.make_dataset(jcfg, train=True, seed=5)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a["views"].tobytes() == b["views"].tobytes()


@pytest.mark.parametrize("change,match", [
    (dict(loader="native"), "item 7"),
    (dict(dataset_dir="/nonexistent"), "item 7"),
    (dict(loader="decoded"), "item 7"),
    (dict(device_resident="on"), "item 15"),
])
def test_make_dataset_refuses_what_is_not_ported(change, match):
    cfg = dataclasses.replace(port_configs.DataConfig(), **change)
    with pytest.raises(NotImplementedError, match=match):
        make_dataset(cfg, train=True)


def test_make_dataset_refuses_a_uint8_wire_for_float_views():
    cfg = dataclasses.replace(port_configs.DataConfig(),
                              transfer_dtype="uint8")
    with pytest.raises(ValueError, match="uint8"):
        make_dataset(cfg, train=True)


@pytest.mark.parametrize("name", sorted(jax_configs.CONFIGS))
@pytest.mark.parametrize("td", ["auto", "float32", "bfloat16", "uint8"])
def test_resolve_transfer_dtype_equals_jax(name, td):
    def resolve(mod):
        cfg = mod.get_config(name)
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   transfer_dtype=td))
        return mod.resolve_transfer_dtype(cfg)

    assert resolve(port_configs) == resolve(jax_configs)


def _batches(n, fail_at=None):
    rs = np.random.RandomState(0)
    for i in range(n):
        if i == fail_at:
            raise OSError("disk gone")
        yield {"views": rs.uniform(-1, 1, (2, 3, 4, 4, 3)).astype(np.float32),
               "label": np.arange(2, dtype=np.int32) + i}


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_prefetcher_on_the_cpu(wire):
    ref = list(_batches(4))
    with DevicePrefetcher(_batches(4), torch.device("cpu"), wire) as it:
        got = list(it)
    assert len(got) == 4
    for a, b in zip(got, ref):
        assert a["label"].dtype == torch.int64
        assert a["label"].tolist() == b["label"].tolist()
        want = torch.from_numpy(b["views"])
        if wire:
            assert a["views"].dtype == torch.bfloat16
            want = want.to(torch.bfloat16)   # round to nearest even
        torch.testing.assert_close(a["views"], want, rtol=0, atol=0)


def test_prefetcher_hands_out_the_loader_state_of_each_batch():
    stream = SyntheticStream(num_classes=3, num_views=1, height=8, width=8,
                             batch_size=1, num_shapes=4, seed=0)
    with DevicePrefetcher(stream, torch.device("cpu")) as it:
        next(it)
        next(it)
        state = it.data_state
    resumed = SyntheticStream(num_classes=3, num_views=1, height=8, width=8,
                              batch_size=1, num_shapes=4, seed=0)
    resumed.load_state_dict(state)
    fresh = SyntheticStream(num_classes=3, num_views=1, height=8, width=8,
                            batch_size=1, num_shapes=4, seed=0)
    for _ in range(2):
        next(fresh)
    assert next(resumed)["views"].tobytes() == next(fresh)["views"].tobytes()


def test_prefetcher_raises_the_loaders_error_and_stops():
    it = DevicePrefetcher(_batches(5, fail_at=2), torch.device("cpu"))
    assert len([next(it), next(it)]) == 2
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    it.close()
    endless = DevicePrefetcher(_batches(10 ** 9), torch.device("cpu"),
                               depth=1)
    next(endless)
    endless.close()
    assert not endless._thread.is_alive()
    assert threading.active_count() < 50


def test_metric_writer_prints_what_the_jax_writer_prints(tmp_path):
    vals = {"loss": np.float32(1.5), "accuracy": 0.25, "lr": 0.01}
    outs = []
    for writer in (jax_metrics.MetricWriter(None),
                   port_metrics.MetricWriter(str(tmp_path))):
        buf = io.StringIO()
        with redirect_stdout(buf):
            writer.scalars(7, vals)
        writer.flush()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    line = (tmp_path / "metrics.jsonl").read_text()
    assert json.loads(line) == {"step": 7, "loss": 1.5, "accuracy": 0.25,
                                "lr": 0.01}


def test_step_timer_counts_steps():
    t = port_metrics.StepTimer()
    t.tick(3)
    assert t.rate() > 0
    t.reset()
    assert t.rate() == 0.0
