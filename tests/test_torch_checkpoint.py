"""The port's Orbax reader (`checkpoint.read_orbax`) and its users against
the JAX package's own checkpoints, on the CPU.

The JAX `Checkpointer` saves a `TrainState` (momentum or Adam) of
mn40_12view cut to Mixed_3b (10 classes, 32x32, 2 views, fp32) at step 1
(the JAX init) and step 2 (the same weights with random BN biases and BN
statistics calibrated on the procedural val split, as
`tests/test_torch_eval.py` does); the same states also go to a raw
`StandardCheckpointer` directory and to `CheckpointManager`s without OCDBT
and with zarr3.  `read_orbax` returns each saved params and batch_stats
bit for bit and opens no `opt_state` array.  On the calibrated step:
`evaluate` gives the JAX package's counts and per-class accuracy (unfolded
and folded; every top-2 logit margin is above 1e-3 of max|logit|), and the
engine and the HTTP server answer within 1e-5 of max of the JAX forward
(both fold BN).
"""

import dataclasses
import importlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
ts = pytest.importorskip("tensorstore")

import orbax.checkpoint as ocp  # noqa: E402

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from gvcnn_tf_tpu.eval import evaluate as jax_evaluate  # noqa: E402
from gvcnn_tf_tpu.models.gvcnn import build_model as jax_build_model  # noqa: E402
from gvcnn_tf_tpu.serve import InferenceEngine as JaxInferenceEngine  # noqa: E402
from gvcnn_tf_tpu.utils.fold_bn import (  # noqa: E402
    fold_batch_norm as jax_fold_batch_norm,
)
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch import eval as port_eval  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import (  # noqa: E402
    jax_to_state_dict,
    state_dict_to_jax,
)
from gvcnn_tf_tpu_torch.checkpoint import (  # noqa: E402
    load_model,
    model_state,
    read_orbax,
)
from gvcnn_tf_tpu_torch.data import make_dataset  # noqa: E402
from gvcnn_tf_tpu_torch.models.gvcnn import build_model  # noqa: E402
from gvcnn_tf_tpu_torch.serve import InferenceEngine, serve  # noqa: E402
from test_torch_eval import N_SHAPES, H, V, _config  # noqa: E402
from test_torch_gvcnn import _calibrate_bn  # noqa: E402
from test_torch_serve import _npz, _post  # noqa: E402

jax_train = importlib.import_module("gvcnn_tf_tpu.train")

OPTIMIZERS = ("momentum", "adam")
LAYOUTS = ("newest", "earlier", "raw", "no_ocdbt", "zarr3")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _calibrated(jcfg, pcfg, init_vars):
    """The JAX init with random BN biases and calibrated BN statistics."""
    model = build_model(pcfg).eval()
    model.load_state_dict(jax_to_state_dict(init_vars))
    batch = next(make_dataset(dataclasses.replace(
        pcfg.data, batch_size=N_SHAPES), train=False, num_epochs=1))
    x = torch.from_numpy(batch["views"])
    _calibrate_bn(model, x, np.random.RandomState(3))
    with torch.no_grad():
        logits = model(x)[0].numpy()
    top2 = np.sort(logits, -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3 * np.abs(logits).max()
    return state_dict_to_jax(model.state_dict())


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{optimizer: {layout: directory}}, the two saved variable trees and
    the configs."""
    root = tmp_path_factory.mktemp("orbax")
    pcfg = _config(port_configs)
    out = {}
    for opt in OPTIMIZERS:
        jcfg = _config(jax_configs)
        jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train,
                                                      optimizer=opt))
        _, tx, state = jax_train.create_train_state(
            jcfg, jax.random.key(0), (1, V, H, H, 3))
        state = jax.device_get(state)
        init = {"params": state.params, "batch_stats": state.batch_stats}
        if opt == OPTIMIZERS[0]:
            trees = {1: init, 2: _calibrated(jcfg, pcfg, init)}
        states = {s: state.replace(step=np.int32(s), opt_state=tx.init(
            t["params"]), **t) for s, t in trees.items()}
        dirs = {"newest": str(root / opt / "manager")}
        ckpt = JaxCheckpointer(dirs["newest"])
        for s in (1, 2):
            ckpt.save(s, states[s])
        ckpt.close()
        dirs["raw"] = str(root / opt / "raw")
        with ocp.StandardCheckpointer() as raw:
            raw.save(dirs["raw"], states[1])
        for layout, kw in (("no_ocdbt", dict(use_ocdbt=False)),
                           ("zarr3", dict(use_zarr3=True))):
            dirs[layout] = str(root / opt / layout)
            mgr = ocp.CheckpointManager(
                dirs[layout], options=ocp.CheckpointManagerOptions(
                    create=True),
                item_handlers=ocp.PyTreeCheckpointHandler(**kw))
            mgr.save(1, args=ocp.args.PyTreeSave(states[1]))
            mgr.wait_until_finished()
            mgr.close()
        out[opt] = dirs
    return dict(dirs=out, trees=trees, jcfg=_config(jax_configs), pcfg=pcfg)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_read_orbax_is_bit_exact(saved, monkeypatch, opt, layout):
    """params and batch_stats as saved, bit for bit, whatever optimizer
    wrote the state; no `opt_state` (nor `step`) array is opened."""
    opened = []
    real_open = ts.open

    def spy(spec, *args, **kw):
        opened.append(spec["kvstore"]["path"])
        return real_open(spec, *args, **kw)

    monkeypatch.setattr(ts, "open", spy)
    directory = saved["dirs"][opt]["newest" if layout == "earlier"
                                   else layout]
    got = read_orbax(directory, step=1 if layout == "earlier" else None)
    want = saved["trees"][2 if layout == "newest" else 1]
    assert set(got) == {"params", "batch_stats"}
    want_flat, got_flat = dict(_flat(want)), dict(_flat(got))
    assert set(got_flat) == set(want_flat)
    for k, a in want_flat.items():
        assert got_flat[k].dtype == a.dtype and got_flat[k].shape == a.shape
        np.testing.assert_array_equal(got_flat[k], a, err_msg=str(k))
    assert opened and all(p.split("/")[-1].startswith(
        ("params.", "batch_stats.")) for p in opened)
    assert len(opened) == len(want_flat)


def test_read_orbax_skips_excluded_scopes(saved):
    got = read_orbax(saved["dirs"]["momentum"]["newest"], items=("params",),
                     exclude_scopes=("Logits", "Grouping"))
    assert set(got) == {"params"}
    assert set(got["params"]) == {"InceptionV1"}


@pytest.mark.parametrize("fold_bn", [False, True])
def test_evaluate_a_jax_checkpoint_equals_jax(saved, fold_bn):
    directory = saved["dirs"]["adam"]["newest"]
    want = jax_evaluate(saved["jcfg"], directory, per_class=True,
                        fold_bn=fold_bn)
    got = port_eval.evaluate(saved["pcfg"], directory, per_class=True,
                             fold_bn=fold_bn, device="cpu")
    assert got["count"] == want["count"] == N_SHAPES
    assert got == want


def _jax_folded_logits(saved, views):
    jmodel = jax_build_model(saved["jcfg"])
    folded = jax_fold_batch_norm(saved["trees"][2])
    logits, ep = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        folded, views)
    return np.asarray(logits), np.asarray(ep["view_discrimination_scores"])


def test_engine_serves_a_jax_checkpoint(saved):
    """`InferenceEngine(config, checkpoint_dir=<JAX dir>)`: logits within
    1e-5 of max|logit| of the JAX forward on the same (folded) weights."""
    views = np.random.RandomState(5).uniform(
        -1, 1, (2, V, H, H, 3)).astype(np.float32)
    engine = InferenceEngine(saved["pcfg"], saved["dirs"]["momentum"][
        "newest"], serve_batch_size=2, device="cpu")
    try:
        logits, scores = engine.logits_and_scores(views)
    finally:
        engine.close()
    want, want_scores = _jax_folded_logits(saved, views)
    scale = np.abs(want).max()
    assert np.abs(logits - want).max() <= 1e-5 * scale
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-6)


def test_server_answers_from_a_jax_checkpoint(saved):
    """`serve --checkpoint_dir <JAX dir>`: an HTTP request gets the JAX
    engine's class, probability and view scores (within 1e-5)."""
    directory = saved["dirs"]["momentum"]["newest"]
    views = np.random.RandomState(6).uniform(
        -1, 1, (2, V, H, H, 3)).astype(np.float32)
    httpd, thread, engine = serve(saved["pcfg"], directory, port=0,
                                  serve_batch_size=2, block=False,
                                  device="cpu")
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/predict"
        status, got = _post(url, _npz(views=views))
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
        thread.join(timeout=30)
    assert status == 200 and not thread.is_alive()
    want = JaxInferenceEngine(saved["jcfg"], directory,
                              serve_batch_size=2).predict(views)
    for g, w in zip(got, want):
        assert g["class_index"] == w["class_index"]
        np.testing.assert_allclose(g["probability"], w["probability"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["view_scores"], w["view_scores"],
                                   rtol=0, atol=1e-5)


def test_read_orbax_refuses_what_it_cannot_read(saved, tmp_path):
    (tmp_path / "3" / "default").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="no Orbax _METADATA"):
        read_orbax(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no step 7"):
        read_orbax(saved["dirs"]["momentum"]["newest"], step=7)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        read_orbax(str(tmp_path / "3" / "default"))
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        read_orbax(str(tmp_path / "missing"))


def test_read_orbax_refuses_a_missing_collection(tmp_path):
    with ocp.StandardCheckpointer() as raw:
        raw.save(str(tmp_path / "p"), {"params": {
            "Logits": {"kernel": np.ones((3, 2), np.float32)}}})
    with pytest.raises(FileNotFoundError, match="has no batch_stats"):
        read_orbax(str(tmp_path / "p"))
    got = read_orbax(str(tmp_path / "p"), items=("params",))
    np.testing.assert_array_equal(got["params"]["Logits"]["kernel"],
                                  np.ones((3, 2), np.float32))


def test_read_orbax_without_tensorstore_names_it(saved, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="`tensorstore` package"):
        read_orbax(saved["dirs"]["momentum"]["newest"])


@pytest.mark.parametrize("change,match", [
    (dict(num_classes=40), "size mismatch for Logits.weight"),
    (dict(name="mn40_12view_mvcnn"), "Unexpected key.*GroupingModule"),
])
def test_load_model_holds_a_jax_checkpoint_to_its_config(saved, change,
                                                         match):
    """A JAX checkpoint of another model: `load_state_dict(strict=True)`
    raises, naming the key."""
    cfg = saved["pcfg"]
    if "num_classes" in change:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   num_classes=40))
    else:
        mv = port_configs.get_config(change["name"])
        cfg = mv.replace(compute_dtype="float32",
                         raw_endpoint=cfg.raw_endpoint,
                         final_endpoint=cfg.final_endpoint, data=cfg.data)
    directory = saved["dirs"]["momentum"]["newest"]
    assert set(model_state(directory)) == set(
        build_model(saved["pcfg"]).state_dict())
    with pytest.raises(RuntimeError, match=match):
        load_model(cfg, directory, "cpu")
