"""The port's inference server on the CPU: HTTP round trip, the refusals,
and the engine against the JAX package's engine on the same weights.

mn40_12view narrowed to 32x32, 2 views, compute_dtype float32.
"""

import dataclasses
import io
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.models.gvcnn import init_model  # noqa: E402
from gvcnn_tf_tpu.serve import InferenceEngine as JaxInferenceEngine  # noqa: E402
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch import serve as port_serve  # noqa: E402
from gvcnn_tf_tpu_torch.serve import InferenceEngine, serve  # noqa: E402
from gvcnn_tf_tpu_torch.train import train as port_train  # noqa: E402

V, H = 2, 32


def _config(mod):
    cfg = mod.get_config("mn40_12view")
    return cfg.replace(compute_dtype="float32", data=dataclasses.replace(
        cfg.data, height=H, width=H, num_views=V, batch_size=2))


@pytest.fixture(scope="module")
def server():
    httpd, thread, engine = serve(_config(port_configs), port=0,
                                  serve_batch_size=2, block=False,
                                  device="cpu")
    yield f"http://127.0.0.1:{httpd.server_address[1]}", engine
    httpd.shutdown()
    httpd.server_close()
    engine.close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_healthz_and_info(server):
    base, _ = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert r.read() == b"ok"
    with urllib.request.urlopen(base + "/info", timeout=30) as r:
        info = json.loads(r.read())
    assert info["num_views"] == V and info["num_classes"] == 40
    assert info["input"] == [V, H, H, 3] and info["device"] == "cpu"


def test_predict_chunked_matches_direct_forward(server):
    base, engine = server
    views = np.random.RandomState(0).uniform(-1, 1, (3, V, H, H, 3))
    views = views.astype(np.float32)
    status, results = _post(base + "/predict", _npz(views=views))
    assert status == 200 and len(results) == 3   # chunked: 2 + padded 1
    logits, scores = engine.logits_and_scores(views[:2])
    for r, lg, sc in zip(results, logits, scores):
        assert r["class_index"] == int(np.argmax(lg))
        assert 0 < r["probability"] <= 1
        np.testing.assert_allclose(r["view_scores"], sc, rtol=1e-6)
        assert abs(sum(r["view_scores"]) - 1.0) < 1e-5   # softmax squash


def test_predict_single_shape_4d_and_uint8(server):
    base, _ = server
    raw = np.random.RandomState(1).randint(0, 256, (V, H, H, 3), np.uint8)
    status, r8 = _post(base + "/predict", _npz(views=raw))
    assert status == 200 and len(r8) == 1
    as_float = raw.astype(np.float32) / 255.0 * 2.0 - 1.0
    status, rf = _post(base + "/predict", _npz(views=as_float))
    assert status == 200
    assert r8[0]["class_index"] == rf[0]["class_index"]
    np.testing.assert_allclose(r8[0]["view_scores"], rf[0]["view_scores"],
                               rtol=1e-6)


def test_predict_bad_payloads(server):
    base, _ = server
    status, err = _post(base + "/predict", b"not an npz")
    assert status == 400 and "error" in err
    status, err = _post(base + "/predict", _npz(
        wrong_key=np.zeros((1, V, H, H, 3), np.float32)))
    assert status == 400 and "views" in err["error"]
    status, err = _post(base + "/predict", _npz(
        views=np.zeros((1, V + 1, H, H, 3), np.float32)))
    assert status == 400 and "expected views" in err["error"]


def test_stats_after_requests(server):
    base, _ = server
    _post(base + "/predict", _npz(views=np.zeros((1, V, H, H, 3),
                                                 np.float32)))
    with urllib.request.urlopen(base + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["count"] >= 1 and stats["shapes"] >= 1
    assert 0 < stats["p50_ms"] <= stats["p99_ms"]
    assert stats["serve_batch_size"] == 2


def test_engine_matches_jax_engine():
    """Same numpy weights into both engines (BN folded by both)."""
    jcfg = _config(jax_configs)
    _, variables = init_model(jcfg, jax.random.key(0), (1, V, H, H, 3))
    variables = jax.device_get(variables)
    jax_engine = JaxInferenceEngine(
        jcfg, state=types.SimpleNamespace(**variables), serve_batch_size=2)
    port_engine = InferenceEngine(_config(port_configs), variables=variables,
                                  serve_batch_size=2, device="cpu")
    views = np.random.RandomState(2).uniform(-1, 1, (3, V, H, H, 3))
    views = views.astype(np.float32)
    got_all = port_engine.predict(views)
    port_engine.close()
    for want, got in zip(jax_engine.predict(views), got_all):
        assert got["class_index"] == want["class_index"]
        np.testing.assert_allclose(got["probability"], want["probability"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["view_scores"], want["view_scores"],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", ["mvcnn", "single_view"])
def test_server_matches_jax_engine_for_each_family(family):
    """MVCNN and the single-view classifier served over HTTP: the JAX
    engine's records on the same (calibrated) weights, with no view scores
    in either."""
    from test_torch_eval import _family_config, family_variables

    jcfg, pcfg = (_family_config(m, family) for m in (jax_configs,
                                                       port_configs))
    d = pcfg.data
    views = np.random.RandomState(4).uniform(
        -1, 1, (3, d.num_views, d.height, d.width, 3)).astype(np.float32)
    variables = family_variables(family, views)
    jax_engine = JaxInferenceEngine(
        jcfg, state=types.SimpleNamespace(**variables), serve_batch_size=2)
    httpd, thread, engine = serve(pcfg, variables=variables, port=0,
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
    assert status == 200
    want = jax_engine.predict(views)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"class_index", "probability"}
        assert g["class_index"] == w["class_index"]
        np.testing.assert_allclose(g["probability"], w["probability"],
                                   rtol=1e-4)


def test_cuda_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back"):
        InferenceEngine(_config(port_configs), device="cuda")
    with pytest.raises(SystemExit, match="never falls back"):
        port_serve.main(["--height", "32", "--width", "32", "--num_views",
                         "2", "--port", "0"])


def test_engine_serves_a_train_checkpoint(tmp_path):
    """The engine loaded from a `train()` checkpoint answers with the logits
    of that checkpoint's model (BN folded by the engine: rtol 1e-4)."""
    cfg = _config(port_configs)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, train_logdir=str(tmp_path), checkpoint_every=2))
    state, _ = port_train(cfg, num_steps=2, device="cpu")
    engine = InferenceEngine(cfg, str(tmp_path), serve_batch_size=2,
                             device="cpu")
    views = np.random.RandomState(4).uniform(-1, 1, (2, V, H, H, 3))
    views = views.astype(np.float32)
    try:
        logits, scores = engine.logits_and_scores(views)
    finally:
        engine.close()
    with torch.no_grad():
        want, ep = state.model.eval()(torch.from_numpy(views))
    scale = float(want.abs().max())
    np.testing.assert_allclose(logits, want.numpy(), rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(scores, ep["view_discrimination_scores"],
                               rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="not both"):
        InferenceEngine(cfg, str(tmp_path), variables={}, device="cpu")


def test_checkpoint_dir_is_refused(tmp_path):
    """A directory of Orbax step directories without Orbax's `_METADATA`
    (not a finished Orbax checkpoint) is refused, saying so; so is a
    missing one."""
    (tmp_path / "12" / "default").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="no Orbax _METADATA"):
        InferenceEngine(_config(port_configs), str(tmp_path), device="cpu")
    with pytest.raises(SystemExit, match="no Orbax _METADATA"):
        port_serve.main(["--checkpoint_dir", str(tmp_path),
                         "--device", "cpu", "--port", "0"])
    with pytest.raises(SystemExit, match="no checkpoint directory"):
        port_serve.main(["--checkpoint_dir", str(tmp_path / "missing"),
                         "--device", "cpu", "--port", "0"])
