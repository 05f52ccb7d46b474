"""The port's retrieval tool (tools/retrieval.py) on the CPU.

`retrieval_metrics` is the JAX tool's source line for line and gives its
numbers; `extract_descriptors` against the JAX tool's on the same weights
(initialized by JAX, BN calibrated, carried across) and the same batches of
the procedural validation split (raw uint8 views normalized on the
device): GVCNN and MVCNN cut to Mixed_3b, fp32, 32x32, 2 views, 10 shapes
in batches of 4 (the last holds 2).  Labels equal, descriptors within
1e-5 (unit vectors; fp32 through two frameworks' convolutions).
"""

import argparse
import dataclasses
import inspect
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.models.gvcnn import init_model  # noqa: E402
from gvcnn_tf_tpu.tools import retrieval as jax_retrieval  # noqa: E402
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import (  # noqa: E402
    jax_to_state_dict,
    state_dict_to_jax,
)
from gvcnn_tf_tpu_torch.checkpoint import Checkpointer  # noqa: E402
from gvcnn_tf_tpu_torch.data import make_dataset  # noqa: E402
from gvcnn_tf_tpu_torch.models.gvcnn import build_model  # noqa: E402
from gvcnn_tf_tpu_torch.tools import retrieval  # noqa: E402
from gvcnn_tf_tpu_torch.tools.retrieval import (  # noqa: E402
    extract_descriptors,
    retrieval_metrics,
)
from gvcnn_tf_tpu_torch.train import create_train_state  # noqa: E402
from test_torch_gvcnn import _calibrate_bn  # noqa: E402

N_SHAPES, B, V, H = 10, 4, 2, 32
FAMILIES = {"gvcnn": "mn40_12view", "mvcnn": "mn40_12view_mvcnn"}


def _config(mod, family="gvcnn"):
    cfg = mod.get_config(FAMILIES[family])
    return cfg.replace(
        compute_dtype="float32", raw_endpoint="Conv2d_2c_3x3",
        final_endpoint="Mixed_3b",
        data=dataclasses.replace(
            cfg.data, num_classes=10, height=H, width=H, num_views=V,
            batch_size=B, dataset="procedural", transfer_dtype="uint8",
            synthetic_num_shapes=N_SHAPES))


def test_retrieval_metrics_is_the_jax_tool_s():
    assert inspect.getsource(retrieval.retrieval_metrics) == \
        inspect.getsource(jax_retrieval.retrieval_metrics)


@pytest.mark.parametrize("seed,ks", [(0, (1, 5, 10)), (1, (1, 3)),
                                     (2, (2, 7))])
def test_retrieval_metrics_equal_jax(seed, ks):
    rs = np.random.RandomState(seed)
    descs = rs.randn(30, 16)
    descs /= np.linalg.norm(descs, axis=1, keepdims=True)
    labels = rs.randint(0, 4, 30)
    assert retrieval_metrics(descs, labels, ks=ks) == \
        jax_retrieval.retrieval_metrics(descs, labels, ks=ks)


def test_map_perfect_clusters():
    # Two tight clusters: every query ranks its own class first, mAP 1.
    rng = np.random.RandomState(0)
    a = rng.randn(1, 8) + 10
    b = rng.randn(1, 8) - 10
    descs = np.concatenate([a + 0.01 * rng.randn(5, 8),
                            b + 0.01 * rng.randn(5, 8)])
    descs /= np.linalg.norm(descs, axis=1, keepdims=True)
    labels = np.array([0] * 5 + [1] * 5)
    m = retrieval_metrics(descs, labels)
    assert m["mAP"] == 1.0
    assert m["precision@1"] == 1.0


def test_ap_hand_case():
    # Labels [0, 0, 1]; query 0 ranks item 2 first and item 1 second, so
    # its AP is precision@2 = 1/2; query 1 ranks [2, 0], AP 1/2; query 2
    # has no relevant item and is skipped.
    descs = np.array([[1.0, 0.0], [0.0, 1.0], [0.9, 0.1]])
    descs /= np.linalg.norm(descs, axis=1, keepdims=True)
    m = retrieval_metrics(descs, np.array([0, 0, 1]), ks=(1,))
    assert abs(m["mAP"] - 0.5) < 1e-9
    assert m["precision@1"] == 0.0


@pytest.fixture(scope="module")
def batches():
    return list(make_dataset(_config(port_configs).data, train=False,
                             num_epochs=1))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_extract_descriptors_equals_jax(batches, family):
    jcfg = _config(jax_configs, family)
    _, init_vars = init_model(jcfg, jax.random.key(1), (1, V, H, H, 3))
    model = build_model(_config(port_configs, family)).eval()
    model.load_state_dict(jax_to_state_dict(jax.device_get(init_vars)))
    views = np.concatenate([b["views"] for b in batches])
    _calibrate_bn(model, torch.from_numpy(views).float() / 127.5 - 1.0,
                  np.random.RandomState(1))
    variables = state_dict_to_jax(model.state_dict())
    want, want_labels = jax_retrieval.extract_descriptors(
        jcfg, state=types.SimpleNamespace(**variables),
        dataset_iter=iter(batches))
    got, labels = extract_descriptors(_config(port_configs, family),
                                      state=variables,
                                      dataset_iter=iter(batches),
                                      device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[0] == N_SHAPES
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_extract_descriptors_from_the_split_and_a_train_state():
    """Without a dataset_iter: one pass of the validation split; the
    weights of a `TrainState`, whose model goes back to train mode."""
    cfg = _config(port_configs)
    state = create_train_state(cfg, "cpu")
    descs, labels = extract_descriptors(cfg, state=state, device="cpu")
    assert state.model.training
    assert descs.shape == (N_SHAPES, 256) and labels.shape == (N_SHAPES,)
    np.testing.assert_allclose(np.linalg.norm(descs, axis=1), 1.0,
                               rtol=1e-5)
    want = np.concatenate([b["label"] for b in make_dataset(
        cfg.data, train=False, num_epochs=1)])
    np.testing.assert_array_equal(labels, want)


def test_seeded_weights_without_a_checkpoint():
    """Neither checkpoint nor state: seeded weights (the JAX tool runs its
    init), on the synthetic stream."""
    cfg = port_configs.get_config("mn10_8view").replace(
        compute_dtype="float32", data=dataclasses.replace(
            port_configs.get_config("mn10_8view").data, dataset="synthetic",
            height=H, width=H, num_views=V, batch_size=4,
            synthetic_num_shapes=8))
    descs, labels = extract_descriptors(cfg, device="cpu")
    assert descs.shape == (8, 1024) and labels.shape == (8,)
    np.testing.assert_allclose(np.linalg.norm(descs, axis=1), 1.0,
                               rtol=1e-5)
    again, _ = extract_descriptors(cfg, device="cpu")
    np.testing.assert_array_equal(descs, again)
    assert 0.0 <= retrieval_metrics(descs, labels)["mAP"] <= 1.0


FLAGS = ["--config", "mn40_12view", "--num_views", str(V), "--height",
         str(H), "--width", str(H), "--num_classes", "10", "--dataset",
         "procedural", "--batch_size", str(B)]


def test_cli_on_the_cpu(tmp_path, capsys):
    from gvcnn_tf_tpu_torch.models.gvcnn import init_weights

    cfg = port_configs.config_from_flags(
        port_configs.add_flags(argparse.ArgumentParser()).parse_args(FLAGS))
    Checkpointer(str(tmp_path)).save(1, {
        "step": 1, "model": init_weights(build_model(cfg), 0).state_dict()})
    retrieval.main(FLAGS + ["--checkpoint_dir", str(tmp_path), "--device",
                            "cpu"])
    out = capsys.readouterr().out
    assert "'mAP'" in out and "'precision@10'" in out


def test_cli_refuses_the_card_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="never falls back"):
        retrieval.main(FLAGS + ["--checkpoint_dir", str(tmp_path)])
