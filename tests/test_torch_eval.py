"""The port's evaluation (eval.py, checkpoint.load_model) and the training
loop's `--eval_every` against the JAX package and against themselves, on
the CPU.

The model: mn40_12view with 10 classes (the procedural split's small
table), cut to Mixed_3b (scoring FCN on Conv2d_2c_3x3), fp32, 32x32, 2
views, B = 4; the split: 10 procedural validation shapes, so the last batch
holds 2 and is padded.  Weights come from the JAX init through the bridge,
with random BN biases and BN statistics calibrated on the split (as
`tests/test_torch_gvcnn.py` does), so every BN does work and the logits
stay O(1).  The counts are compared for equality: near-ties could flip an
argmax under fp32 rounding, so the fixture asserts that every shape's top-2
logit margin is above 1e-3 of max|logit|, 10x the 1e-4 relative gap the
GVCNN parity tests allow between the packages.

`--eval_every`: 4 train steps (dropout on, the uint8 wire) with an eval
every 2 leave the loss, every parameter, every BN statistic and the
optimizer's state bit for bit as a run without, the model in train mode,
and record at steps 2 and 4 what `evaluate` of that step's checkpoint gives.
"""

import dataclasses
import json
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.eval import evaluate as jax_evaluate  # noqa: E402
from gvcnn_tf_tpu.models.gvcnn import init_model  # noqa: E402
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch import eval as port_eval  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import (  # noqa: E402
    jax_to_state_dict,
    state_dict_to_jax,
)
from gvcnn_tf_tpu_torch.checkpoint import (  # noqa: E402
    Checkpointer,
    load_model,
    model_state,
)
from gvcnn_tf_tpu_torch.data import make_dataset  # noqa: E402
from gvcnn_tf_tpu_torch.models.gvcnn import (  # noqa: E402
    build_model,
    init_weights,
)
from gvcnn_tf_tpu_torch.train import train as port_train  # noqa: E402
from test_torch_gvcnn import _calibrate_bn  # noqa: E402

N_SHAPES, B, V, H = 10, 4, 2, 32


def _config(mod, **data_kw):
    cfg = mod.get_config("mn40_12view")
    return cfg.replace(
        compute_dtype="float32", raw_endpoint="Conv2d_2c_3x3",
        final_endpoint="Mixed_3b",
        data=dataclasses.replace(
            cfg.data, num_classes=10, height=H, width=H, num_views=V,
            batch_size=B, dataset="procedural",
            synthetic_num_shapes=N_SHAPES, **data_kw))


@pytest.fixture(scope="module")
def shared():
    """JAX variables with calibrated BN and the JAX package's results."""
    jcfg, pcfg = _config(jax_configs), _config(port_configs)
    _, init_vars = init_model(jcfg, jax.random.key(0), (1, V, H, H, 3))
    model = build_model(pcfg).eval()
    model.load_state_dict(jax_to_state_dict(jax.device_get(init_vars)))
    batch = next(make_dataset(dataclasses.replace(
        pcfg.data, batch_size=N_SHAPES), train=False, num_epochs=1))
    x = torch.from_numpy(batch["views"])
    _calibrate_bn(model, x, np.random.RandomState(0))
    with torch.no_grad():
        logits = model(x)[0].numpy()
    top2 = np.sort(logits, -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3 * np.abs(logits).max()
    variables = state_dict_to_jax(model.state_dict())
    ns = types.SimpleNamespace(**variables)
    want = {fold: jax_evaluate(jcfg, state=ns, per_class=True, fold_bn=fold)
            for fold in (False, True)}
    return variables, want


@pytest.mark.parametrize("fold_bn", [False, True])
def test_evaluate_equals_jax(shared, fold_bn):
    variables, want = shared
    got = port_eval.evaluate(_config(port_configs), state=variables,
                             per_class=True, fold_bn=fold_bn, device="cpu")
    assert set(got) == {"accuracy", "correct", "count", "per_class_accuracy"}
    assert got["count"] == want[fold_bn]["count"] == N_SHAPES
    assert got["correct"] == want[fold_bn]["correct"]
    assert got["accuracy"] == want[fold_bn]["accuracy"]
    assert got["per_class_accuracy"] == want[fold_bn]["per_class_accuracy"]
    # Folding is exact up to rounding, and no margin is that close.
    assert want[True] == want[False]


def test_prefetch_depth_0_scores_every_shape(shared):
    variables, want = shared
    got = port_eval.evaluate(_config(port_configs, prefetch_to_device=0),
                             state=variables, device="cpu")
    assert (got["count"], got["correct"]) == (N_SHAPES,
                                              want[False]["correct"])


def test_evaluate_takes_a_dataset_iter(shared):
    variables, want = shared
    cfg = _config(port_configs)
    it = make_dataset(cfg.data, train=False, num_epochs=2)
    got = port_eval.evaluate(cfg, dataset_iter=it, state=variables,
                             device="cpu")
    assert (got["count"], got["correct"]) == (2 * N_SHAPES,
                                              2 * want[False]["correct"])


# MVCNN and the single-view classifier, cut as `_config` cuts GVCNN.
FAMILIES = {"mvcnn": ("mn40_12view_mvcnn", V),
            "single_view": ("mn10_single_view", 1)}


def _family_config(mod, family):
    name, views = FAMILIES[family]
    cfg = mod.get_config(name)
    return cfg.replace(
        compute_dtype="float32", raw_endpoint="Conv2d_2c_3x3",
        final_endpoint="Mixed_3b",
        data=dataclasses.replace(
            cfg.data, num_classes=10, height=H, width=H, num_views=views,
            batch_size=B, dataset="procedural",
            synthetic_num_shapes=N_SHAPES))


def family_variables(family, x):
    """Calibrated weights of `family` on views x (N, V, H, W, 3), as JAX
    variables, after asserting every top-2 logit margin is clear.  The
    weights are seeded (`init_weights`), never drawn from torch's global
    generator, whose state depends on the tests run before in the
    process."""
    model = init_weights(build_model(_family_config(port_configs, family)),
                         1).eval()
    _calibrate_bn(model, torch.from_numpy(x), np.random.RandomState(1))
    with torch.no_grad():
        logits = model(torch.from_numpy(x))[0].numpy()
    top2 = np.sort(logits, -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3 * np.abs(logits).max()
    return state_dict_to_jax(model.state_dict())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_evaluate_equals_jax_for_each_family(family):
    """MVCNN and the single-view classifier: the same counts and per-class
    accuracy as the JAX package's `evaluate`, unfolded and folded."""
    jcfg, pcfg = (_family_config(m, family) for m in (jax_configs,
                                                       port_configs))
    batch = next(make_dataset(dataclasses.replace(
        pcfg.data, batch_size=N_SHAPES), train=False, num_epochs=1))
    variables = family_variables(family, batch["views"])
    ns = types.SimpleNamespace(**variables)
    for fold in (False, True):
        want = jax_evaluate(jcfg, state=ns, per_class=True, fold_bn=fold)
        got = port_eval.evaluate(pcfg, state=variables, per_class=True,
                                 fold_bn=fold, device="cpu")
        assert got["count"] == want["count"] == N_SHAPES
        assert got == want


def _train_cfg(logdir, **train_kw):
    cfg = _config(port_configs, transfer_dtype="uint8")
    return cfg.replace(dropout_keep_prob=0.8, train=dataclasses.replace(
        cfg.train, train_logdir=str(logdir), learning_rate=0.01,
        log_every=1, checkpoint_every=2, **train_kw))


def test_evaluate_from_a_train_checkpoint_equals_state(tmp_path):
    cfg = _train_cfg(tmp_path)
    state, _ = port_train(cfg, num_steps=2, device="cpu")
    assert state.model.training
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    for fold in (False, True):
        from_state = port_eval.evaluate(cfg, state=state, per_class=True,
                                        fold_bn=fold, device="cpu")
        assert state.model.training            # back in train mode
        assert port_eval.evaluate(cfg, per_class=True, fold_bn=fold,
                                  device="cpu") == from_state
        assert port_eval.evaluate(cfg, str(tmp_path), fold_bn=fold,
                                  device="cpu")["count"] == N_SHAPES
    after = state.model.state_dict()
    for k in before:                           # folding used a copy
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0)


def test_load_model_reads_the_model_alone(tmp_path):
    cfg = _train_cfg(tmp_path, optimizer="adam")
    state, _ = port_train(cfg, num_steps=2, device="cpu")
    model = load_model(cfg, device="cpu")     # default: train_logdir
    assert not model.training
    want = state.model.state_dict()
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert set(model_state(str(tmp_path))) == set(want)


def test_load_model_refuses_what_it_cannot_read(tmp_path):
    cfg = _config(port_configs)
    with pytest.raises(FileNotFoundError):
        load_model(cfg, str(tmp_path / "missing"), "cpu")
    (tmp_path / "3" / "default").mkdir(parents=True)     # Orbax layout
    with pytest.raises(FileNotFoundError, match="no Orbax _METADATA"):
        load_model(cfg, str(tmp_path), "cpu")
    shutil.rmtree(tmp_path / "3")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        load_model(cfg, str(tmp_path), "cpu")


def test_evaluate_refuses_more_than_one_device(shared):
    """num_devices is the world's size: 2 in a single process is refused
    with the command that launches 2 ranks (multi-process evaluation is
    `tests/test_torch_parallel.py`'s)."""
    with pytest.raises(ValueError, match="launch 2 ranks, one per card"):
        port_eval.evaluate(_config(port_configs).replace(num_devices=2),
                           state=shared[0], device="cpu")


def test_cli_scores_a_checkpoint(tmp_path, monkeypatch, capsys):
    cfg = _train_cfg(tmp_path)
    port_train(cfg, num_steps=1, device="cpu")
    monkeypatch.setitem(port_configs.CONFIGS, "tiny_eval", cfg)
    port_eval.main(["--config", "tiny_eval", "--checkpoint_dir",
                    str(tmp_path), "--per_class", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'count': 10" in out and "per_class_accuracy" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="never falls back"):
        port_eval.main(["--config", "tiny_eval"])
    with pytest.raises(SystemExit, match="no checkpoint directory"):
        port_eval.main(["--config", "tiny_eval", "--device", "cpu",
                        "--checkpoint_dir", str(tmp_path / "missing")])


# ------------------------------------------------------------ --eval_every

def _records(logdir):
    lines = (logdir / "metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


def _assert_same_run(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:                      # parameters and BN statistics
        torch.testing.assert_close(sb[k], sa[k], rtol=0, atol=0, msg=k)
    for x, y in zip(a.optimizer.slots["trace"], b.optimizer.slots["trace"]):
        torch.testing.assert_close(y, x, rtol=0, atol=0)


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    """4 steps without --eval_every."""
    logdir = tmp_path_factory.mktemp("plain")
    return port_train(_train_cfg(logdir), num_steps=4, device="cpu"), logdir


def test_eval_every_records_evaluations_and_changes_nothing(tmp_path,
                                                            plain_run):
    (plain, plain_mets), plain_dir = plain_run
    cfg = _train_cfg(tmp_path / "run", eval_every=2)
    state, mets = port_train(cfg, num_steps=4, device="cpu")
    assert mets == plain_mets                         # loss bit for bit
    _assert_same_run(plain, state)
    assert state.model.training and all(m.training
                                        for m in state.model.modules())
    evals = [r for r in _records(tmp_path / "run") if "val_accuracy" in r]
    assert [r["step"] for r in evals] == [2, 4]
    assert not any("val_accuracy" in r for r in _records(plain_dir))
    for rec in evals:
        one = tmp_path / f"step{rec['step']}"
        one.mkdir()
        shutil.copy(Checkpointer(str(tmp_path / "run")).path(rec["step"]),
                    one)
        got = port_eval.evaluate(cfg, str(one), device="cpu")
        assert rec["val_count"] == got["count"] == N_SHAPES
        assert rec["val_accuracy"] == got["accuracy"]


def test_resume_with_another_eval_every(tmp_path, plain_run):
    (plain, _), _ = plain_run
    port_train(_train_cfg(tmp_path), num_steps=2, device="cpu")
    resumed, _ = port_train(_train_cfg(tmp_path, eval_every=1), num_steps=4,
                            device="cpu")
    _assert_same_run(plain, resumed)
    assert [r["step"] for r in _records(tmp_path)
            if "val_accuracy" in r] == [3, 4]
