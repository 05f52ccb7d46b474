"""The port's train step and loop (train.py, checkpoint.py) against the
JAX package's, on the CPU.

- `make_lr_schedule` against the JAX one (optax), with and without
  warmup: rtol 1e-6 (optax computes in fp32).
- `Optimizer` against optax (momentum, sgd, adam, each with and without
  clip_by_global_norm) over 3 updates of random gradients: rtol 1e-6 /
  atol 1e-7 (fp32, the same operations in the same order).
- `l2_regularization` on bridged parameters against the JAX one: rtol
  1e-5 (the port squares a norm taken per tensor, JAX sums squares: 1e-6
  apart).
- Three train steps against `make_train_step` at fp32 with dropout off, on
  mn40_12view cut to Mixed_3b (scoring FCN on Conv2d_2c_3x3), 32x32, 2
  views, B = 4, lr 0.01, with accumulate_steps 1 and 2; weights from the
  JAX init through the bridge.  Loss and grad_norm rtol 1e-4; params and
  batch_stats rtol 1e-4 / atol 1e-5.  (Train-mode BatchNorm over a few
  dozen elements a channel amplifies fp32 rounding in the backward: at
  accumulate_steps 2 the first step's grad_norm already differs by 8e-6
  relative, and the gap grows with the learning rate; measured at lr 0.01
  it stays below 1e-5 for loss and grad_norm.  The score-logit bias has an
  analytic gradient of 0 under the softmax over views, so it moves by
  rounding noise only and is held by atol.)
- A run interrupted by a checkpoint and resumed equals an uninterrupted
  one bit for bit (dropout on, synthetic stream); SIGTERM saves and stops;
  the CLI refuses what is not ported and exits non-zero without a card.
"""

import dataclasses
import importlib
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import (  # noqa: E402
    jax_to_state_dict,
    state_dict_to_jax,
)
from gvcnn_tf_tpu_torch.checkpoint import Checkpointer  # noqa: E402

# Both packages' __init__ export a function named `train`.
jax_train = importlib.import_module("gvcnn_tf_tpu.train")
port_train = importlib.import_module("gvcnn_tf_tpu_torch.train")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(mod, **train_kw):
    cfg = mod.get_config("mn40_12view")
    return cfg.replace(
        compute_dtype="float32", dropout_keep_prob=1.0,
        raw_endpoint="Conv2d_2c_3x3", final_endpoint="Mixed_3b",
        data=dataclasses.replace(cfg.data, height=32, width=32, num_views=2,
                                 batch_size=4),
        train=dataclasses.replace(cfg.train, **train_kw))


# ------------------------------------------------------------- schedule

@pytest.mark.parametrize("warmup", [0, 5])
def test_lr_schedule_matches_jax(warmup):
    kw = dict(learning_rate=0.05, lr_decay_rate=0.94, lr_decay_steps=7,
              warmup_steps=warmup)
    tc = port_configs.TrainConfig(**kw)
    want = jax_train.make_lr_schedule(jax_configs.TrainConfig(**kw))
    got = port_train.make_lr_schedule(tc)
    for t in range(40):
        assert got(t) == pytest.approx(float(want(t)), rel=1e-6, abs=1e-9), t


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("clip", [0.0, 1.5])
@pytest.mark.parametrize("kind", ["momentum", "sgd", "adam"])
def test_optimizer_matches_optax(kind, clip):
    kw = dict(optimizer=kind, learning_rate=0.1, lr_decay_steps=2,
              lr_decay_rate=0.5, warmup_steps=1, grad_clip_norm=clip)
    rs = np.random.RandomState(len(kind) + int(clip))
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]

    tx = jax_train.make_optimizer(jax_configs.TrainConfig(**kw))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = port_train.Optimizer(tp, port_configs.TrainConfig(**kw))
    for g in grads:
        upd, opt_state = tx.update([jnp.asarray(a) for a in g], opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(a) for a in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    assert opt.count == 3


def test_optimizer_state_round_trips():
    tc = port_configs.TrainConfig(optimizer="adam")
    p = [torch.ones(3)]
    opt = port_train.Optimizer(p, tc)
    opt.step([torch.full((3,), 0.5)])
    other = port_train.Optimizer([torch.ones(3)], tc)
    other.load_state_dict(opt.state_dict())
    assert other.count == 1
    torch.testing.assert_close(other.slots["nu"][0], opt.slots["nu"][0])
    with pytest.raises(ValueError, match="optimizer"):
        port_train.Optimizer([torch.ones(3)], port_configs.TrainConfig(
            optimizer="sgd")).load_state_dict(opt.state_dict())


# ------------------------------------------------------------------- L2

def test_l2_regularization_on_bridged_params():
    cfg = _tiny(jax_configs)
    _, _, state = jax_train.create_train_state(cfg, jax.random.key(0))
    want = float(jax_train.l2_regularization(state.params, 4e-5))
    sd = jax_to_state_dict(jax.device_get({"params": state.params}))
    kernels = port_train.kernel_params(sd.items())
    got = port_train.l2_regularization(kernels, 4e-5)
    assert float(got) == pytest.approx(want, rel=1e-5)
    # Kernels only: every conv and Logits weight, no bias.
    assert len(kernels) == sum(k.endswith("weight") for k in sd)
    assert not any(k.endswith("bias") and any(v is p for p in kernels)
                   for k, v in sd.items())


# ---------------------------------------------------- steps against JAX

def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_three_train_steps_track_jax(accumulate):
    kw = dict(learning_rate=0.01, accumulate_steps=accumulate)
    jcfg, pcfg = _tiny(jax_configs, **kw), _tiny(port_configs, **kw)
    model, tx, jstate = jax_train.create_train_state(jcfg, jax.random.key(0))
    step = jax.jit(jax_train.make_train_step(model, tx, jcfg))

    state = port_train.create_train_state(pcfg, "cpu")
    state.model.load_state_dict(jax_to_state_dict(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})))

    rs = np.random.RandomState(1)
    for i in range(3):
        views = rs.uniform(-1, 1, (4, 2, 32, 32, 3)).astype(np.float32)
        labels = rs.randint(0, 40, 4).astype(np.int32)
        jstate, jm = step(jstate, {"views": jnp.asarray(views),
                                   "label": jnp.asarray(labels)},
                          jax.random.key(1))
        pm = port_train.train_step(state, {
            "views": torch.from_numpy(views),
            "label": torch.from_numpy(labels)}, pcfg)
        for key in ("loss", "grad_norm", "accuracy"):
            assert float(pm[key]) == pytest.approx(float(jm[key]),
                                                   rel=1e-4), (i, key)
    assert state.step == int(jstate.step) == 3
    want = dict(_flat(jax.device_get({"params": jstate.params,
                                      "batch_stats": jstate.batch_stats})))
    got = dict(_flat(state_dict_to_jax(state.model.state_dict())))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_train_step_refuses_a_ragged_accumulation():
    cfg = _tiny(port_configs, accumulate_steps=3)
    state = port_train.create_train_state(cfg, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        port_train.train_step(state, {
            "views": torch.zeros(4, 2, 32, 32, 3),
            "label": torch.zeros(4, dtype=torch.long)}, cfg)


# ------------------------------------------------ training loop and resume

def _loop_cfg(logdir, **kw):
    cfg = _tiny(port_configs, **{"train_logdir": str(logdir),
                                 "checkpoint_every": 2, "log_every": 1,
                                 "learning_rate": 0.01, **kw})
    return cfg.replace(dropout_keep_prob=0.8, data=dataclasses.replace(
        cfg.data, batch_size=2, synthetic_num_shapes=6))


def test_resume_reproduces_an_uninterrupted_run(tmp_path):
    whole, _ = port_train.train(_loop_cfg(tmp_path / "a"), num_steps=5,
                                device="cpu")
    cfg = _loop_cfg(tmp_path / "b")
    first, _ = port_train.train(cfg, num_steps=3, device="cpu")
    assert Checkpointer(cfg.train.train_logdir).steps() == [2, 3]
    resumed, _ = port_train.train(cfg, num_steps=5, device="cpu")
    assert resumed.step == whole.step == 5
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)
    for x, y in zip(whole.optimizer.slots["trace"],
                    resumed.optimizer.slots["trace"]):
        torch.testing.assert_close(y, x, rtol=0, atol=0)
    assert len((tmp_path / "a" / "metrics.jsonl").read_text().splitlines()) \
        == 5


def test_resume_refuses_another_runs_checkpoint(tmp_path):
    port_train.train(_loop_cfg(tmp_path), num_steps=2, device="cpu")
    # Length and cadence may change on resume ...
    state, _ = port_train.train(_loop_cfg(tmp_path, log_every=2,
                                          checkpoint_every=3),
                                num_steps=3, device="cpu")
    assert state.step == 3
    # ... the optimization may not.
    with pytest.raises(ValueError, match=r"differs in train\.learning_rate\)"):
        port_train.train(_loop_cfg(tmp_path, learning_rate=0.02),
                         num_steps=4, device="cpu")
    assert Checkpointer(str(tmp_path)).latest_step() == 3


def test_cli_requires_a_train_logdir(capsys):
    with pytest.raises(SystemExit) as e:
        port_train.main(["--how_many_training_steps", "1", "--device", "cpu"])
    assert e.value.code != 0
    assert "--train_logdir is required" in capsys.readouterr().err


def test_train_step_drift_of_a_step_against_itself_is_zero():
    from gvcnn_tf_tpu_torch.tools.measure import grad_group, train_step_drift

    cfg = _tiny(port_configs).replace(compute_dtype="float32")
    drift = train_step_drift(cfg, "cpu")
    assert drift["loss_rel"] == drift["grad_norm_rel"] == 0.0
    assert drift["layer_logratio"] == 0.0
    assert drift["grad_cosine"] == pytest.approx(1.0, abs=1e-12)
    assert "Conv2d_1a_7x7/bn_bias" in drift["group_cosines"]
    assert grad_group("InceptionV1.Mixed_5c.Branch_1_Conv2d_0b_3x3."
                      "BatchNorm.bias") == "Mixed_5c/bn_bias"
    assert grad_group("Logits.weight") == "Logits/kernel"


def test_sigterm_saves_and_stops(tmp_path):
    cfg = _loop_cfg(tmp_path, checkpoint_every=100)
    from gvcnn_tf_tpu_torch.data import make_dataset

    def stream():
        for i, batch in enumerate(make_dataset(cfg.data, train=True)):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    before = signal.getsignal(signal.SIGTERM)
    state, _ = port_train.train(cfg, num_steps=50, dataset_iter=stream(),
                                device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before
    # The prefetcher reads ahead, so the signal lands during step 1 or 2.
    assert 1 <= state.step <= 3
    assert Checkpointer(str(tmp_path)).latest_step() == state.step


@pytest.mark.parametrize("change,item", [
    (dict(train=dict(checkpoint_path="/x")), "item 14"),
    (dict(data=dict(loader="decoded")), "item 7"),
    (dict(bn_sync="local"), "item 10"),
    (dict(num_devices=2), "item 10"),
    (dict(data=dict(loader="tfrecord")), "item 7"),
    (dict(data=dict(device_resident="on")), "item 15"),
])
def test_train_refuses_what_is_not_ported(tmp_path, change, item):
    cfg = _loop_cfg(tmp_path)
    for part in ("train", "data"):
        if part in change:
            change[part] = dataclasses.replace(getattr(cfg, part),
                                               **change[part])
    with pytest.raises(NotImplementedError, match=item):
        port_train.train(cfg.replace(**change), num_steps=1, device="cpu")


def test_train_refuses_profile_steps(tmp_path):
    with pytest.raises(NotImplementedError, match="measure.py profile"):
        port_train.train(_loop_cfg(tmp_path), profile_steps=(1, 2),
                         device="cpu")


def test_cli_without_a_card_exits_nonzero(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "gvcnn_tf_tpu_torch.train",
         "--how_many_training_steps", "1", "--train_logdir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "never falls back" in proc.stderr
    assert not os.listdir(tmp_path)
