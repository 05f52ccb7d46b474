"""The port's data-parallel train step on 2 gloo ranks (CPU) against the JAX
package's sharded steps on a 2-device mesh, and against itself.

The model is `test_torch_train.py`'s: mn40_12view cut to Mixed_3b (scoring
FCN on Conv2d_2c_3x3), fp32, 32x32, 2 views, global batch 4 (2 a rank), lr
0.01, weights from the JAX init through the bridge.  One `steps_rank` spawn
(`torch_parallel_ranks.py`) runs every port step; the JAX steps run here.

- `bn_sync="global"` against the JAX step jitted over a 2-device mesh with
  the batch sharded on `data` (`tests/test_sharding.py`'s
  `test_dp_train_step_matches_single_device`), and `bn_sync="local"`
  against its `shard_map` step, each with accumulate_steps 1 and 2 and
  dropout off: loss, grad_norm and accuracy rtol 1e-4; every parameter and
  BatchNorm statistic after the step rtol 1e-4 / atol 1e-5, the port's
  single-device step parity (`test_three_train_steps_track_jax`).
- The local step on a tiled batch (both ranks the same rows) equals one
  process's step on one tile bit for bit
  (`test_local_bn_matches_single_device_on_tiled_batch`); on a
  heterogeneous batch the two modes differ.
- The global step with dropout on (keep 0.5) equals one process's step on
  the whole global batch, accumulate_steps 1 and 2: the ranks draw one mask
  for the global (micro)batch and keep their rows.  rtol 1e-5 / atol 1e-6
  (the ranks' BatchNorm takes Flax's fast variance, one process PyTorch's
  Welford pass).
- After three steps (dropout 0.8) the two replicas are bitwise equal in
  both modes.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.parallel import (  # noqa: E402
    create_mesh,
    data_sharding,
    replicated_sharding,
    shard_batch,
)
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import (  # noqa: E402
    jax_to_state_dict,
    state_dict_to_jax,
)

import torch_parallel_ranks as ranks  # noqa: E402
from test_torch_parallel import run_ranks  # noqa: E402

jax_train = importlib.import_module("gvcnn_tf_tpu.train")
B, V, H = 4, 2, 32
TOL = dict(rtol=1e-4, atol=1e-5)


def _tiny(mod, **kw):
    cfg = mod.get_config("mn40_12view")
    return cfg.replace(
        compute_dtype="float32", dropout_keep_prob=1.0,
        raw_endpoint="Conv2d_2c_3x3", final_endpoint="Mixed_3b",
        data=dataclasses.replace(cfg.data, height=H, width=H, num_views=V,
                                 batch_size=B),
        train=dataclasses.replace(cfg.train, learning_rate=0.01), **kw)


def _batch(rs):
    return {"views": rs.uniform(-1, 1, (B, V, H, H, 3)).astype(np.float32),
            "label": rs.randint(0, 40, B).astype(np.int32)}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(JAX's init state, the batch, both ranks' results)."""
    model, tx, jstate = jax_train.create_train_state(_tiny(jax_configs),
                                                     jax.random.key(0))
    weights = jax_to_state_dict(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    rs = np.random.RandomState(1)
    batches = {"jax": _batch(rs), "steps": [_batch(rs) for _ in range(3)]}
    tile = {k: v[:B // 2] for k, v in _batch(rs).items()}
    res = run_ranks(tmp_path_factory.mktemp("steps"), ranks.steps_rank, 2,
                    _tiny(port_configs), weights, batches, tile)
    return (model, tx, jstate), batches["jax"], res


def _jax_step(jax_init, batch, mode, k):
    model, tx, jstate = jax_init
    cfg = _tiny(jax_configs, bn_sync=mode)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                accumulate_steps=k))
    mesh = create_mesh(2)
    repl, dsh = replicated_sharding(mesh), data_sharding(mesh)
    step = jax.jit(jax_train.make_train_step(model, tx, cfg, mesh=mesh),
                   in_shardings=(repl, dsh, repl),
                   out_shardings=(repl, repl))
    s, m = step(jax.device_put(jstate, repl), shard_batch(batch, mesh),
                jax.device_put(jax.random.key(1), repl))
    return jax.device_get((s, m))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mode", ["global", "local"])
def test_step_matches_the_jax_packages_sharded_step(steps, mode, k):
    jax_init, batch, res = steps
    jstate, jm = _jax_step(jax_init, batch, mode, k)
    want = dict(_flat({"params": jstate.params,
                       "batch_stats": jstate.batch_stats}))
    for r in res:
        got = r[f"{mode}_k{k}"]
        for key in ("loss", "grad_norm", "accuracy"):
            assert got["mets"][key] == pytest.approx(float(jm[key]),
                                                     rel=1e-4), key
        flat = dict(_flat(state_dict_to_jax(got["state"])))
        assert set(flat) == set(want)
        for name in want:
            np.testing.assert_allclose(flat[name], want[name], **TOL,
                                       err_msg=name)


def test_local_step_on_a_tiled_batch_is_one_process_on_one_tile(steps):
    _, _, res = steps
    for r in res:
        a, b = r["tiled"], r["tile_alone"]
        assert a["mets"] == b["mets"]
        for key, v in b["state"].items():
            torch.testing.assert_close(a["state"][key], v, rtol=0, atol=0,
                                       msg=key)


def test_the_modes_differ_on_a_heterogeneous_batch(steps):
    _, _, res = steps
    assert res[0]["global_k1"]["mets"]["loss"] \
        != res[0]["local_k1"]["mets"]["loss"]


@pytest.mark.parametrize("k", [1, 2])
def test_global_step_with_dropout_is_one_process_on_the_global_batch(steps,
                                                                    k):
    _, _, res = steps
    for r in res:
        a, b = r[f"dropout_k{k}"], r[f"dropout_k{k}_alone"]
        for key in ("loss", "grad_norm", "accuracy"):
            assert a["mets"][key] == pytest.approx(b["mets"][key],
                                                   rel=1e-5), key
        for key, v in b["state"].items():
            torch.testing.assert_close(a["state"][key], v, rtol=1e-5,
                                       atol=1e-6, msg=key)
    # Dropout was on: the step differs from the dropout-off one.
    assert res[0]["dropout_k1"]["mets"]["loss"] \
        != res[0]["global_k1"]["mets"]["loss"]


@pytest.mark.parametrize("mode", ["global", "local"])
def test_replicas_stay_bitwise_equal(steps, mode):
    _, _, (r0, r1) = steps
    a, b = r0[f"replica_{mode}"], r1[f"replica_{mode}"]
    assert a["mets"] == b["mets"]
    for key, v in a["state"].items():
        torch.testing.assert_close(b["state"][key], v, rtol=0, atol=0,
                                   msg=key)
