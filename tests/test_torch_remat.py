"""Rematerialization in the port (`layers.remat`: `remat_until` in
Inception-v1, `remat_backbone` in the three families) on the CPU.

- The port against itself: one `train_step` from the seeded init with and
  without remat, dropout on, gives bit-equal logits, loss, grad_norm,
  running statistics and updated parameters.  The recompute runs the same
  ops on the same inputs and autograd's graph keeps its shape, so nothing
  is summed in another order; no tolerance is needed.  Cases: GVCNN with
  `remat_until` MaxPool_3a_3x3 (the scoring tap Mixed_3c after the
  region), Mixed_3c (the tap is the region's boundary) and Mixed_4b (the
  tap inside the region), `remat_backbone`, and both; MVCNN and the
  single-view classifier with each; GVCNN on ResNet-50 with
  `remat_backbone`.  32x32, B = 2, 2 views (3 on ResNet-50), full depth:
  Inception-v1's plan reaches every endpoint there (16x16 after the stem,
  1x1 after MaxPool_5a_2x2), so each remat boundary and tap is the one a
  larger input has.
- Against JAX: the port's `InceptionV1Base(remat_until=...)` and the JAX
  package's on the same bridged weights, 64x64, B = 2, through
  MaxPool_4a_3x3.  In eval mode, as `tests/test_inception_v1.py`'s remat
  test does: the features and the gradient of sum(features^2) with respect
  to every parameter, max|diff| <= 1e-4 x max|ref| per tensor (the v1
  parity tests' 1e-4: fp32 summed in another order by XLA:CPU and oneDNN;
  read 1.4e-6).  In train mode: the features and every running statistic
  after the step, at the same bound (read 9.0e-6 and 3.2e-6): the
  statistics move once although the region runs twice.  Train-mode
  gradients are not held against JAX here: BatchNorm over 32-128 elements
  a channel amplifies fp32 rounding in the backward (read 9e-5 of max,
  too near the bound to hold); `test_three_train_steps_track_jax` holds
  the step's parameters instead.
- Errors and no-ops: an endpoint outside the plan raises ValueError
  naming remat_until; `remat_until` on ResNet-50 is logged and the step
  equals the plain one; accumulate_steps 2 under remat equals it without.
- Saved bytes: with `remat_until`, the storage that autograd keeps for the
  backward outside the region (a `saved_tensors_hooks` pack hook, counted
  once a storage) falls by at least the bytes of the prefix's activations
  (its endpoints before the boundary), the CPU's stand-in for the card's
  peak memory.
- Data parallel: 2 gloo ranks, each mode with and without `remat_until`,
  bit-equal, and the global-mode step with remat against one process's
  step on the whole batch at `test_torch_parallel_train.py`'s bound for
  that comparison (rtol 1e-5 / atol 1e-6: the ranks' BatchNorm takes Flax's
  fast variance, one process PyTorch's Welford pass).
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gvcnn_tf_tpu.models.backbones.inception_v1 import (  # noqa: E402
    InceptionV1Base as JaxInceptionV1Base,
)
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import (  # noqa: E402
    jax_to_state_dict,
    state_dict_to_jax,
)
from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import (  # noqa: E402
    ENDPOINT_CHANNELS,
    InceptionV1Base,
)
from gvcnn_tf_tpu_torch.models.gvcnn import build_model  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from test_torch_parallel import run_ranks  # noqa: E402

port_train = importlib.import_module("gvcnn_tf_tpu_torch.train")
B = 2
REL = 1e-4
UNTIL = dict(remat_until="MaxPool_3a_3x3")
BACKBONE = dict(remat_backbone=True)

# family: (config, views, size).
FAMILIES = {"gvcnn": ("mn40_12view", 2, 32),
            "mvcnn": ("mn40_12view_mvcnn", 2, 32),
            "single_view": ("mn10_single_view", 1, 32),
            "resnet50": ("mn40_12view_resnet50", 3, 32)}


def _config(family, accumulate=1, **remat):
    name, views, size = FAMILIES[family]
    cfg = port_configs.get_config(name)
    return cfg.replace(
        compute_dtype="float32", **remat,
        data=dataclasses.replace(cfg.data, height=size, width=size,
                                 num_views=views, batch_size=B),
        train=dataclasses.replace(cfg.train, accumulate_steps=accumulate))


def _batch(cfg):
    d = cfg.data
    rs = np.random.RandomState(3)
    return {"views": torch.from_numpy(rs.uniform(
                -1, 1, (B, d.num_views, d.height, d.width, 3)).astype(
                    np.float32)),
            "label": torch.from_numpy(rs.randint(0, d.num_classes, B))}


def _step(cfg):
    """(logits of the step's first forward, metrics, state_dict) of one
    train_step from the seeded init."""
    state = port_train.create_train_state(cfg, "cpu")
    logits = []
    hook = state.model.register_forward_hook(
        lambda m, args, out: logits.append(out[0].detach().clone()))
    mets = port_train.train_step(state, _batch(cfg), cfg)
    hook.remove()
    return (logits[0], {k: v.clone() for k, v in mets.items()},
            {k: v.clone() for k, v in state.model.state_dict().items()})


@functools.lru_cache(maxsize=None)
def _plain(family, accumulate=1):
    return _step(_config(family, accumulate))


def _assert_same_step(got, want):
    logits, mets, sd = got
    wlogits, wmets, wsd = want
    assert torch.equal(logits, wlogits)
    for k in wmets:
        assert torch.equal(mets[k], wmets[k]), k
    assert set(sd) == set(wsd)
    stats = [k for k in wsd if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in wsd:
        assert torch.equal(sd[k], wsd[k]), k


@pytest.mark.parametrize("family,remat", [
    ("gvcnn", UNTIL),
    ("gvcnn", dict(remat_until="Mixed_3c")),
    ("gvcnn", dict(remat_until="Mixed_4b")),
    ("gvcnn", BACKBONE),
    ("gvcnn", dict(UNTIL, **BACKBONE)),
    ("mvcnn", UNTIL),
    ("mvcnn", BACKBONE),
    ("single_view", UNTIL),
    ("single_view", BACKBONE),
    ("resnet50", BACKBONE),
], ids=lambda v: "-".join(f"{k}={v[k]}" for k in v)
   if isinstance(v, dict) else v)
def test_remat_step_equals_the_plain_step(family, remat):
    _assert_same_step(_step(_config(family, **remat)), _plain(family))


def test_accumulated_remat_step_equals_the_plain_one():
    _assert_same_step(_step(_config("gvcnn", accumulate=2, **UNTIL)),
                      _plain("gvcnn", accumulate=2))


def test_remat_until_on_resnet50_is_logged_and_a_no_op(capsys):
    cfg = _config("resnet50", remat_until="block1")
    got = _step(cfg)
    assert "remat_until='block1'" in capsys.readouterr().err
    _assert_same_step(got, _plain("resnet50"))


@pytest.mark.parametrize("final,until", [("Mixed_3b", "Mixed_4b"),
                                         ("Mixed_5c", "Mixed_9z")])
def test_remat_until_outside_the_plan_raises(final, until):
    cfg = _config("gvcnn", raw_endpoint="Conv2d_2c_3x3",
                  final_endpoint=final, remat_until=until)
    with pytest.raises(ValueError, match="remat_until"):
        build_model(cfg)


def _saved_bytes(model, x):
    """Bytes of the distinct storages autograd saves for the backward of
    one forward (outside any remat region, whose own hooks take over)."""
    storages = {}

    def pack(t):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(x, generator=torch.Generator().manual_seed(0))
    return sum(storages.values())


def test_remat_until_drops_the_prefix_activations():
    plain_cfg = _config("gvcnn")
    x = _batch(plain_cfg)["views"]
    got = {}
    for name, cfg in (("plain", plain_cfg), ("remat", _config("gvcnn",
                                                              **UNTIL))):
        model = port_train.create_train_state(cfg, "cpu").model
        got[name] = _saved_bytes(model, x)
    # The prefix's endpoints before the boundary: half the input's side
    # after the stem, a quarter after MaxPool_2a_3x3, fp32, B * V images.
    _, n, size = FAMILIES["gvcnn"]
    n *= B
    prefix = sum(n * ENDPOINT_CHANNELS[k] * s * s * 4 for k, s in (
        ("Conv2d_1a_7x7", size // 2), ("MaxPool_2a_3x3", size // 4),
        ("Conv2d_2b_1x1", size // 4), ("Conv2d_2c_3x3", size // 4)))
    assert got["plain"] - got["remat"] >= prefix, (got, prefix)


# ------------------------------------------------------------ against JAX

@pytest.fixture(scope="module")
def jax_v1():
    """The JAX Inception-v1 through MaxPool_4a_3x3, initialized once at
    64x64, and a seeded B = 2 input."""
    x = np.random.RandomState(1).uniform(-1, 1, (B, 64, 64, 3)).astype(
        np.float32)
    model = JaxInceptionV1Base(final_endpoint="MaxPool_4a_3x3")
    variables = jax.device_get(jax.jit(functools.partial(
        model.init, train=False))({"params": jax.random.key(0)}, x))
    return x, variables


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_close_rel(got, want, msg):
    assert got.shape == want.shape, msg
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), (msg, err)


@pytest.mark.parametrize("until,train", [("MaxPool_3a_3x3", False),
                                         ("Mixed_3c", False),
                                         ("MaxPool_3a_3x3", True)])
def test_remat_until_matches_jax(jax_v1, until, train):
    x, variables = jax_v1
    jmodel = JaxInceptionV1Base(final_endpoint="MaxPool_4a_3x3",
                                remat_until=until)

    def loss(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if train:
            (f, _), upd = jmodel.apply(v, x, train=True,
                                       mutable=["batch_stats"])
        else:
            (f, _), upd = jmodel.apply(v, x, train=False), {}
        return jnp.sum(f ** 2), (f, upd)

    (_, (jf, upd)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    jf, upd, jg = jax.device_get((jf, upd, jg))

    port = InceptionV1Base(final_endpoint="MaxPool_4a_3x3",
                           remat_until=until, keep=())
    port.load_state_dict(jax_to_state_dict(variables))
    port.train(train)
    feats, endpoints = port(torch.from_numpy(x))
    # The region hands back none of its endpoints (keep=()).
    k = port._names.index(until) + 1
    assert set(endpoints) == set(port._names[k:])
    feats.square().sum().backward()
    _assert_close_rel(feats.detach().permute(0, 2, 3, 1).numpy(),
                      np.asarray(jf), "features")
    if train:
        got = dict(_flat(state_dict_to_jax(port.state_dict())[
            "batch_stats"]))
        want = dict(_flat(upd["batch_stats"]))
        assert set(got) == set(want)
        for name in want:
            _assert_close_rel(got[name], want[name], name)
        return
    got = dict(_flat(state_dict_to_jax(
        {n: p.grad for n, p in port.named_parameters()})["params"]))
    want = dict(_flat(jg))
    assert set(got) == set(want)
    for name in want:
        _assert_close_rel(got[name], want[name], name)


# ------------------------------------------------------- data parallel

def test_remat_over_two_ranks(tmp_path):
    """Each bn_sync mode over 2 gloo ranks, remat_until MaxPool_3a_3x3
    with the scoring tap (Conv2d_2c_3x3) inside the region: bit-equal to
    the same mode without it; the global mode against one process at
    rtol 1e-5 / atol 1e-6."""
    cfg = port_configs.get_config("mn40_12view")
    cfg = cfg.replace(
        compute_dtype="float32", dropout_keep_prob=1.0,
        raw_endpoint="Conv2d_2c_3x3", final_endpoint="Mixed_3b",
        data=dataclasses.replace(cfg.data, height=32, width=32, num_views=2,
                                 batch_size=4))
    rs = np.random.RandomState(5)
    batch = {"views": rs.uniform(-1, 1, (4, 2, 32, 32, 3)).astype(
                 np.float32),
             "label": rs.randint(0, 40, 4).astype(np.int64)}
    results = run_ranks(tmp_path, ranks.remat_rank, 2, cfg, batch,
                        "MaxPool_3a_3x3")
    for r, out in enumerate(results):
        for mode in ("global", "local"):
            plain, remat = out[f"{mode}_plain"], out[f"{mode}_remat"]
            assert plain["mets"] == remat["mets"], (r, mode)
            for k, v in plain["state"].items():
                assert torch.equal(remat["state"][k], v), (r, mode, k)
        alone = out["alone"]
        for k, v in alone["mets"].items():
            assert out["global_remat"]["mets"][k] == pytest.approx(
                v, rel=1e-5), (r, k)
        for k, v in alone["state"].items():
            np.testing.assert_allclose(out["global_remat"]["state"][k], v,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("fits_up_to,want", [(37, (37, 9)), (8, (8, 5)),
                                             (5000, (1024, 8))])
def test_largest_batch_doubles_then_bisects(monkeypatch, fits_up_to, want):
    """`measure.py remat`'s search, with a step that fits up to a batch
    size: doubling from 8, bisecting to one shape, capped at its limit."""
    from gvcnn_tf_tpu_torch.tools import measure

    tried = []

    def step_fits(state, cfg, b, dev):
        tried.append(b)
        return 1000 * b if b <= fits_up_to else None

    monkeypatch.setattr(measure, "_step_fits", step_fits)
    fit, peak, probes = measure.largest_batch(None, None, None)
    assert (fit, probes) == want and peak == 1000 * fit
    assert probes == len(tried)
