"""The port's GVCNN slice against the JAX package, at fp32 on the CPU.

mn40_12view narrowed to 64x64, 4 views, B=2, compute_dtype float32 (the
architecture is unchanged).  Weights come from the JAX init through the
bridge; the BN biases are then randomized and the BatchNorm statistics
calibrated to the batch in one port forward pass: each layer's running mean
is a tenth of its input's mean and its running var the input's mean square
about it, floored at the layer average.  Every BN then does non-trivial work
and activations stay O(1), without the cancellation that subtracting the
full mean of post-ReLU inputs causes (measured against a float64 run, that
cancellation amplified fp32 rounding ~1.3x per layer, to ~2e-4 at Mixed_5c
in both packages alike).  The same weights go back to JAX through the
bridge.  Every backbone endpoint, the scores, the exact group scheme, the
weights, the shape descriptor and the logits are compared, unfolded and
BN-folded.  Tolerance rtol 1e-4 / atol 1e-4: fp32 through ~60 conv layers,
summed in another order by XLA:CPU and oneDNN.  The whole forward also runs
for every score_squash x group_weight on a cut model
(`test_whole_model_matches_jax_for_each_score_mode`, bounds in its
docstring).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.models.backbones.inception_v1 import (  # noqa: E402
    InceptionV1Base as JaxInceptionV1Base,
)
from gvcnn_tf_tpu.models.gvcnn import init_model  # noqa: E402
from gvcnn_tf_tpu.utils.fold_bn import (  # noqa: E402
    fold_batch_norm as jax_fold_batch_norm,
)
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import (  # noqa: E402
    jax_to_state_dict,
    state_dict_to_jax,
)
from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import (  # noqa: E402
    ENDPOINTS,
    BatchNorm,
    Stem,
)
from gvcnn_tf_tpu_torch.models.gvcnn import build_model  # noqa: E402
from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv_plain  # noqa: E402
from gvcnn_tf_tpu_torch.utils import fold_batch_norm  # noqa: E402

B, V, H = 2, 4, 64
TOL = dict(rtol=1e-4, atol=1e-4)
SEED = 0


def _config(mod):
    cfg = mod.get_config("mn40_12view")
    return cfg.replace(compute_dtype="float32", data=dataclasses.replace(
        cfg.data, height=H, width=H, num_views=V))


@torch.no_grad()
def _calibrate_bn(model, x, rs):
    """Random BN biases, then each BN's running stats from its input's
    batch statistics, layer after layer, in one forward pass."""
    handles = []

    def hook(bn, args):
        y = args[0].float()
        mean = 0.1 * y.mean(dim=(0, 2, 3))
        sq = (y - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(sq + sq.mean())

    def stem_hook(stem, args):
        # The stem runs its BatchNorm as the conv's epilogue, not as a call.
        y = stem_conv_plain(args[0], stem.conv.weight)
        hook(stem.BatchNorm, (y.permute(0, 3, 1, 2),))

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.bias.copy_(torch.from_numpy(
                rs.normal(0, 0.1, m.bias.shape).astype(np.float32)))
            handles.append(m.register_forward_pre_hook(hook))
        elif isinstance(m, Stem):
            handles.append(m.register_forward_pre_hook(stem_hook))
    model(x)
    for h in handles:
        h.remove()


def _interior_edge_gap(scores, m):
    """Distance of every score to the nearest interior bucket edge j/M."""
    edges = np.arange(1, m) / m
    return np.abs(np.asarray(scores)[..., None] - edges).min()


@pytest.fixture(scope="module")
def slice_pair():
    rs = np.random.RandomState(SEED)
    x = rs.uniform(-1, 1, (B, V, H, H, 3)).astype(np.float32)
    jcfg, pcfg = _config(jax_configs), _config(port_configs)

    jmodel, init_vars = init_model(jcfg, jax.random.key(SEED), x.shape)
    init_np = jax.device_get(init_vars)
    port = build_model(pcfg).eval()
    port.load_state_dict(jax_to_state_dict(init_np))
    _calibrate_bn(port, torch.from_numpy(x), rs)
    variables = state_dict_to_jax(port.state_dict())

    jbackbone = JaxInceptionV1Base(
        dtype=jnp.float32, merge_branches=jcfg.merge_inception_branches)
    backbone_fn = jax.jit(lambda v, xf: jbackbone.apply(v, xf, train=False))
    model_fn = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))

    def run_jax(v):
        sub = {k: v[k]["InceptionV1"] for k in ("params", "batch_stats")}
        _, eps = backbone_fn(sub, x.reshape((B * V, H, H, 3)))
        _, ep = model_fn(v, x)
        return jax.device_get((eps, ep))

    @torch.no_grad()
    def run_port(model):
        _, eps = model.InceptionV1(torch.from_numpy(
            x.reshape((B * V, H, H, 3))))
        _, ep = model(torch.from_numpy(x))
        eps = {k: t.permute(0, 2, 3, 1).numpy() for k, t in eps.items()}
        return eps, {k: t.numpy() for k, t in ep.items()}

    unfolded = (run_jax(variables), run_port(port))
    jax_folded = jax.device_get(jax_fold_batch_norm(variables))
    fold_batch_norm(port)
    folded = (run_jax(jax_folded), run_port(port))
    return {"unfolded": unfolded, "folded": folded,
            "jax_folded": jax_folded, "port_folded": port.state_dict()}


@pytest.mark.parametrize("mode", ["unfolded", "folded"])
@pytest.mark.parametrize("name", ENDPOINTS)
def test_backbone_endpoint_matches_jax(slice_pair, mode, name):
    (jax_eps, _), (port_eps, _) = slice_pair[mode]
    assert port_eps[name].shape == jax_eps[name].shape
    np.testing.assert_allclose(port_eps[name], jax_eps[name], **TOL)


@pytest.mark.parametrize("mode", ["unfolded", "folded"])
def test_head_matches_jax(slice_pair, mode):
    (_, jep), (_, pep) = slice_pair[mode]
    scores = jep["view_discrimination_scores"]
    # The scheme is compared exactly, so the seed must keep every score
    # clear of the bucket edges, where an fp32 rounding moves a view.
    assert _interior_edge_gap(scores, 8) > 1e-5
    np.testing.assert_array_equal(pep["group_scheme"], jep["group_scheme"])
    for key in ("view_discrimination_scores", "view_descriptors",
                "group_weight", "shape_descriptor", "Logits",
                "Predictions"):
        assert pep[key].shape == jep[key].shape, key
        np.testing.assert_allclose(pep[key], jep[key], err_msg=key, **TOL)


def test_port_fold_matches_jax_fold(slice_pair):
    want = jax_to_state_dict(slice_pair["jax_folded"])
    got = slice_pair["port_folded"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_folded_equals_unfolded(slice_pair):
    _, (_, unfolded) = slice_pair["unfolded"]
    _, (_, folded) = slice_pair["folded"]
    np.testing.assert_array_equal(folded["group_scheme"],
                                  unfolded["group_scheme"])
    for key in ("view_discrimination_scores", "shape_descriptor", "Logits"):
        np.testing.assert_allclose(folded[key], unfolded[key], err_msg=key,
                                   **TOL)


def test_unsupported_configs_are_refused():
    """What the port refuses of these settings, the JAX package refuses
    too: a `remat_until` outside the active plan (at build here, at the
    first call there) and odd views under `stem_space_to_depth`."""
    cfg = port_configs.get_config("mn40_12view")
    with pytest.raises(ValueError, match="remat_until"):
        build_model(cfg.replace(final_endpoint="Mixed_4b",
                                remat_until="Mixed_5b"))
    model = build_model(cfg.replace(stem_space_to_depth=True,
                                    final_endpoint="Mixed_3b",
                                    raw_endpoint="Conv2d_2c_3x3"))
    with pytest.raises(ValueError, match="even"):
        model.InceptionV1(torch.zeros(1, 33, 32, 3))
    # The data-parallel config builds every rank's replica, the same model.
    dp8 = port_configs.get_config("mn40_12view_dp8")
    assert dp8.num_devices == 8
    with torch.device("meta"):
        assert type(build_model(dp8)) is type(build_model(cfg))


@pytest.mark.parametrize("setting", [
    dict(stem_space_to_depth=True), dict(remat_until="MaxPool_3a_3x3"),
    dict(remat_backbone=True)], ids=lambda d: next(iter(d)))
def test_jax_layout_and_remat_settings_build(setting):
    """Settings the JAX package runs and the port once refused: each builds
    the plain model, with the same parameters, for mn40_12view and for
    every rank of mn40_12view_dp8."""
    for name in ("mn40_12view", "mn40_12view_dp8"):
        cfg = port_configs.get_config(name)
        with torch.device("meta"):
            plain, model = build_model(cfg), build_model(cfg.replace(
                **setting))
        assert type(model) is type(plain)
        assert ({k: v.shape for k, v in model.state_dict().items()}
                == {k: v.shape for k, v in plain.state_dict().items()})


def test_space_to_depth_stem_matches_jax():
    """`stem_space_to_depth`: the port (the stem as its kernel, the plain
    version here) against the JAX package's `SpaceToDepthStem` backbone on
    the same variables, eval mode, 64x64, through Mixed_3b, at
    `tests/test_space_to_depth.py`'s rtol and atol 1e-5; odd views raise
    in both packages (the JAX transform's reshape needs even H and W)."""
    rs = np.random.RandomState(1)
    x = rs.randn(1, 64, 64, 3).astype(np.float32)
    jmodel = JaxInceptionV1Base(final_endpoint="Mixed_3b",
                                stem_space_to_depth=True)
    variables = jax.jit(lambda x: jmodel.init(
        {"params": jax.random.key(0)}, x, train=False))(x)
    want, _ = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, x)
    cfg = _config(port_configs).replace(
        stem_space_to_depth=True, raw_endpoint="Conv2d_2c_3x3",
        final_endpoint="Mixed_3b")
    port = build_model(cfg).InceptionV1.eval()
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in
                          jax_to_state_dict(jax.device_get(
                              {c: {"InceptionV1": t} for c, t in
                               variables.items()})).items()})
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    odd = rs.randn(1, 63, 64, 3).astype(np.float32)
    with pytest.raises(ValueError, match="even"):
        port(torch.from_numpy(odd))
    with pytest.raises(TypeError):
        jmodel.apply(variables, odd, train=False)


def test_bn_training_mode_raises():
    """Train mode runs: every BatchNorm takes the batch's statistics and
    moves its running statistics with config.bn_momentum.  What raises is
    dropout without a generator, and the eval-only BN affine."""
    cfg = _config(port_configs).replace(bn_momentum=0.5)
    model = build_model(cfg)                # modules start in train mode
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (1, V, H, H, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="generator"):
        model(x)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert bns and all(m.momentum == 0.5 for m in bns)
    logits, _ = model(x, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(logits).all() and logits.requires_grad
    assert all(not torch.equal(m.running_var, torch.ones_like(
        m.running_var)) for m in bns)
    with pytest.raises(RuntimeError, match="training mode"):
        bns[0].scale_shift()
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(model(x)[0], model(x)[0])  # no dropout


# Score logit (scale, bias) settings tried in turn until every squashed
# score is clear of the bucket edges j/8 (softmax over views ignores the
# bias; the scale spreads the scores over the groups).
_SCORE_SETTINGS = [(s, b) for s in (4.0, 1.0, 12.0, 0.5)
                   for b in (0.0, 0.37, -0.61, 1.3, -1.7)]


@pytest.mark.parametrize("weight", ["mean", "ceil_sum"])
@pytest.mark.parametrize("squash", ["softmax", "sigmoid", "sigmoid_log"])
def test_whole_model_matches_jax_for_each_score_mode(squash, weight):
    """The whole GVCNN forward, port against JAX, for every score_squash x
    group_weight, on mn40_12view cut to Mixed_3b (scoring FCN on
    Conv2d_2c_3x3), 32x32, 4 views, B = 2, fp32, calibrated BN: logits
    within 1e-5 of max|logit|, the group scheme exact.  The score logit is
    scaled and shifted (a fixed list of settings, the first that clears
    every edge by 1e-4) so the views spread over several groups."""
    def cut(mod):
        cfg = mod.get_config("mn40_12view")
        return cfg.replace(
            compute_dtype="float32", score_squash=squash,
            group_weight=weight, raw_endpoint="Conv2d_2c_3x3",
            final_endpoint="Mixed_3b", data=dataclasses.replace(
                cfg.data, height=32, width=32, num_views=4))

    rs = np.random.RandomState(11)
    x = rs.uniform(-1, 1, (2, 4, 32, 32, 3)).astype(np.float32)
    jmodel, init = init_model(cut(jax_configs), jax.random.key(SEED),
                              x.shape)
    port = build_model(cut(port_configs)).eval()
    port.load_state_dict(jax_to_state_dict(jax.device_get(init)))
    _calibrate_bn(port, torch.from_numpy(x), rs)
    logit = port.GroupingModule.Conv2d_score_logit
    w0 = logit.weight.detach().clone()
    for scale, bias in _SCORE_SETTINGS:
        with torch.no_grad():
            logit.weight.copy_(w0 * scale)
            logit.bias.fill_(bias)
            _, ep = port(torch.from_numpy(x))
        scores = ep["view_discrimination_scores"].numpy()
        if _interior_edge_gap(scores, 8) > 1e-4:
            break
    else:
        raise AssertionError("no setting keeps the scores off the edges")
    assert (ep["group_scheme"].sum(-1) > 0).sum(-1).max() > 1  # spread
    _, jep = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        state_dict_to_jax(port.state_dict()), x)
    jep = jax.device_get(jep)
    np.testing.assert_array_equal(ep["group_scheme"].numpy(),
                                  jep["group_scheme"])
    want = jep["Logits"]
    assert np.abs(ep["Logits"].numpy() - want).max() <= (
        1e-5 * np.abs(want).max())
    np.testing.assert_allclose(ep["group_weight"].numpy(),
                               jep["group_weight"], rtol=1e-5, atol=1e-6)
