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
summed in another order by XLA:CPU and oneDNN.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
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
)
from gvcnn_tf_tpu_torch.models.gvcnn import build_model  # noqa: E402
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

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.bias.copy_(torch.from_numpy(
                rs.normal(0, 0.1, m.bias.shape).astype(np.float32)))
            handles.append(m.register_forward_pre_hook(hook))
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
    cfg = port_configs.get_config("mn40_12view")
    for bad, what in [
        (cfg.replace(stem_space_to_depth=True), "stem_space_to_depth"),
        (cfg.replace(remat_until="MaxPool_3a_3x3"), "remat"),
        (port_configs.get_config("mn40_12view_mvcnn"), "MVCNN"),
        (port_configs.get_config("mn10_single_view"), "single-view"),
        (port_configs.get_config("mn40_12view_resnet50"), "resnet50"),
    ]:
        with pytest.raises(NotImplementedError, match=what):
            build_model(bad)


def test_bn_training_mode_raises():
    model = build_model(_config(port_configs))  # modules start in train mode
    with pytest.raises(NotImplementedError, match="training mode"):
        model(torch.zeros((1, V, H, H, 3)))
