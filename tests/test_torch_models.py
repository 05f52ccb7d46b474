"""The port's three model families and the swapped backbones against the JAX
package's, on the CPU at fp32.

- GVCNN on ResNet-50 and on Inception-v4 (their named configs), MVCNN and
  the single-view classifier (Inception-v1), full depth, B = 2: the end
  points (`Logits`, `Predictions`, the view and shape descriptors, and for
  GVCNN the scores, the exact group scheme and the group weights) against
  JAX's, within 1e-4 of each tensor's max, weights drawn in the port and
  BatchNorm calibrated as `tests/test_torch_backbones.py` does, bridged to
  JAX.  Sizes: 48x48 (ResNet-50, Inception-v1; 3 views), 107x107 for v4
  (1 shape of 3 views; see that file for why 107).
- `--backbone` on the flagship config lands on each backbone's endpoints as
  JAX's `_resolve_endpoints` does (v1 and v3 both have a `Mixed_5c`).
- `build_model` builds every named config but the 8-device one, which it
  refuses with its ROADMAP item; end-point shapes of every config at full
  width on the `meta` device; `init_weights` follows each family's
  initializers; `cast_convs_` casts every conv of every family.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.models import gvcnn as jax_gvcnn  # noqa: E402
from gvcnn_tf_tpu.models.backbones import (  # noqa: E402
    get_backbone as jax_get_backbone,
)
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import state_dict_to_jax  # noqa: E402
from gvcnn_tf_tpu_torch.models.backbones import BACKBONES  # noqa: E402
from gvcnn_tf_tpu_torch.models.backbones.layers import (  # noqa: E402
    TRUNC_STDDEV,
    BatchNorm,
)
from gvcnn_tf_tpu_torch.models.gvcnn import (  # noqa: E402
    GVCNN,
    MVCNN,
    SingleViewClassifier,
    build_model,
    init_weights,
)
from test_torch_backbones import assert_close_rel, calibrate_bn  # noqa: E402

# config -> (size, views, batch)
CASES = {
    "mn40_12view_resnet50": (48, 3, 2),
    "mn40_12view_inception_v4": (107, 3, 1),
    "mn40_12view_mvcnn": (48, 3, 2),
    "mn10_single_view": (48, 1, 2),
}


def _config(mod, name):
    hw, v, b = CASES[name]
    cfg = mod.get_config(name)
    return cfg.replace(compute_dtype="float32", data=dataclasses.replace(
        cfg.data, height=hw, width=hw, num_views=v, batch_size=b))


_PAIRS = {}


def model_pair(name):
    """(JAX end points, port end points) of config `name`, one calibrated
    port model, one jitted JAX forward."""
    if name not in _PAIRS:
        hw, v, b = CASES[name]
        rs = np.random.RandomState(len(name))
        x = rs.uniform(-1, 1, (b, v, hw, hw, 3)).astype(np.float32)
        port = build_model(_config(port_configs, name))
        calibrate_bn(port, torch.from_numpy(x), rs)
        with torch.no_grad():
            _, pep = port(torch.from_numpy(x))
        jm = jax_gvcnn.build_model(_config(jax_configs, name))
        _, jep = jax.jit(functools.partial(jm.apply, train=False))(
            state_dict_to_jax(port.state_dict()), x)
        _PAIRS[name] = (jax.device_get(jep),
                        {k: t.numpy() for k, t in pep.items()})
    return _PAIRS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_end_points_match_jax(name):
    jep, pep = model_pair(name)
    assert set(pep) == set(jep)
    if "group_scheme" in jep:
        # Compared exactly: every score must be clear of the j/M edges.
        edges = np.arange(1, 8) / 8
        assert np.abs(jep["view_discrimination_scores"][..., None]
                      - edges).min() > 1e-5
        np.testing.assert_array_equal(pep["group_scheme"],
                                      jep["group_scheme"])
    for k in jep:
        if k != "group_scheme":
            assert_close_rel(pep[k], jep[k], msg=f"{name} {k}")


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_backbone_flag_resolves_endpoints_as_jax(backbone):
    jcfg = jax_configs.get_config("mn40_12view").replace(backbone=backbone)
    pcfg = port_configs.get_config("mn40_12view").replace(backbone=backbone)
    want = jax_gvcnn._resolve_endpoints(jcfg, jax_get_backbone(backbone))
    with torch.device("meta"):
        model = build_model(pcfg)
    assert (model.raw_endpoint, model.final_endpoint) == want
    assert type(model.backbone) is BACKBONES[backbone]
    assert model.Logits.in_features == BACKBONES[backbone].DESCRIPTOR_DIM


FAMILY = {"mn10_single_view": SingleViewClassifier, "mn10_8view": GVCNN,
          "mn40_12view": GVCNN, "mn40_12view_inception_v4": GVCNN,
          "mn40_12view_resnet50": GVCNN, "mn40_12view_mvcnn": MVCNN,
          "mn40_12view_dp8": GVCNN}


@pytest.mark.parametrize("name", sorted(port_configs.CONFIGS))
def test_build_model_builds_every_config(name):
    cfg = port_configs.get_config(name)
    with torch.device("meta"):
        model = build_model(cfg)
    assert type(model) is FAMILY[name]
    d = cfg.data
    x = torch.empty((d.batch_size, d.num_views, d.height, d.width, 3),
                    device="meta")
    logits, ep = model.eval()(x)
    assert logits.shape == (d.batch_size, d.num_classes)
    dim = type(model.backbone).DESCRIPTOR_DIM
    if type(model) is SingleViewClassifier:
        assert set(ep) == {"Logits", "Predictions"}
        return
    assert ep["view_descriptors"].shape == (d.batch_size, d.num_views, dim)
    assert ep["shape_descriptor"].shape == (d.batch_size, dim)
    assert ("view_discrimination_scores" in ep) == (type(model) is GVCNN)
    # The state_dict keys start with the backbone's Flax scope.
    top = {k.split(".")[0] for k in model.state_dict()}
    assert type(model.backbone).NAME in top


@pytest.mark.parametrize("name,init", [("mn40_12view_resnet50", "lecun"),
                                       ("mn10_single_view", "trunc")])
def test_init_weights_follows_the_family(name, init):
    cfg = port_configs.get_config(name)
    model = init_weights(build_model(cfg), 0)
    conv = (model.backbone.block3_unit1.conv2.conv if init == "lecun"
            else model.backbone.Mixed_4b.Branch_1_Conv2d_0b_3x3.conv)
    w = conv.weight.detach()
    want = w[0].numel() ** -0.5 if init == "lecun" else TRUNC_STDDEV
    assert float(w.std()) == pytest.approx(want, rel=0.05)
    assert float(w.abs().max()) <= 2 * want / 0.8796 + 1e-6
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert all(torch.equal(m.running_var, torch.ones_like(m.running_var))
               and not m.bias.any() for m in bns)
    scaled = [m for m in bns if m.scale is not None]
    assert bool(scaled) == (init == "lecun")
    assert all(torch.equal(m.scale, torch.ones_like(m.scale))
               for m in scaled)
    lw = model.Logits.weight.detach()
    assert float(lw.std()) == pytest.approx(lw.shape[1] ** -0.5, rel=0.1)


@pytest.mark.parametrize("name", ["mn40_12view_resnet50",
                                  "mn40_12view_mvcnn", "mn10_single_view"])
def test_cast_convs_casts_every_conv(name):
    cfg = port_configs.get_config(name).replace(compute_dtype="bfloat16")
    with torch.device("meta"):
        model = build_model(cfg).cast_convs_()
    convs = {f"{k}.{n}" for k, m in model.named_modules()
             if isinstance(m, torch.nn.Conv2d) for n, _ in
             m.named_parameters()}
    assert convs
    for k, p in model.named_parameters():
        assert p.dtype == (torch.bfloat16 if k in convs
                           else torch.float32), k


def test_single_view_takes_one_view():
    model = build_model(_config(port_configs, "mn10_single_view")).eval()
    x = torch.zeros((2, 2, 48, 48, 3))
    with pytest.raises(ValueError, match="one view"):
        model(x)
    with torch.no_grad():
        a = model(torch.zeros((2, 48, 48, 3)))[0]
        b = model(torch.zeros((2, 1, 48, 48, 3)))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mvcnn_pools_with_an_elementwise_max():
    jep, pep = model_pair("mn40_12view_mvcnn")
    np.testing.assert_array_equal(pep["shape_descriptor"],
                                  pep["view_descriptors"].max(axis=1))
    assert jnp.asarray(jep["shape_descriptor"]).shape == (2, 1024)
