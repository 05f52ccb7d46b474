"""The port's export (tools/export_model.py) and its `torch.library` ops
on the CPU, against the live port model and the JAX package's model.

The ops: `torch.library.opcheck` of `gvcnn::stem_conv7x7s2` and
`gvcnn::group_and_fuse` (schema, fake implementation, autograd
registration, AOT dispatch) on CPU tensors, where their implementation is
the plain version, and of all six ops (the two pools' backward ops too)
with inputs that require a gradient.

The model: mn40_12view (and its MVCNN and single-view relatives) with 10
classes, cut to Mixed_3b (scoring FCN on Conv2d_2c_3x3), fp32, 32x32, 2
views, B = 2, weights seeded in the port or initialized by JAX and carried
across, BN statistics calibrated (as `tests/test_torch_eval.py` does) so
that every BN does work.  Tolerances: an artifact against the live port
model that computes the same ops on the same CPU, max abs 1e-6; against the
JAX model's `apply`, 1e-4 of max|logit| (fp32, another framework's
convolutions, as the GVCNN parity tests allow).
"""

import argparse
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.models.gvcnn import init_model  # noqa: E402
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import (  # noqa: E402
    jax_to_state_dict,
    state_dict_to_jax,
)
from gvcnn_tf_tpu_torch.checkpoint import Checkpointer  # noqa: E402
from gvcnn_tf_tpu_torch.models.gvcnn import (  # noqa: E402
    build_model,
    init_weights,
)
from gvcnn_tf_tpu_torch.tools import export_model as port_export  # noqa: E402
from gvcnn_tf_tpu_torch.tools.export_model import (  # noqa: E402
    deserialize_and_call,
    export_model,
)
from gvcnn_tf_tpu_torch.train import create_train_state  # noqa: E402
from gvcnn_tf_tpu_torch.utils import fold_batch_norm  # noqa: E402
from test_torch_gvcnn import _calibrate_bn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, V, H = 2, 2, 32
FAMILIES = {"gvcnn": ("mn40_12view", V), "mvcnn": ("mn40_12view_mvcnn", V),
            "single_view": ("mn10_single_view", 1)}
# gvcnn:: ops in each family's graph: (stem, grouping).
OPS = {"gvcnn": (1, 1), "mvcnn": (1, 0), "single_view": (1, 0)}


def _config(mod, family="gvcnn"):
    name, views = FAMILIES[family]
    cfg = mod.get_config(name)
    return cfg.replace(
        compute_dtype="float32", raw_endpoint="Conv2d_2c_3x3",
        final_endpoint="Mixed_3b",
        data=dataclasses.replace(cfg.data, num_classes=10, height=H,
                                 width=H, num_views=views, batch_size=B))


def _views(family, seed=0):
    shape = (B, FAMILIES[family][1], H, H, 3)
    x = np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)
    return x[:, 0] if family == "single_view" else x


def _variables(family):
    """Seeded port weights with calibrated BN, as JAX variables."""
    model = init_weights(build_model(_config(port_configs, family)), 3)
    _calibrate_bn(model.eval(), torch.from_numpy(_views(family, 1)),
                  np.random.RandomState(3))
    return state_dict_to_jax(model.state_dict())


def _live(family, variables, fold_bn):
    model = build_model(_config(port_configs, family))
    model.load_state_dict(jax_to_state_dict(variables))
    if fold_bn:
        fold_batch_norm(model)
    return model.eval()


@pytest.fixture(scope="module")
def exported():
    """{family: (variables, folded artifact bytes)}."""
    out = {}
    for family in FAMILIES:
        variables = _variables(family)
        out[family] = variables, export_model(
            _config(port_configs, family), state=variables, device="cpu")
    return out


def _rs_tensor(rs, shape, dtype=torch.float32):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype,epilogue", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, True)])
def test_opcheck_stem(dtype, epilogue):
    rs = np.random.RandomState(0)
    x = _rs_tensor(rs, (2, 17, 20, 3), dtype)
    w = _rs_tensor(rs, (64, 3, 7, 7), dtype) * 0.1
    affine = ((torch.rand(64) + 0.5, _rs_tensor(rs, (64,))) if epilogue
              else (None, None))
    torch.library.opcheck(torch.ops.gvcnn.stem_conv7x7s2.default,
                          (x, w, *affine, epilogue))


@pytest.mark.parametrize("num_group,mode", [(1, "mean"), (4, "ceil_sum"),
                                            (8, "mean")])
def test_opcheck_grouping(num_group, mode):
    rs = np.random.RandomState(num_group)
    scores = torch.softmax(_rs_tensor(rs, (3, 5)), -1)
    descs = _rs_tensor(rs, (3, 5, 16))
    torch.library.opcheck(torch.ops.gvcnn.group_and_fuse.default,
                          (scores, descs, num_group, mode))


def _grad_case(op, rs):
    """(the op, its arguments with every float tensor requiring a gradient)
    at small CPU shapes."""
    pool_x = _rs_tensor(rs, (2, 16, 12, 12))
    if op == "stem_conv7x7s2":
        args = (_rs_tensor(rs, (2, 17, 20, 3)),
                _rs_tensor(rs, (64, 3, 7, 7)) * 0.1, None, None, False)
    elif op == "group_and_fuse":
        args = (torch.softmax(_rs_tensor(rs, (3, 5)), -1),
                _rs_tensor(rs, (3, 5, 16)), 4, "ceil_sum")
    elif op == "max_pool_same":
        args = (pool_x, [3, 3], [2, 2], [0, 1, 0, 1], True)
    elif op == "max_pool_same_backward":
        _, slot = torch.ops.gvcnn.max_pool_same(pool_x, [3, 3], [2, 2],
                                                [0, 1, 0, 1], True)
        args = (_rs_tensor(rs, tuple(slot.shape)), slot, [12, 12], [3, 3],
                [2, 2], [0, 1, 0, 1])
    else:                                      # avg_pool_same(_backward)
        args = (pool_x,)
    return (getattr(torch.ops.gvcnn, op).default,
            tuple(a.detach().requires_grad_()
                  if isinstance(a, torch.Tensor) and a.is_floating_point()
                  else a for a in args))


@pytest.mark.parametrize("op", [
    "stem_conv7x7s2", "group_and_fuse", "max_pool_same",
    "max_pool_same_backward", "avg_pool_same", "avg_pool_same_backward"])
def test_opcheck_with_inputs_that_require_grad(op):
    """`torch.library.opcheck` of each of the six ops with float inputs that
    require a gradient, on CPU tensors: schema, fake, the registered
    autograd and, for the four forwards, AOT dispatch through that autograd
    (the two backward ops refuse a gradient of their own: the port takes no
    second derivative)."""
    fn, args = _grad_case(op, np.random.RandomState(len(op)))
    tests = ("test_schema", "test_autograd_registration", "test_faketensor")
    if not op.endswith("_backward"):
        tests += ("test_aot_dispatch_dynamic",)
    torch.library.opcheck(fn, args, test_utils=tests)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_round_trip_equals_the_live_model(exported, family):
    """The artifact, through bytes, against the live port model (folded)
    on the same views: (logits, Predictions)."""
    variables, blob = exported[family]
    x = torch.from_numpy(_views(family, 5))
    logits, probs = deserialize_and_call(blob, x)
    with torch.no_grad():
        want, ep = _live(family, variables, True)(x)
    assert tuple(logits.shape) == (B, 10)
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(probs, ep["Predictions"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("fold_bn", [True, False])
def test_jax_weights_carried_across_equal_jax_apply(fold_bn):
    """JAX-initialized weights (BN calibrated in the port) exported by the
    port give the JAX model's logits and predictions."""
    jcfg = _config(jax_configs)
    jmodel, init_vars = init_model(jcfg, jax.random.key(0), (1, V, H, H, 3))
    model = _live("gvcnn", jax.device_get(init_vars), False)
    _calibrate_bn(model, torch.from_numpy(_views("gvcnn", 1)),
                  np.random.RandomState(0))
    variables = state_dict_to_jax(model.state_dict())
    blob = export_model(_config(port_configs), state=variables,
                        fold_bn=fold_bn, device="cpu")
    x = _views("gvcnn", 6)
    logits, probs = deserialize_and_call(blob, torch.from_numpy(x))
    want, ep = jmodel.apply(variables, x, train=False)
    want = np.asarray(want)
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ep["Predictions"]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_graph_holds_the_ops(exported, family):
    """The kernels are in the exported graph as the port's ops, once per
    forward where the family runs them."""
    ep = torch.export.load(io.BytesIO(exported[family][1]))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert (targets.count("gvcnn.stem_conv7x7s2.default"),
            targets.count("gvcnn.group_and_fuse.default")) == OPS[family]
    # The stem weight goes to the op in its OIHW layout: the packing for
    # the CUDA kernel happens inside the op's implementation, not in the
    # graph.
    stem = next(n for n in ep.graph.nodes
                if str(n.target) == "gvcnn.stem_conv7x7s2.default")
    assert tuple(stem.args[1].meta["val"].shape) == (64, 3, 7, 7)


def test_child_process_that_imports_only_the_export_module(exported,
                                                           tmp_path):
    """A fresh process that imports the export module alone (which
    registers the ops) runs the artifact, without JAX."""
    variables, blob = exported["gvcnn"]
    x = _views("gvcnn", 7)
    (tmp_path / "a.pt2").write_bytes(blob)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys, numpy as np, torch\n"
        "from gvcnn_tf_tpu_torch.tools.export_model import "
        "deserialize_and_call\n"
        f"blob = open({str(tmp_path / 'a.pt2')!r}, 'rb').read()\n"
        f"x = torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))\n"
        "logits, _ = deserialize_and_call(blob, x)\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, logits.numpy())\n"
        "assert 'jax' not in sys.modules and 'gvcnn_tf_tpu' not in "
        "sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with torch.no_grad():
        want = _live("gvcnn", variables, True)(torch.from_numpy(x))[0]
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"), want.numpy(),
                               rtol=0, atol=1e-6)


def test_no_fold_bn_keeps_the_statistics(exported):
    """`fold_bn=False`: the artifact holds the unfolded BN statistics and
    equals the live unfolded model; the folded one holds var = 1 - eps."""
    variables, folded = exported["gvcnn"]
    blob = export_model(_config(port_configs), state=variables,
                        fold_bn=False, device="cpu")
    key = "model.InceptionV1.Conv2d_2b_1x1.BatchNorm.running_var"
    state = {fold: torch.export.load(io.BytesIO(b)).state_dict
             for fold, b in ((True, folded), (False, blob))}
    want = jax_to_state_dict(variables)[key.removeprefix("model.")]
    torch.testing.assert_close(state[False][key], want, rtol=0, atol=0)
    torch.testing.assert_close(state[True][key],
                               torch.full_like(want, 1 - 1e-3))
    x = torch.from_numpy(_views("gvcnn", 8))
    with torch.no_grad():
        live = _live("gvcnn", variables, False)(x)[0]
    torch.testing.assert_close(deserialize_and_call(blob, x)[0], live,
                               rtol=0, atol=1e-6)


def test_export_from_a_train_state_leaves_it_alone():
    """A `TrainState` exports its own model's weights, folded on a copy:
    the state's model keeps its weights and its train mode."""
    cfg = _config(port_configs)
    state = create_train_state(cfg, "cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    blob = export_model(cfg, state=state, device="cpu")
    assert state.model.training
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    x = torch.from_numpy(_views("gvcnn", 9))
    live = build_model(cfg)
    live.load_state_dict(before)
    with torch.no_grad():
        want = fold_batch_norm(live).eval()(x)[0]
    torch.testing.assert_close(deserialize_and_call(blob, x)[0], want,
                               rtol=0, atol=1e-6)


def test_cli_writes_the_artifact(tmp_path, capsys):
    """The CLI exports the newest checkpoint under --checkpoint_dir at
    --export_batch_size into --output (the whole Inception-v1, bf16 as the
    config has it, 32x32, 2 views)."""
    argv = ["--config", "mn40_12view", "--num_views", str(V), "--height",
            str(H), "--width", str(H), "--num_classes", "10"]
    cfg = port_configs.config_from_flags(
        port_configs.add_flags(argparse.ArgumentParser()).parse_args(argv))
    weights = init_weights(build_model(cfg), 3).state_dict()
    Checkpointer(str(tmp_path / "ckpt")).save(3, {"step": 3,
                                                  "model": weights})
    out = tmp_path / "gvcnn.pt2"
    port_export.main(argv + [
        "--checkpoint_dir", str(tmp_path / "ckpt"), "--output", str(out),
        "--export_batch_size", "3", "--device", "cpu"])
    blob = out.read_bytes()
    assert f"wrote {len(blob)} bytes to {out}" in capsys.readouterr().out
    x = torch.from_numpy(np.random.RandomState(4).uniform(
        -1, 1, (3, V, H, H, 3)).astype(np.float32))
    logits, _ = deserialize_and_call(blob, x)
    live = build_model(cfg)
    live.load_state_dict(weights)
    with torch.no_grad():
        want = fold_batch_norm(live).cast_convs_().eval()(x)[0]
    assert tuple(logits.shape) == (3, 10)      # the flag's batch
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-6)


def test_cli_refuses_the_card_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="never falls back"):
        port_export.main(["--output", str(tmp_path / "x.pt2"),
                          "--checkpoint_dir", str(tmp_path)])
