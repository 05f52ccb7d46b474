"""Warm start (`checkpoint.warm_start`, `train --checkpoint_path`) and the
slim importer (`tools/import_slim_checkpoint.py`) against the JAX
package's, on the CPU.

- `warm_start` on the same numpy trees as the JAX `warm_start`: the same
  tree, leaf for leaf, or a ValueError in both (exclusion by prefix, a
  scope the model lacks, one the checkpoint lacks, another shape, another
  structure).
- `train()` warm-started from an Orbax directory written by Orbax, holding
  a 17-class `Logits` (the model has 10), with the default exclude scopes:
  mn40_12view cut to Mixed_3b, fp32, 32x32, 2 views, B = 4, dropout off.
  The port's model starts from the JAX init (`create_train_state` patched
  to load it), so after the warm start every tensor equals the JAX
  `train(num_steps=0)` state bit for bit through the bridge; one step
  agrees as `tests/test_torch_train.py`'s steps do (loss and grad_norm
  rtol 1e-4, parameters rtol 1e-4 / atol 1e-5).  Without the patch the
  excluded scopes keep the port's own seeded init.  A params-only
  checkpoint warm-starts the parameters alone.
- A real `tf.compat.v1` `Saver` checkpoint with slim's names (full
  Inception-v1, an 11-class head), through both importers: the same tree
  bit for bit, the port's Inception-v1 logits within 1e-5 of max of the
  JAX backbone's on the JAX importer's output, and `train --checkpoint_path`
  on the port importer's output copies every included tensor exactly.
"""

import dataclasses
import functools
import importlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_intra_op_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
pytest.importorskip("tensorstore")

import jax.numpy as jnp  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402

from gvcnn_tf_tpu import configs as jax_configs  # noqa: E402
from gvcnn_tf_tpu.checkpoint import warm_start as jax_warm_start  # noqa: E402
from gvcnn_tf_tpu.models.backbones.inception_v1 import (  # noqa: E402
    InceptionV1Base as JaxInceptionV1Base,
)
from gvcnn_tf_tpu.models.gvcnn import init_model  # noqa: E402
from gvcnn_tf_tpu.tools import import_slim_checkpoint as jax_slim  # noqa: E402
from gvcnn_tf_tpu_torch import configs as port_configs  # noqa: E402
from gvcnn_tf_tpu_torch.bridge import (  # noqa: E402
    jax_to_state_dict,
    state_dict_to_jax,
)
from gvcnn_tf_tpu_torch.checkpoint import Checkpointer, warm_start  # noqa: E402
from gvcnn_tf_tpu_torch.models.backbones import get_backbone  # noqa: E402
from gvcnn_tf_tpu_torch.models.gvcnn import build_model  # noqa: E402
from gvcnn_tf_tpu_torch.tools import import_slim_checkpoint as port_slim  # noqa: E402

jax_train = importlib.import_module("gvcnn_tf_tpu.train")
port_train = importlib.import_module("gvcnn_tf_tpu_torch.train")

V, H, B = 2, 32, 4
PRE_CLASSES, SLIM_CLASSES = 17, 11


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_same(got, want, rtol=0.0, atol=0.0):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    for k, a in want.items():
        assert got[k].shape == a.shape, k
        np.testing.assert_allclose(got[k], a, rtol=rtol, atol=atol,
                                   err_msg=str(k))


def _config(mod, logdir="", checkpoint_path="", num_classes=10, **train_kw):
    cfg = mod.get_config("mn40_12view")
    return cfg.replace(
        compute_dtype="float32", dropout_keep_prob=1.0, num_devices=1,
        raw_endpoint="Conv2d_2c_3x3", final_endpoint="Mixed_3b",
        data=dataclasses.replace(cfg.data, height=H, width=H, num_views=V,
                                 batch_size=B, num_classes=num_classes),
        train=dataclasses.replace(
            cfg.train, train_logdir=str(logdir), learning_rate=0.01,
            checkpoint_path=str(checkpoint_path), log_every=1,
            **{"checkpoint_every": 0, **train_kw}))


def _variables(state):
    return jax.device_get({"params": state.params,
                           "batch_stats": state.batch_stats})


def _port_variables(state):
    return state_dict_to_jax(state.model.state_dict())


def _save_orbax(directory, tree):
    mgr = ocp.CheckpointManager(
        str(directory), options=ocp.CheckpointManagerOptions(create=True))
    mgr.save(0, args=ocp.args.StandardSave(tree))
    mgr.wait_until_finished()
    mgr.close()


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """Orbax directories of a 17-class model's variables, shifted from its
    init so they differ from any fresh one: params and BN statistics
    ("full"), params alone ("params_only")."""
    root = tmp_path_factory.mktemp("pretrained")
    cfg = _config(jax_configs, num_classes=PRE_CLASSES)
    _, init = init_model(cfg, jax.random.key(123), (1, V, H, H, 3))
    rs = np.random.RandomState(7)
    tree = {"params": jax.tree.map(
        lambda a: (np.asarray(a) + rs.normal(0, 0.05, a.shape)).astype(
            np.float32), init["params"]),
        "batch_stats": jax.tree.map(
            lambda a: rs.uniform(0.5, 2.0, a.shape).astype(np.float32),
            init["batch_stats"])}
    _save_orbax(root / "full", tree)
    _save_orbax(root / "params_only", {"params": tree["params"]})
    return dict(tree=tree, full=str(root / "full"),
                params_only=str(root / "params_only"))


@pytest.fixture
def jax_init_in_port(monkeypatch):
    """Make the port's `train()` start from the JAX `train()`'s init (its
    `init_rng`), so every tensor can be compared after the warm start."""
    real = port_train.create_train_state

    def create(config, device="cuda", world=None):
        state = real(config, device, world)
        init_rng, _ = jax.random.split(jax.random.key(config.train.seed))
        jcfg = _config(jax_configs, num_classes=config.data.num_classes)
        _, _, jstate = jax_train.create_train_state(jcfg, init_rng)
        state.model.load_state_dict(jax_to_state_dict(_variables(jstate)))
        return state

    monkeypatch.setattr(port_train, "create_train_state", create)


def _both(tmp_path, checkpoint_path, num_steps, batches=()):
    """(JAX state, JAX metrics, port state, port metrics) of `train()`
    warm-started from `checkpoint_path` over `batches`."""
    jstate, jm = jax_train.train(
        _config(jax_configs, tmp_path / "jax", checkpoint_path),
        num_steps=num_steps, dataset_iter=iter(list(batches)))
    pstate, pm = port_train.train(
        _config(port_configs, tmp_path / "port", checkpoint_path),
        num_steps=num_steps, dataset_iter=iter(list(batches)), device="cpu")
    return jstate, jm, pstate, pm


def test_warm_start_equals_jax_before_any_step(pretrained, tmp_path,
                                               jax_init_in_port):
    jstate, _, pstate, _ = _both(tmp_path, pretrained["full"], 0)
    want, got = _variables(jstate), _port_variables(pstate)
    _assert_same(got, want)                      # every tensor, bit for bit
    for c in ("params", "batch_stats"):
        _assert_same(got[c]["InceptionV1"],
                     pretrained["tree"][c]["InceptionV1"])
    assert got["params"]["Logits"]["kernel"].shape == (256, 10)  # Mixed_3b


def test_one_warm_started_step_tracks_jax(pretrained, tmp_path,
                                          jax_init_in_port):
    rs = np.random.RandomState(2)
    batch = {"views": rs.uniform(-1, 1, (B, V, H, H, 3)).astype(np.float32),
             "label": rs.randint(0, 10, B).astype(np.int32)}
    jstate, jm, pstate, pm = _both(tmp_path, pretrained["full"], 1, [batch])
    assert pstate.step == int(jstate.step) == 1
    for k in ("loss", "grad_norm", "accuracy"):
        assert pm[k] == pytest.approx(float(jm[k]), rel=1e-4), k
    _assert_same(_port_variables(pstate), _variables(jstate), rtol=1e-4,
                 atol=1e-5)


def test_params_only_checkpoint_warm_starts_the_params(pretrained, tmp_path,
                                                       jax_init_in_port):
    jstate, _, pstate, _ = _both(tmp_path, pretrained["params_only"], 0)
    got = _port_variables(pstate)
    _assert_same(got, _variables(jstate))
    _assert_same(got["params"]["InceptionV1"],
                 pretrained["tree"]["params"]["InceptionV1"])
    assert not np.array_equal(
        got["batch_stats"]["InceptionV1"]["Conv2d_1a_7x7"]["BatchNorm"]["var"],
        pretrained["tree"]["batch_stats"]["InceptionV1"]["Conv2d_1a_7x7"][
            "BatchNorm"]["var"])


def test_excluded_scopes_keep_the_ports_own_init(pretrained, tmp_path):
    cfg = _config(port_configs, tmp_path, pretrained["full"])
    state, _ = port_train.train(cfg, num_steps=0, dataset_iter=iter(()),
                                device="cpu")
    got = _port_variables(state)
    fresh = _port_variables(port_train.create_train_state(cfg, "cpu"))
    for c in ("params", "batch_stats"):
        _assert_same(got[c]["InceptionV1"],
                     pretrained["tree"][c]["InceptionV1"])
    for scope in ("Logits", "GroupingModule"):
        _assert_same(got["params"][scope], fresh["params"][scope])


def test_missing_checkpoint_path_raises(tmp_path):
    cfg = _config(port_configs, tmp_path, tmp_path / "nonexistent")
    with pytest.raises(FileNotFoundError):
        port_train.train(cfg, num_steps=1, device="cpu")


def test_warm_start_from_a_port_run_and_resume_wins(tmp_path):
    """From the port's own training checkpoints (GroupingModule included);
    then a run that resumes from its train_logdir with the same
    checkpoint_path is the same run: it resumes (the checkpoint wins over
    the warm start) and ends bit for bit where an uninterrupted run ends
    (dropout on)."""
    src, _ = port_train.train(_config(port_configs, tmp_path / "src",
                                      checkpoint_every=2),
                              num_steps=2, device="cpu")

    def cfg(name):
        return _config(port_configs, tmp_path / name, tmp_path / "src",
                       checkpoint_every=2,
                       checkpoint_exclude_scopes=("Logits",)).replace(
            dropout_keep_prob=0.8)

    first, _ = port_train.train(cfg("b"), num_steps=0, device="cpu")
    got, want = _port_variables(first), _port_variables(src)
    for scope in ("InceptionV1", "GroupingModule"):
        _assert_same(got["params"][scope], want["params"][scope])
    _assert_same(got["batch_stats"], want["batch_stats"])
    whole, _ = port_train.train(cfg("a"), num_steps=4, device="cpu")
    port_train.train(cfg("b"), num_steps=2, device="cpu")
    resumed, _ = port_train.train(cfg("b"), num_steps=4, device="cpu")
    assert resumed.step == whole.step == 4
    _assert_same(_port_variables(resumed), _port_variables(whole))


# ------------------------------------------------------------ warm_start

def _tree(rs, classes=10, extra=None):
    t = {"InceptionV1": {"Conv2d_1a_7x7": {
            "conv": {"kernel": rs.randn(7, 7, 3, 4).astype(np.float32)},
            "BatchNorm": {"bias": rs.randn(4).astype(np.float32)}}},
         "GroupingModule": {"Conv2d_score_logit": {
             "kernel": rs.randn(1, 1, 4, 1).astype(np.float32)}},
         "Logits": {"kernel": rs.randn(4, classes).astype(np.float32),
                    "bias": rs.randn(classes).astype(np.float32)}}
    t.update(extra or {})
    return t


WARM_CASES = {
    "everything": (dict(), ()),
    "default_excludes": (dict(), ("Logits", "GroupingModule")),
    "prefix": (dict(), ("Incep", "Grou")),
    "scope_the_model_lacks": (dict(extra={"AuxLogits": {
        "kernel": np.ones((2, 2), np.float32)}}), ()),
    "other_head_excluded": (dict(classes=1001), ("Logits",)),
    "other_head": (dict(classes=1001), ()),
    "other_structure": ("drop_leaf", ()),
}


@pytest.mark.parametrize("case", list(WARM_CASES))
def test_warm_start_equals_jax(case):
    kw, exclude = WARM_CASES[case]
    init = _tree(np.random.RandomState(0))
    if kw == "drop_leaf":
        pre = _tree(np.random.RandomState(1))
        del pre["InceptionV1"]["Conv2d_1a_7x7"]["BatchNorm"]
    else:
        pre = _tree(np.random.RandomState(1), **kw)
    if case == "scope_the_model_lacks":
        del pre["GroupingModule"]
    try:
        want = jax_warm_start(init, pre, exclude)
    except ValueError as e:
        with pytest.raises(ValueError) as got_err:
            warm_start(init, pre, exclude)
        # "warm-start shape mismatch in scope 'Logits'" in both.
        assert str(got_err.value).split(":")[0] == str(e).split(":")[0]
        return
    got = warm_start(init, pre, exclude)
    assert list(got) == list(want)
    for scope in want:
        assert got[scope] is want[scope], scope    # the same subtree copied


# ---------------------------------------------------------------- slim

def _write_slim_ckpt(tf, directory):
    """A genuine tf.compat.v1 Saver checkpoint with slim's names and
    shapes (the port's list), seeded values."""
    tf1 = tf.compat.v1
    rs = np.random.RandomState(0)
    values = {}
    graph = tf.Graph()
    with graph.as_default():
        for name, shape in port_slim.slim_variable_shapes(SLIM_CLASSES):
            if name.endswith("moving_variance"):
                init = rs.rand(*shape).astype(np.float32) + 0.5
            else:
                init = (rs.randn(*shape) * 0.1).astype(np.float32)
            values[name] = init
            tf1.get_variable(name, initializer=init)
        saver = tf1.train.Saver()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            path = saver.save(sess, str(directory / "inception_v1.ckpt"))
    return path, values


@pytest.fixture(scope="module")
def slim(tmp_path_factory):
    tf = pytest.importorskip("tensorflow")
    root = tmp_path_factory.mktemp("slim")
    path, values = _write_slim_ckpt(tf, root)
    jax_slim.main(["--slim_checkpoint", path, "--output_dir",
                   str(root / "jax")])
    port_slim.main(["--slim_checkpoint", path, "--output_dir",
                    str(root / "port")])
    return dict(path=path, values=values, jax=str(root / "jax"),
                port=str(root / "port"))


def test_slim_checkpoint_reads_as_the_jax_importer_reads_it(slim):
    got = port_slim.read_tf_checkpoint(slim["path"])
    assert set(got) == set(slim["values"])
    for name, a in slim["values"].items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)
    want = jax_slim.convert_slim_vars(jax_slim.read_tf_checkpoint(
        slim["path"]))
    tree = port_slim.convert_slim_vars(got)
    _assert_same(tree, want)
    assert tree["params"]["Logits"]["kernel"].shape == (1024, SLIM_CLASSES)
    payload = Checkpointer(slim["port"]).restore()
    assert payload["step"] == 0 and Checkpointer(slim["port"]).steps() == [0]
    _assert_same(_numpy_tree(payload["variables"]), tree)


def test_slim_logits_equal_the_jax_backbones(slim):
    """Full Inception-v1 + the 11-class head, fp32, 64x64, B = 2: the port
    on its importer's output, JAX on its importer's (Orbax) output."""
    mgr = ocp.CheckpointManager(slim["jax"])
    jtree = jax.device_get(mgr.restore(0, args=ocp.args.StandardRestore()))
    mgr.close()
    x = (np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
         * 2.0 - 1.0)
    jmodel = JaxInceptionV1Base(dtype=jnp.float32)
    feats, _ = jax.jit(functools.partial(jmodel.apply, train=False))(
        {c: jtree[c]["InceptionV1"] for c in ("params", "batch_stats")}, x)
    want = (np.asarray(jnp.mean(feats, axis=(1, 2)))
            @ jtree["params"]["Logits"]["kernel"]
            + jtree["params"]["Logits"]["bias"])

    ptree = _numpy_tree(Checkpointer(slim["port"]).restore()["variables"])
    backbone = get_backbone("inception_v1")().eval()
    backbone.load_state_dict(jax_to_state_dict(
        {c: ptree[c]["InceptionV1"] for c in ("params", "batch_stats")}))
    with torch.no_grad():
        feats, _ = backbone(torch.from_numpy(x))
    got = (feats.mean(dim=(2, 3)).numpy() @ ptree["params"]["Logits"]["kernel"]
           + ptree["params"]["Logits"]["bias"])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


def test_train_warm_starts_from_the_port_importer(slim, tmp_path):
    """`train --checkpoint_path <port importer output>` on the cut model:
    every Inception-v1 tensor it has is the slim array, bit for bit; the
    11-class `Logits` is excluded by default."""
    cfg = _config(port_configs, tmp_path, slim["port"])
    state, _ = port_train.train(cfg, num_steps=0, dataset_iter=iter(()),
                                device="cpu")
    got = dict(_flat(_port_variables(state)))
    copied = 0
    for name, a in slim["values"].items():
        coll, path = port_slim.slim_name_to_flax_path(name)
        if path[0] == "InceptionV1" and (coll,) + path in got:
            np.testing.assert_array_equal(got[(coll,) + path], a,
                                          err_msg=name)
            copied += 1
    assert copied == sum(k[1] == "InceptionV1" for k in got)
    fresh = _port_variables(port_train.create_train_state(cfg, "cpu"))
    _assert_same({k: v for k, v in got.items() if k[1] != "InceptionV1"},
                 {k: v for k, v in _flat(fresh) if k[1] != "InceptionV1"})


def _slim_names():
    names = [n for n, _ in port_slim.slim_variable_shapes()]
    slots = [f"{n}/{s}" for n in names[:8]
             for s in ("Momentum", "RMSProp", "Adam", "Adam_1",
                       "ExponentialMovingAverage")]
    aux = ["InceptionV1/AuxLogits/Conv2d_0b_1x1/weights",
           "InceptionV1/AuxLogits/Conv2d_0b_1x1/BatchNorm/beta",
           "global_step", "InceptionV1/Logits/Conv2d_0c_1x1/weights:0"]
    return names + slots + aux


def test_slim_name_map_is_the_jax_packages():
    """Every name of the full v1 list, the optimizer slots and AuxLogits:
    the same (collection, path) or KeyError in both."""
    raised = 0
    for name in _slim_names():
        try:
            want = jax_slim.slim_name_to_flax_path(name)
        except KeyError:
            with pytest.raises(KeyError):
                port_slim.slim_name_to_flax_path(name)
            raised += 1
            continue
        assert port_slim.slim_name_to_flax_path(name) == want, name
    assert raised == 43


def test_slim_variable_shapes_fit_the_ports_inception_v1():
    """The importer's list, converted, has the shapes of every Inception-v1
    parameter and statistic of the full mn40_12view model."""
    rs = np.random.RandomState(0)
    slim_vars = {n: rs.randn(*s).astype(np.float32)
                 for n, s in port_slim.slim_variable_shapes(40)}
    tree = port_slim.convert_slim_vars(slim_vars)
    _assert_same(tree, jax_slim.convert_slim_vars(slim_vars))
    with torch.device("meta"):
        model = build_model(port_configs.get_config("mn40_12view"))
    sd = jax_to_state_dict(tree)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.startswith("GroupingModule")}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


def test_read_tf_checkpoint_without_tensorflow_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="`tensorflow` package"):
        port_slim.read_tf_checkpoint("/nonexistent/inception_v1.ckpt")
