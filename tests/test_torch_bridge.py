"""The weight bridge, the config copy and the port's import hygiene.

JAX init -> numpy -> port state_dict -> numpy round-trips exactly; the
port's configs and flags equal the JAX package's; importing the port, and
reading an Orbax checkpoint with it, never imports JAX, Orbax or the JAX
package.
"""

import argparse
import dataclasses
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
from gvcnn_tf_tpu_torch.models.gvcnn import build_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def jax_variables():
    cfg = jax_configs.get_config("mn40_12view")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, height=32, width=32))
    _, variables = init_model(cfg, jax.random.key(0), (1, 12, 32, 32, 3))
    variables = jax.device_get(variables)
    # Non-trivial statistics, so the round trip covers batch_stats values.
    rs = np.random.RandomState(0)
    variables["batch_stats"] = jax.tree.map(
        lambda a: rs.uniform(0.5, 2.0, a.shape).astype(a.dtype),
        variables["batch_stats"])
    return variables


def test_round_trip_is_exact(jax_variables):
    port = build_model(port_configs.get_config("mn40_12view"))
    sd = jax_to_state_dict(jax_variables)
    port.load_state_dict(sd)              # strict: every name and shape fits
    back = state_dict_to_jax(port.state_dict())
    want, got = dict(_flat(jax_variables)), dict(_flat(back))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("jax_path,port_key,port_shape", [
    ("params/InceptionV1/Mixed_3b/Branch_1_Conv2d_0b_3x3/conv/kernel",
     "InceptionV1.Mixed_3b.Branch_1_Conv2d_0b_3x3.conv.weight",
     (128, 96, 3, 3)),
    ("params/InceptionV1/Conv2d_1a_7x7/conv/kernel",
     "InceptionV1.Conv2d_1a_7x7.conv.weight", (64, 3, 7, 7)),
    ("batch_stats/InceptionV1/Mixed_5c/Branch_0_Conv2d_0a_1x1/BatchNorm/var",
     "InceptionV1.Mixed_5c.Branch_0_Conv2d_0a_1x1.BatchNorm.running_var",
     (384,)),
    ("params/GroupingModule/Conv2d_score_logit/kernel",
     "GroupingModule.Conv2d_score_logit.weight", (1, 128, 1, 1)),
    ("params/GroupingModule/Conv2d_score_logit/bias",
     "GroupingModule.Conv2d_score_logit.bias", (1,)),
    ("params/Logits/kernel", "Logits.weight", (40, 1024)),
])
def test_path_mapping(jax_variables, jax_path, port_key, port_shape):
    sd = jax_to_state_dict(jax_variables)
    assert tuple(sd[port_key].shape) == port_shape
    a = dict(_flat(jax_variables))[jax_path]
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 2:
        a = a.T
    np.testing.assert_array_equal(sd[port_key].numpy(), a)


@pytest.mark.parametrize("name", sorted(jax_configs.CONFIGS))
def test_configs_equal_jax(name):
    assert set(port_configs.CONFIGS) == set(jax_configs.CONFIGS)
    assert (dataclasses.asdict(port_configs.get_config(name))
            == dataclasses.asdict(jax_configs.get_config(name)))


def test_config_defaults_equal_jax():
    for cls in ("GVCNNConfig", "DataConfig", "TrainConfig"):
        assert (dataclasses.asdict(getattr(port_configs, cls)())
                == dataclasses.asdict(getattr(jax_configs, cls)())), cls


def _actions(mod):
    p = mod.add_flags(argparse.ArgumentParser())
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, a.const) for a in p._actions}


def test_flags_equal_jax():
    assert _actions(port_configs) == _actions(jax_configs)


@pytest.mark.parametrize("argv", [
    [],
    ["--config", "mn10_8view", "--num_views", "4", "--height", "64"],
    ["--group_weight", "ceil_sum", "--score_squash", "sigmoid",
     "--stem_pallas", "--seed", "3", "--checkpoint_exclude_scopes", "a,b"],
])
def test_config_from_flags_equal_jax(argv):
    def parse(mod):
        args = mod.add_flags(argparse.ArgumentParser()).parse_args(argv)
        return dataclasses.asdict(mod.config_from_flags(args))

    assert parse(port_configs) == parse(jax_configs)


def test_port_never_imports_jax(tmp_path):
    """Importing the port (its tools too), and reading an Orbax checkpoint
    of the JAX package with it, imports neither JAX, Orbax nor the JAX
    package."""
    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(str(tmp_path / "orbax"), {
            "params": {"Logits": {"kernel": np.ones((4, 2), np.float32)}},
            "batch_stats": {"A": {"mean": np.zeros(3, np.float32)}}})
    code = ("import sys, gvcnn_tf_tpu_torch, gvcnn_tf_tpu_torch.serve, "
            "gvcnn_tf_tpu_torch.train, gvcnn_tf_tpu_torch.checkpoint, "
            "gvcnn_tf_tpu_torch.data, gvcnn_tf_tpu_torch.eval, "
            "gvcnn_tf_tpu_torch.predict, gvcnn_tf_tpu_torch.data.procedural, "
            "gvcnn_tf_tpu_torch.tools.render_meshes, "
            "gvcnn_tf_tpu_torch.tools.make_demo_meshes, "
            "gvcnn_tf_tpu_torch.tools.import_slim_checkpoint, "
            "gvcnn_tf_tpu_torch.tools.export_model, "
            "gvcnn_tf_tpu_torch.tools.loadgen, "
            "gvcnn_tf_tpu_torch.tools.retrieval, "
            "gvcnn_tf_tpu_torch.tools.proc_benchmark, "
            "gvcnn_tf_tpu_torch.parallel, "
            "gvcnn_tf_tpu_torch.parallel.collectives; "
            "from gvcnn_tf_tpu_torch.checkpoint import read_orbax; "
            f"t = read_orbax({str(tmp_path / 'orbax')!r}); "
            "assert t['params']['Logits']['kernel'].sum() == 8, t; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert 'orbax' not in sys.modules, 'orbax'; "
            "assert 'gvcnn_tf_tpu' not in sys.modules, 'gvcnn_tf_tpu'")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
