"""The port's data-parallel layer (`gvcnn_tf_tpu_torch/parallel/`), its
sharded input, BatchNorm's global statistics, multi-process evaluation and
the training loop over several ranks, on the CPU.

Ranks are real processes: `parallel.spawn` starts them (spawn start method)
with a file rendezvous under the test's tmp_path, never a TCP port, and each
joins a gloo world whose collectives time out after 90 s; `spawn` itself
kills them all after 120 s, so a hang fails one test.  The rank functions
live in `torch_parallel_ranks.py`, which imports only the port; the JAX
references run here, on the CPU devices `conftest.py` provides.

- `launch_env`/`initialize_distributed` with no launcher, torchrun's
  environment and the JAX package's; `num_devices` against the world's size
  (the "1 of N visible cards" log with `torch.cuda.device_count` patched,
  the refusal that names how to launch k ranks); a local rank without a
  card of its own; `rank_rows`' layouts.
- The sharded streams: every shard of the synthetic and the procedural
  split, for 1, 2 and 3 shards, byte for byte the JAX package's.
- Global-statistics BatchNorm on 2 ranks against the port's BatchNorm on
  the concatenated batch: output, input gradient, the parameters' gradients
  (summed over the ranks, as the step's mean over ranks of the ranks' own
  losses gives them), the running statistics; rtol 1e-5 / atol 1e-6 (the
  ranks take Flax's fast variance, one process PyTorch's Welford pass).
- The host collectives (`agree_max`, `sum_counts`, `gather_objects`).
- `evaluate()` over 2 and 3 ranks (3: shards of 4, 3 and 3 shapes at batch
  1) gives the counts and per-class accuracies of one process and of the
  JAX package's `evaluate`.
- `train()` over 2 ranks (procedural split, dropout on): only rank 0 writes
  checkpoints and metrics, holding both ranks' stream states; a run stopped
  at step 3 and resumed to 5 equals an uninterrupted one bit for bit on
  both ranks; `--eval_every` logs the global count; SIGTERM on one rank
  stops both after the same step; the train and eval CLIs with
  `--num_devices 2 --device cpu` spawn their ranks and finish.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
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
from gvcnn_tf_tpu_torch.checkpoint import Checkpointer  # noqa: E402
from gvcnn_tf_tpu_torch.data import make_dataset  # noqa: E402
from gvcnn_tf_tpu_torch.models.backbones.layers import (  # noqa: E402
    BatchNorm,
)
from gvcnn_tf_tpu_torch.models.gvcnn import build_model  # noqa: E402
from gvcnn_tf_tpu_torch.parallel import (  # noqa: E402
    World,
    check_num_devices,
    initialize_distributed,
    launch_env,
    rank_rows,
    spawn,
)
from gvcnn_tf_tpu_torch.utils import resolve_device  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from test_torch_gvcnn import _calibrate_bn  # noqa: E402

jax_pipeline = importlib.import_module("gvcnn_tf_tpu.data.pipeline")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 120


def run_ranks(tmp_path, fn, nprocs, *args):
    """[rank 0's result, rank 1's, ...] of fn over `nprocs` gloo ranks."""
    out = tmp_path / f"out_{fn.__name__}_{nprocs}"
    out.mkdir()
    rdv = tmp_path / f"rdv_{fn.__name__}_{nprocs}"
    rdv.mkdir()
    spawn(fn, nprocs, args=(str(out),) + args, timeout=SPAWN_TIMEOUT,
          rendezvous_dir=str(rdv))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(nprocs)]


# ----------------------------------------------------- launch and world

@pytest.mark.parametrize("environ,want", [
    ({}, None),
    ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
      "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"},
     dict(rank=1, world_size=2, local_rank=1, init_method="env://")),
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "4",
      "PROCESS_ID": "3"},
     dict(rank=3, world_size=4, local_rank=0,
          init_method="tcp://10.0.0.1:1234")),
])
def test_launch_env_reads_torchrun_and_the_reference_spelling(environ, want):
    assert launch_env(environ) == want


@pytest.mark.parametrize("environ", [
    {}, {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"},
    {"COORDINATOR_ADDRESS": "localhost:1", "NUM_PROCESSES": "1"}])
def test_initialize_distributed_in_one_process_is_a_no_op(environ):
    world = initialize_distributed(device="cpu", environ=environ)
    assert world == World(device=torch.device("cpu"))
    assert (world.rank, world.size, world.distributed) == (0, 1, False)
    assert not torch.distributed.is_initialized()


def test_num_devices_is_the_worlds_size(monkeypatch, capsys):
    one = World(device=torch.device("cpu"))
    assert check_num_devices(None, one) == 1
    assert check_num_devices(1, one) == 1
    with pytest.raises(ValueError, match=r"num_devices=8, but this world "
                       r"has 1 rank.*torchrun --nproc_per_node 8"):
        check_num_devices(8, one)
    two = World(device=torch.device("cpu"), rank=1, size=2)
    assert check_num_devices(2, two) == check_num_devices(None, two) == 2
    with pytest.raises(ValueError, match="--num_devices 4"):
        check_num_devices(4, two)
    # A single process on a host with 4 cards says that it uses one.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert check_num_devices(None, World(device=torch.device("cuda", 0))) \
        == 1
    assert "using 1 of 4 visible cards" in capsys.readouterr().err


def test_a_local_rank_without_a_card_of_its_own_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="local rank 1 has no card of its "
                       "own"):
        resolve_device("cuda")
    # Named explicitly, two ranks may share card 0 (gloo).
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda", local_rank=0) == torch.device("cuda", 0)


@pytest.mark.parametrize("k", [1, 2])
def test_rank_rows_layouts(k):
    batch = {"x": np.arange(8 * 3).reshape(8, 3), "label": np.arange(8)}
    got = [rank_rows(batch, World(rank=r, size=2), microbatches=k)["label"]
           for r in range(2)]
    want = {1: ([0, 1, 2, 3], [4, 5, 6, 7]),
            2: ([0, 1, 4, 5], [2, 3, 6, 7])}[k]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # Rank r's microbatch i, in rank order, is the global microbatch i.
    for i in range(k):
        rows = np.concatenate([g[i * (4 // k):(i + 1) * (4 // k)]
                               for g in got])
        np.testing.assert_array_equal(rows, np.arange(8)[i * 8 // k:
                                                         (i + 1) * 8 // k])
    with pytest.raises(ValueError, match="not divisible"):
        rank_rows({"x": np.zeros(6)}, World(rank=0, size=4))


# ------------------------------------------------------- sharded streams

@pytest.mark.parametrize("num_shards", [1, 2, 3])
@pytest.mark.parametrize("dataset", ["synthetic", "procedural"])
def test_each_shard_streams_the_jax_packages_shapes(dataset, num_shards):
    """Every shard's train batches (shuffled, across an epoch) and its
    one-pass eval batches equal the JAX package's make_dataset's."""
    kw = dict(dataset=dataset, num_classes=10, height=16, width=16,
              num_views=2, batch_size=2, synthetic_num_shapes=11)
    cfg = dataclasses.replace(port_configs.DataConfig(), **kw)
    jcfg = dataclasses.replace(jax_configs.DataConfig(), **kw)
    seen = []
    for shard in range(num_shards):
        for train, n in ((True, 5), (False, None)):
            args = dict(train=train, seed=3, shard_index=shard,
                        num_shards=num_shards,
                        num_epochs=None if train else 1)
            got = make_dataset(cfg, **args)
            want = jax_pipeline.make_dataset(jcfg, **args)
            got = [next(got) for _ in range(n)] if n else list(got)
            want = [next(want) for _ in range(n)] if n else list(want)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                for key in ("views", "label"):
                    assert a[key].tobytes() == b[key].tobytes(), key
            if not train:
                seen.append(np.concatenate([b["label"] for b in got]))
    # The shards' eval passes together hold every shape once.
    whole = list(make_dataset(cfg, train=False, seed=3, num_epochs=1))
    assert sum(len(s) for s in seen) == 11 == sum(len(b["label"])
                                                  for b in whole)


# --------------------------------------------------- collectives and BN

def test_host_collectives(tmp_path):
    res = run_ranks(tmp_path, ranks.collectives_rank, 3)
    for r in res:
        assert r["agree"] == 3
        np.testing.assert_array_equal(r["counts"], [3, 33])
        assert [g["rank"] for g in r["gathered"]] == [0, 1, 2]
        for i, g in enumerate(r["gathered"]):
            torch.testing.assert_close(g["t"], torch.arange(i + 2))


@pytest.fixture(scope="module", params=[False, True],
                ids=["no_scale", "scale"])
def bn_pair(request, tmp_path_factory):
    """(ranks' results, one process's BatchNorm on the whole batch)."""
    use_scale = request.param
    rs = np.random.RandomState(5)
    x = rs.normal(0.3, 1.2, (4, 6, 5, 5)).astype(np.float32)
    g = rs.normal(0, 1, x.shape).astype(np.float32)
    res = run_ranks(tmp_path_factory.mktemp("bn"), ranks.batch_norm_rank, 2,
                    x, g, use_scale)
    bn = BatchNorm(6, eps=1e-3, momentum=0.9, use_scale=use_scale)
    with torch.no_grad():
        bn.bias.copy_(torch.linspace(-0.5, 0.5, 6))
        if use_scale:
            bn.scale.copy_(torch.linspace(0.5, 1.5, 6))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(g)).sum().backward()
    return res, dict(y=y.detach(), dx=xt.grad, bn=bn)


BN_TOL = dict(rtol=1e-5, atol=1e-6)


def test_global_batch_norm_output(bn_pair):
    res, one = bn_pair
    torch.testing.assert_close(torch.cat([r["y"] for r in res]), one["y"],
                               **BN_TOL)


def test_global_batch_norm_input_gradient(bn_pair):
    res, one = bn_pair
    torch.testing.assert_close(torch.cat([r["dx"] for r in res]), one["dx"],
                               **BN_TOL)


def test_global_batch_norm_parameter_gradients(bn_pair):
    res, one = bn_pair
    for name, p in one["bn"].named_parameters():
        torch.testing.assert_close(sum(r["grads"][name] for r in res),
                                   p.grad, **BN_TOL, msg=name)


def test_global_batch_norm_running_statistics(bn_pair):
    res, one = bn_pair
    bn = one["bn"]
    for r in res:
        torch.testing.assert_close(r["running"][0], bn.running_mean,
                                   **BN_TOL)
        torch.testing.assert_close(r["running"][1], bn.running_var,
                                   **BN_TOL)


# ------------------------------------------------------------ evaluation

N_SHAPES, B, V, H = 10, 4, 2, 32


def _eval_config(mod):
    cfg = mod.get_config("mn40_12view")
    return cfg.replace(
        compute_dtype="float32", raw_endpoint="Conv2d_2c_3x3",
        final_endpoint="Mixed_3b",
        data=dataclasses.replace(
            cfg.data, num_classes=10, height=H, width=H, num_views=V,
            batch_size=B, dataset="procedural",
            synthetic_num_shapes=N_SHAPES))


@pytest.fixture(scope="module")
def eval_shared():
    """Bridged JAX variables with calibrated BN (every top-2 margin above
    1e-3 of max|logit|, as `test_torch_eval.py`'s), and the JAX package's
    and one process's results."""
    jcfg, pcfg = _eval_config(jax_configs), _eval_config(port_configs)
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
    want = jax_evaluate(jcfg, state=types.SimpleNamespace(**variables),
                        per_class=True)
    alone = port_eval.evaluate(pcfg, state=variables, per_class=True,
                               device="cpu")
    return variables, want, alone


@pytest.mark.parametrize("nprocs", [2, 3])
def test_evaluate_over_ranks_gives_the_global_counts(eval_shared, tmp_path,
                                                     nprocs):
    variables, want, alone = eval_shared
    res = run_ranks(tmp_path, ranks.eval_rank, nprocs,
                    _eval_config(port_configs), variables)
    assert alone == want and want["count"] == N_SHAPES
    for r in res:        # every rank returns the global result
        assert r == alone


# ------------------------------------------------------ the training loop

def _loop_config(logdir, **train_kw):
    cfg = _eval_config(port_configs)
    kw = dict(train_logdir=str(logdir), checkpoint_every=2, log_every=1,
              learning_rate=0.01)
    return cfg.replace(dropout_keep_prob=0.8, train=dataclasses.replace(
        cfg.train, **{**kw, **train_kw}))


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    runs = [("whole", _loop_config(root / "a"), 5, None),
            ("first", _loop_config(root / "b"), 3, None),
            ("resumed", _loop_config(root / "b"), 5, None),
            ("eval", _loop_config(root / "e", eval_every=2), 2, None),
            ("sigterm", _loop_config(root / "s", checkpoint_every=100), 50,
             5)]
    return root, run_ranks(root, ranks.train_rank, 2, runs)


def test_only_rank_0_writes_checkpoints_and_metrics(loop):
    root, (r0, r1) = loop
    assert r0["whole"]["saves"] == [2, 4, 5] and r1["whole"]["saves"] == []
    assert Checkpointer(str(root / "a")).steps() == [2, 4, 5]
    payload = torch.load(Checkpointer(str(root / "a")).path(5),
                         weights_only=True)
    assert payload["step"] == 5 and len(payload["data"]) == 2
    assert payload["data"][0]["order"] is not None
    lines = (root / "a" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(s)["step"] for s in lines] == [1, 2, 3, 4, 5]


def test_resumed_ranks_equal_an_uninterrupted_run(loop):
    _, res = loop
    assert (res[0]["first"]["saves"], res[0]["resumed"]["saves"]) == (
        [2, 3], [4, 5])
    assert res[1]["first"]["saves"] == res[1]["resumed"]["saves"] == []
    for r in res:
        assert r["first"]["step"] == 3 and r["resumed"]["step"] == 5
        a, b = r["whole"]["state"], r["resumed"]["state"]
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)
        assert r["resumed"]["mets"] == r["whole"]["mets"]
    # The replicas stayed equal.
    for k, v in res[0]["resumed"]["state"].items():
        torch.testing.assert_close(res[1]["resumed"]["state"][k], v, rtol=0,
                                   atol=0, msg=k)


def test_eval_every_logs_the_global_count(loop):
    root, _ = loop
    recs = [json.loads(s) for s in
            (root / "e" / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in recs if "val_count" in r]
    assert [(r["step"], r["val_count"]) for r in val] == [(2, N_SHAPES)]


def test_sigterm_on_one_rank_stops_both_after_the_same_step(loop):
    root, (r0, r1) = loop
    # Rank 1's prefetcher reads up to three batches ahead of its step.
    step = r0["sigterm"]["step"]
    assert 1 <= step <= 6 and r1["sigterm"]["step"] == step
    assert Checkpointer(str(root / "s")).latest_step() == step
    assert r0["sigterm"]["saves"] == [step] and r1["sigterm"]["saves"] == []


def test_cli_spawns_num_devices_ranks(tmp_path):
    # One intra-op thread a rank: the suite's other workers share the cores.
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "gvcnn_tf_tpu_torch.train", "--config",
         "mn40_12view", "--num_devices", "2", "--device", "cpu",
         "--num_views", "2", "--height", "32", "--width", "32",
         "--batch_size", "4", "--how_many_training_steps", "2",
         "--train_logdir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "spawning 2 ranks" in proc.stderr
    assert Checkpointer(str(tmp_path)).steps() == [2]
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(s)["step"] for s in lines] == [2]
    # The evaluator spawns its ranks too; rank 0 alone prints the global
    # result over the synthetic split's 128 shapes.
    proc = subprocess.run(
        [sys.executable, "-m", "gvcnn_tf_tpu_torch.eval", "--config",
         "mn40_12view", "--num_devices", "2", "--device", "cpu",
         "--num_views", "2", "--height", "32", "--width", "32",
         "--batch_size", "4", "--checkpoint_dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = [s for s in proc.stdout.splitlines() if s.startswith("{")]
    assert len(results) == 1 and "'count': 128" in results[0], proc.stdout
