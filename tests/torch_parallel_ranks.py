"""Rank processes of the port's data-parallel tests (`test_torch_parallel*.py`).

Each function here runs in every rank that `gvcnn_tf_tpu_torch.parallel.spawn`
starts: it joins a gloo world on the CPU through the file rendezvous that
`spawn` hands it (with a 90 s timeout on every collective), does its work and
saves what it found as `rank<r>.pt` in `out_dir` for the test to compare.
This module imports only torch, numpy and the port, never JAX: the JAX
references run in the test process.
"""

import dataclasses
import datetime
import os
import signal
from unittest import mock

import numpy as np
import torch

from gvcnn_tf_tpu_torch.checkpoint import Checkpointer
from gvcnn_tf_tpu_torch.data import make_dataset
from gvcnn_tf_tpu_torch.eval import evaluate
from gvcnn_tf_tpu_torch.models.backbones.layers import BatchNorm
from gvcnn_tf_tpu_torch.parallel import (
    World,
    initialize_distributed,
    rank_rows,
    shutdown,
)
from gvcnn_tf_tpu_torch.parallel import collectives
from gvcnn_tf_tpu_torch.train import create_train_state, train, train_step

TIMEOUT = datetime.timedelta(seconds=90)


def _join(init_method):
    torch.set_num_threads(2)
    return initialize_distributed(timeout=TIMEOUT, device="cpu",
                                  init_method=init_method)


def _save(out_dir, world, result):
    torch.save(result, os.path.join(out_dir, f"rank{world.rank}.pt"))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _snapshot(state, mets):
    return {"state": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "mets": {k: float(v) for k, v in mets.items()}}


def collectives_rank(init_method, out_dir):
    """The host-side collectives: agree_max, sum_counts, gather_objects
    (ranks' objects of different sizes)."""
    world = _join(init_method)
    r = world.rank
    _save(out_dir, world, {
        "agree": collectives.agree_max(3 if r == 1 else 1, world),
        "counts": collectives.sum_counts(np.array([r, 10 * r + 1]), world),
        "gathered": collectives.gather_objects(
            {"rank": r, "t": torch.arange(r + 2)}, world)})
    shutdown(world)


def batch_norm_rank(init_method, out_dir, x, g, use_scale):
    """A train-mode BatchNorm with global statistics on this rank's rows of
    x, backpropagating sum(y * g) over them."""
    world = _join(init_method)
    bn = BatchNorm(x.shape[1], eps=1e-3, momentum=0.9, use_scale=use_scale)
    with torch.no_grad():
        bn.bias.copy_(torch.linspace(-0.5, 0.5, x.shape[1]))
        if use_scale:
            bn.scale.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
    bn.sync_group = world.group
    rows = rank_rows({"x": x, "g": g}, world)
    xr = torch.from_numpy(rows["x"]).requires_grad_()
    y = bn(xr)
    (y * torch.from_numpy(rows["g"])).sum().backward()
    _save(out_dir, world, {
        "y": y.detach(), "dx": xr.grad,
        "grads": {n: p.grad for n, p in bn.named_parameters()},
        "running": (bn.running_mean.clone(), bn.running_var.clone())})
    shutdown(world)


def steps_rank(init_method, out_dir, cfg, weights, batches, tile):
    """One step in each bn_sync mode and accumulate_steps 1 and 2 from the
    bridged weights on this rank's rows of `batches["jax"]` (the layouts of
    `train_step`'s docstring); the local step on `tile` (every rank the
    same rows) beside one process's step on it; the global step with
    dropout on beside one process's step on the whole global batch; three
    steps in each mode on `batches["steps"]`."""
    world = _join(init_method)

    def fresh(c, w=world):
        state = create_train_state(c, "cpu", w)
        state.model.load_state_dict(weights)
        return state

    def with_mode(mode, k=1, **kw):
        return cfg.replace(bn_sync=mode, train=dataclasses.replace(
            cfg.train, accumulate_steps=k), **kw)

    out = {}
    for mode in ("global", "local"):
        for k in (1, 2):
            c = with_mode(mode, k)
            rows = rank_rows(batches["jax"], world,
                             microbatches=k if mode == "global" else 1)
            state = fresh(c)
            out[f"{mode}_k{k}"] = _snapshot(state, train_step(
                state, _torch_batch(rows), c))
    c = with_mode("local")
    state = fresh(c)
    out["tiled"] = _snapshot(state, train_step(state, _torch_batch(tile), c))
    single = fresh(c, World())
    out["tile_alone"] = _snapshot(single, train_step(
        single, _torch_batch(tile), c))
    for k in (1, 2):
        c = with_mode("global", k, dropout_keep_prob=0.5)
        state = fresh(c)
        out[f"dropout_k{k}"] = _snapshot(state, train_step(
            state, _torch_batch(rank_rows(batches["jax"], world,
                                          microbatches=k)), c))
        single = fresh(c, World())
        glob = rank_rows(batches["jax"], World(), microbatches=1)
        out[f"dropout_k{k}_alone"] = _snapshot(single, train_step(
            single, _torch_batch(glob), c))
    for mode in ("global", "local"):
        c = with_mode(mode, dropout_keep_prob=0.8)
        state = fresh(c)
        for batch in batches["steps"]:
            mets = train_step(state, _torch_batch(rank_rows(batch, world)),
                              c)
        out[f"replica_{mode}"] = _snapshot(state, mets)
    _save(out_dir, world, out)
    shutdown(world)


def eval_rank(init_method, out_dir, cfg, variables):
    """`evaluate()` of the bridged variables over this world."""
    world = _join(init_method)
    _save(out_dir, world, evaluate(cfg, state=variables, per_class=True,
                                   device="cpu", world=world))
    shutdown(world)


def _sigterm_at(stream, n):
    for i, batch in enumerate(stream):
        if i == n:
            os.kill(os.getpid(), signal.SIGTERM)
        yield batch


def train_rank(init_method, out_dir, runs):
    """`train()` for each (name, config, num_steps, sigterm_at) in turn: the
    final step, state and metrics, and how many checkpoints this rank
    wrote.  `sigterm_at` n: rank 1 sends itself SIGTERM when its stream
    yields batch n."""
    world = _join(init_method)
    out = {}
    real_save = Checkpointer.save
    for name, cfg, num_steps, sigterm_at in runs:
        saves = []

        def spy(self, step, payload):
            saves.append(step)
            real_save(self, step, payload)

        it = None
        if sigterm_at is not None and world.rank == 1:
            d = cfg.data
            it = _sigterm_at(make_dataset(dataclasses.replace(
                d, batch_size=d.batch_size // world.size), train=True,
                seed=cfg.train.seed, shard_index=1, num_shards=world.size),
                sigterm_at)
        with mock.patch.object(Checkpointer, "save", spy):
            state, mets = train(cfg, num_steps=num_steps, dataset_iter=it,
                                device="cpu", world=world)
        out[name] = dict(_snapshot(state, mets), step=state.step,
                         saves=saves)
    _save(out_dir, world, out)
    shutdown(world)


def remat_rank(init_method, out_dir, cfg, batch, remat_until):
    """One step from the seeded init in each bn_sync mode on this rank's
    rows of `batch`, without and with `remat_until`; and one process's
    global-mode step with it on the whole batch."""
    world = _join(init_method)
    out = {}
    rows = _torch_batch(rank_rows(batch, world))
    for mode in ("global", "local"):
        for name, c in (("plain", cfg), ("remat", cfg.replace(
                remat_until=remat_until))):
            c = c.replace(bn_sync=mode)
            state = create_train_state(c, "cpu", world)
            out[f"{mode}_{name}"] = _snapshot(state, train_step(state, rows,
                                                                c))
    c = cfg.replace(remat_until=remat_until)
    single = create_train_state(c, "cpu", World())
    out["alone"] = _snapshot(single, train_step(single, _torch_batch(batch),
                                                c))
    _save(out_dir, world, out)
    shutdown(world)
