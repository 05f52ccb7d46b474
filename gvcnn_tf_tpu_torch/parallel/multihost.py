"""Starting the data-parallel world (counterpart of
`gvcnn_tf_tpu/parallel/multihost.py`).

`initialize_distributed` reads the launcher's environment and joins the
process group; in a single process it is a no-op that returns a one-rank
`World`, so the same trainer runs alone or as one of many ranks.  Two
spellings of the environment are read:

  torchrun           RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/MASTER_PORT
  the JAX package's  COORDINATOR_ADDRESS (host:port), NUM_PROCESSES,
                     PROCESS_ID (and LOCAL_RANK where several ranks share a
                     host)

The backend is NCCL for a card and gloo for the CPU, unless the caller names
one (two ranks sharing one card take gloo: NCCL refuses that).  A failure to
join raises; nothing falls back to another backend or to one process.

`spawn` starts k local ranks from one command (`train --num_devices k`
without a launcher); `rank_rows` is `make_global_batch`'s counterpart: the
rows of a global batch that one rank holds.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gvcnn_tf_tpu_torch.parallel.mesh import World
from gvcnn_tf_tpu_torch.utils.device import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def launch_env(environ: Optional[Mapping[str, str]] = None
               ) -> Optional[Dict[str, object]]:
    """{rank, world_size, local_rank, init_method} from a launcher's
    environment (torchrun's, else the JAX package's spelling), or None when
    no launcher started this process."""
    env = os.environ if environ is None else environ
    if "WORLD_SIZE" in env and "RANK" in env:
        rank = int(env["RANK"])
        return dict(rank=rank, world_size=int(env["WORLD_SIZE"]),
                    local_rank=int(env.get("LOCAL_RANK", rank)),
                    init_method="env://")
    if env.get("COORDINATOR_ADDRESS"):
        return dict(rank=int(env.get("PROCESS_ID", "0")),
                    world_size=int(env.get("NUM_PROCESSES", "1")),
                    local_rank=int(env.get("LOCAL_RANK", "0")),
                    init_method=f"tcp://{env['COORDINATOR_ADDRESS']}")
    return None


def initialize_distributed(backend: Optional[str] = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT, *,
                           device="cuda", init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           environ: Optional[Mapping[str, str]] = None
                           ) -> World:
    """Join the world and return this rank's `World`.

    Without `init_method`, the launcher's environment decides; with none,
    or a world of one, this is a no-op: a `World` of one rank on
    `resolve_device(device)` and no process group.  With `init_method`
    (e.g. "file:///tmp/x/rendezvous"), the group is made with `rank` and
    `world_size` (default: the environment's, else 0 and 1), also for a
    world of one; the local rank is the environment's, else the rank.  `device` "cuda" is the local
    rank's card; an explicit index is kept.  `timeout` bounds every
    collective, so a rank that has left makes its peers fail, not hang."""
    env = launch_env(environ)
    if init_method is None:
        if env is None or env["world_size"] <= 1:
            return World(device=resolve_device(device))
        init_method = env["init_method"]
    env = env or {}
    rank = env.get("rank", 0) if rank is None else rank
    world_size = env.get("world_size", 1) if world_size is None \
        else world_size
    dev = resolve_device(device, env.get("local_rank", rank))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; pass "
                           "its World instead of initializing again")
    kw = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout, **kw)
    group = dist.group.WORLD
    host_group = (group if backend == "gloo"
                  else dist.new_group(backend="gloo", timeout=timeout))
    return World(device=dev, rank=rank, size=world_size, backend=backend,
                 group=group, host_group=host_group)


def shutdown(world: World):
    """Leave the process group `world` was made with (no-op without one)."""
    if world.distributed and dist.is_initialized():
        dist.destroy_process_group()


def rank_rows(batch: Dict[str, np.ndarray], world: World,
              microbatches: int = 1) -> Dict[str, np.ndarray]:
    """The rows of a global batch (every leaf's dim 0) that `world`'s rank
    holds: rows [r B/W, (r+1) B/W), as the JAX package shards dim 0.  With
    `microbatches` k > 1, the global microbatch i is the global rows
    [i B/k, (i+1) B/k) (the JAX step's reshape to (k, B/k)) and the rank
    holds its share of each, in order: the layout `train_step` takes with
    `accumulate_steps` k in `bn_sync="global"`."""
    def rows(x):
        b = x.shape[0]
        if b % (world.size * microbatches):
            raise ValueError(f"batch {b} not divisible by {world.size} ranks "
                             f"x {microbatches} microbatches")
        per = b // (world.size * microbatches)
        mb = x.reshape((microbatches, world.size, per) + x.shape[1:])
        return np.ascontiguousarray(mb[:, world.rank]).reshape(
            (microbatches * per,) + x.shape[1:])

    return {k: rows(np.asarray(v)) for k, v in batch.items()}


def _rank_main(index: int, fn: Callable, nprocs: int, init_method: str,
               args: Sequence, threads: int):
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index),
                      WORLD_SIZE=str(nprocs))
    # The host's cores shared among the ranks: more threads than cores make
    # the intra-op pools spin against each other.
    torch.set_num_threads(threads)
    fn(init_method, *args)


def spawn(fn: Callable, nprocs: int, args: Sequence = (),
          timeout: Optional[float] = None,
          rendezvous_dir: Optional[str] = None):
    """Run `fn(init_method, *args)` in `nprocs` spawned processes, one per
    local rank, with RANK, LOCAL_RANK and WORLD_SIZE set as torchrun sets
    them; `init_method` is a file rendezvous in `rendezvous_dir` (default: a
    fresh temporary directory, removed after), for
    `initialize_distributed(init_method=...)`.  `fn` must be importable by
    the children (a module's top-level function).  Each rank takes its
    share of this process's intra-op threads.  Raises when a rank
    fails (the others are stopped) or when all have not ended within
    `timeout` seconds (all are killed)."""
    own = rendezvous_dir is None
    rendezvous_dir = rendezvous_dir or tempfile.mkdtemp(prefix="gvcnn_rdv_")
    init_method = "file://" + os.path.join(os.path.abspath(rendezvous_dir),
                                           "rendezvous")
    threads = max(torch.get_num_threads() // nprocs, 1)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, nprocs, init_method, tuple(args), threads),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not end within "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        if own:
            shutil.rmtree(rendezvous_dir, ignore_errors=True)
