"""The data-parallel world (counterpart of `gvcnn_tf_tpu/parallel/mesh.py`).

The JAX package builds a 1-D `data` mesh over the devices of one program and
shards the batch on dim 0; XLA inserts the collectives.  The port runs one
process per card, PyTorch's idiom: a `World` holds this process's rank, the
number of ranks, its device (the card of its local rank) and its process
groups, and every rank holds a replica of the model and its own rows of the
global batch.  `group` carries the collectives on tensors of `device` (NCCL
on cards, gloo on the CPU or where the caller asked for it); `host_group`
is a gloo group over the same ranks for the small host-side exchanges
(agreeing on a stop, gathering the data streams' states, the evaluation's
counts), so that they never synchronise a card's stream.

`num_devices` (the config's data-parallel degree) means the world's size:
None is whatever world was launched (one process: one card), and a number
that differs from the world's size is refused with the command that
launches that many ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from gvcnn_tf_tpu_torch.metrics import log


@dataclasses.dataclass(frozen=True)
class World:
    """One rank's view of the data-parallel world.  The default is the
    single process with no process group: no collective runs."""

    device: torch.device = torch.device("cpu")
    rank: int = 0
    size: int = 1
    backend: Optional[str] = None
    group: Any = None                # None: no process group
    host_group: Any = None           # gloo, CPU tensors

    @property
    def is_main(self) -> bool:
        """Rank 0 writes the metrics and the checkpoints."""
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        """Whether a process group exists (also for a world of one)."""
        return self.group is not None


def launch_hint(k: int) -> str:
    """How to start k ranks, one per card."""
    return (f"launch {k} ranks, one per card: `--num_devices {k}` on the "
            f"train or eval command line spawns them on this host, or "
            f"`torchrun --nproc_per_node {k} -m gvcnn_tf_tpu_torch.train "
            f"...` (or .eval)")


def check_num_devices(num_devices: Optional[int], world: World) -> int:
    """The data-parallel degree for `num_devices` in `world`: None is the
    world's size; any other number must equal it.  A single process that
    leaves cards of its host unused says so."""
    if num_devices is None:
        visible = (torch.cuda.device_count() if world.device.type == "cuda"
                   else 0)
        if world.size == 1 and visible > 1:
            log(f"using 1 of {visible} visible cards (num_devices=None in a "
                f"single process); to use all of them, "
                f"{launch_hint(visible)}")
        return world.size
    if num_devices != world.size:
        raise ValueError(
            f"num_devices={num_devices}, but this world has {world.size} "
            f"rank(s); {launch_hint(num_devices)}")
    return num_devices
