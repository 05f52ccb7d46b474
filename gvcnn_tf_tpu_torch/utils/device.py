"""The device an entry point runs on."""

from __future__ import annotations

import os
from typing import Optional

import torch


def resolve_device(device, local_rank: Optional[int] = None
                   ) -> torch.device:
    """torch.device for `device`; a CUDA request without a card raises.

    A bare "cuda" is the card of this process's local rank (`local_rank`,
    else the launcher's LOCAL_RANK, else 0), so that one process per card
    lands each rank on its own; a local rank with no card of its own
    raises.  An explicit index ("cuda:0") is taken as given."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "false; the port never falls back to the CPU (pass --device cpu "
            "to run on the CPU)")
    if dev.index is not None:
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    visible = torch.cuda.device_count()
    if local_rank >= visible:
        raise RuntimeError(
            f"local rank {local_rank} has no card of its own ({visible} "
            "visible); launch at most one rank per card, or name the device "
            "explicitly (e.g. --device cuda:0) to share one")
    return torch.device("cuda", local_rank)
