"""Checkpoint and resume in the port's own format (counterpart of
`gvcnn_tf_tpu/checkpoint.py::Checkpointer`; reading the JAX package's Orbax
checkpoints needs JAX and is not ported: ROADMAP §1 item 1).

One file per step, `<directory>/ckpt_<step:08d>.pt`, written by
`torch.save` of a dict of tensors, numbers and strings (the training loop
stores the step, the model's `state_dict`, the optimizer's state and the
data stream's generator state) and read back with
`torch.load(weights_only=True)`.  A save writes a temporary file in the
same directory and renames it over the final name (`os.replace`), so a
reader never sees a partial checkpoint; the oldest are deleted beyond
`max_to_keep`.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class Checkpointer:
    """Step-keyed checkpoints in one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Dict[str, Any]):
        """Write `payload` as the checkpoint of `step`, atomically."""
        fd, tmp = tempfile.mkstemp(prefix=".ckpt_", suffix=".tmp",
                                   dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(payload, f)
            os.replace(tmp, self.path(step))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Dict[str, Any]:
        """The payload saved at `step` (default: the latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)
