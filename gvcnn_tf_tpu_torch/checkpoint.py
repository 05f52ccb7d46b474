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

`load_model` is the counterpart of `Checkpointer.restore_partial` for
evaluation, prediction and serving: the model alone, whatever optimizer
wrote the checkpoint, on the device in eval mode.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, List, Optional

import torch

from gvcnn_tf_tpu_torch.configs import GVCNNConfig
from gvcnn_tf_tpu_torch.models.gvcnn import GVCNN, build_model, to_device
from gvcnn_tf_tpu_torch.utils import fold_batch_norm, resolve_device

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")
# Orbax's CheckpointManager writes one directory per step, named by it.
_ORBAX_STEP = re.compile(r"^\d+$")


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


def model_state(checkpoint_dir: str) -> Dict[str, torch.Tensor]:
    """The model's `state_dict` (CPU tensors) in the newest checkpoint
    under `checkpoint_dir`.  A directory of the JAX package's Orbax
    checkpoints is refused."""
    if not os.path.isdir(checkpoint_dir):
        raise FileNotFoundError(f"no checkpoint directory {checkpoint_dir}")
    names = os.listdir(checkpoint_dir)
    if not any(_NAME.match(n) for n in names) and any(
            _ORBAX_STEP.match(n)
            and os.path.isdir(os.path.join(checkpoint_dir, n))
            for n in names):
        raise NotImplementedError(
            f"{checkpoint_dir} holds Orbax checkpoints of the JAX package; "
            "reading them needs JAX, and the port's Orbax checkpoint reader "
            "is not ported yet (ROADMAP §1 item 1; queue item 3)")
    return Checkpointer(checkpoint_dir).restore(map_location="cpu")["model"]


def to_eval(model: GVCNN, state_dict: Dict[str, torch.Tensor],
            device: torch.device, fold_bn: bool = False) -> GVCNN:
    """In place: `state_dict` loaded into `model`, BatchNorm folded into the
    convs (exact, in fp32) when asked, and the model on `device`
    (channels-last on a card) in eval mode."""
    model.load_state_dict(state_dict)
    if fold_bn:
        fold_batch_norm(model)
    return to_device(model, device).eval()


def load_model(config: GVCNNConfig, checkpoint_dir: Optional[str] = None,
               device="cuda", fold_bn: bool = False) -> GVCNN:
    """`config`'s model with the weights and BatchNorm statistics of the
    newest checkpoint under `checkpoint_dir` (default: the config's
    `train_logdir`), on `device` in eval mode (see `to_eval`).  Parameters
    stay fp32; the forward casts the convs to `compute_dtype`."""
    dev = resolve_device(device)
    state = model_state(checkpoint_dir or config.train.train_logdir)
    return to_eval(build_model(config), state, dev, fold_bn)
