"""Checkpoint and resume in the port's own format (counterpart of
`gvcnn_tf_tpu/checkpoint.py::Checkpointer`), the reader of the JAX
package's Orbax checkpoints, and warm start.

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
wrote the checkpoint, on the device in eval mode.  It reads three kinds of
directory (`variables`):

  the port's checkpoints   `ckpt_<step>.pt`: a training run's (its
                           `model` state_dict) or the slim importer's (a
                           Flax tree of tensors under `variables`)
  Orbax, by step           the JAX `Checkpointer`'s `<step>/default/`
                           (`CheckpointManager` with `StandardSave`)
  Orbax, raw               one step-less `StandardCheckpointer` directory

`read_orbax` reads an Orbax checkpoint with tensorstore alone, without JAX
or Orbax: `<item>/_METADATA` (JSON) names every leaf by its tree path, and
each leaf is a zarr array (zarr3 when `use_zarr3`) in the OCDBT database of
that directory (`use_ocdbt`) or in a directory of its own named by the path
joined with dots (`params.InceptionV1.Conv2d_1a_7x7.conv.kernel`).  Only the
collections asked for are opened, so a `TrainState`'s optimizer state is
never read, whatever optimizer wrote it.

`warm_start` is the JAX package's (slim's `assign_from_checkpoint_fn` with
`checkpoint_exclude_scopes`) on the same Flax trees, and
`warm_start_model` applies it to a model in place.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from gvcnn_tf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from gvcnn_tf_tpu_torch.configs import GVCNNConfig
from gvcnn_tf_tpu_torch.models.gvcnn import (
    ViewModel,
    build_model,
    to_device,
)
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


def _excluded(scope: str, exclude_scopes: Sequence[str]) -> bool:
    return any(scope.startswith(e) for e in exclude_scopes)


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading the JAX package's Orbax checkpoints needs the "
            "`tensorstore` package, which this Python does not have; "
            "convert the checkpoint where it is installed (`read_orbax`, "
            "then `Checkpointer.save` of the Flax tree as the slim "
            "importer does)") from e
    return tensorstore


def _orbax_item_dir(directory: str, step: Optional[int]) -> str:
    """The directory of the `default` item of `step` (default: the newest)
    under a `CheckpointManager` directory, or `directory` itself when it
    has no step directories (a raw `StandardCheckpointer` save)."""
    steps = sorted(int(n) for n in os.listdir(directory)
                   if _ORBAX_STEP.match(n)
                   and os.path.isdir(os.path.join(directory, n)))
    if step is not None and step not in steps:
        raise FileNotFoundError(f"no step {step} under {directory} (Orbax "
                                f"steps: {steps})")
    if not steps:
        if not os.path.isfile(os.path.join(directory, "_METADATA")):
            raise FileNotFoundError(
                f"no checkpoints under {directory}: no Orbax step "
                "directories and no Orbax _METADATA")
        return directory
    root = os.path.join(directory, str(steps[-1] if step is None else step))
    item = os.path.join(root, "default")
    return item if os.path.isdir(item) else root


def read_orbax(directory: str, step: Optional[int] = None,
               items: Sequence[str] = ("params", "batch_stats"),
               exclude_scopes: Sequence[str] = ()) -> Dict[str, Any]:
    """The collections `items` of an Orbax checkpoint as a Flax tree with
    numpy leaves, e.g. {"params": ..., "batch_stats": ...}, the input of
    `bridge.jax_to_state_dict` (counterpart of
    `Checkpointer.restore_partial`).  `directory` is a `CheckpointManager`
    directory (the step `step`, default the newest) or a raw step-less
    save.  Top-level scopes that start with an entry of `exclude_scopes`
    are not read.  Reads with tensorstore, without JAX or Orbax; raises
    FileNotFoundError when the directory holds no finished Orbax
    checkpoint or the checkpoint lacks one of `items`."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    item_dir = os.path.abspath(_orbax_item_dir(directory, step))
    meta_path = os.path.join(item_dir, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(
            f"{item_dir} has no Orbax _METADATA: not a finished Orbax "
            "checkpoint")
    with open(meta_path) as f:
        meta = json.load(f)
    leaves = {tuple(k["key"] for k in v["key_metadata"]): v["value_metadata"]
              for v in meta["tree_metadata"].values()}
    missing = [i for i in items if not any(p[0] == i for p in leaves)]
    if missing:
        raise FileNotFoundError(
            f"the Orbax checkpoint {item_dir} has no {', '.join(missing)} "
            f"(it holds {', '.join(sorted({p[0] for p in leaves}))})")
    paths = [p for p in sorted(leaves) if p[0] in items
             and not (len(p) > 2 and _excluded(p[1], exclude_scopes))]
    for p in paths:
        if leaves[p].get("value_type") not in ("np.ndarray", "jax.Array"):
            raise ValueError(f"{'/'.join(p)} in {item_dir} is a "
                             f"{leaves[p].get('value_type')}, not an array")

    ts = _tensorstore()
    driver = "zarr3" if meta.get("use_zarr3", False) else "zarr"
    ocdbt = meta.get("use_ocdbt",
                     os.path.isfile(os.path.join(item_dir, "manifest.ocdbt")))
    context = ts.Context()

    def spec(name):
        kvstore = ({"driver": "ocdbt", "base": f"file://{item_dir}",
                    "path": name} if ocdbt
                   else {"driver": "file",
                         "path": os.path.join(item_dir, name)})
        return {"driver": driver, "kvstore": kvstore}

    opened = [ts.open(spec(".".join(p)), read=True, context=context)
              for p in paths]
    reads = [o.result().read() for o in opened]
    tree: Dict[str, Any] = {i: {} for i in items}
    for p, r in zip(paths, reads):
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = np.asarray(r.result())
    return tree


def _port_payload(directory: str) -> Optional[Dict[str, Any]]:
    """The newest of the port's checkpoints under `directory`, or None when
    it has none."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    ckpt = Checkpointer(directory)
    if ckpt.latest_step() is None:
        return None
    return ckpt.restore(map_location="cpu")


def _variables(directory: str, payload: Optional[Dict[str, Any]],
               exclude_scopes: Sequence[str]) -> Dict[str, Any]:
    if payload is None:
        try:
            return read_orbax(directory, exclude_scopes=exclude_scopes)
        except FileNotFoundError:
            # A params-only checkpoint; any other fault raises again here.
            return read_orbax(directory, items=("params",),
                              exclude_scopes=exclude_scopes)
    if "model" in payload:
        return state_dict_to_jax(payload["model"])
    return {c: _to_numpy(t) for c, t in payload["variables"].items()}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def read_variables(directory: str,
                   exclude_scopes: Sequence[str] = ()) -> Dict[str, Any]:
    """The Flax tree (numpy leaves) of the newest checkpoint under
    `directory`, of any of the three kinds: `params`, and `batch_stats`
    where the checkpoint has them, without the top-level scopes that start
    with an entry of `exclude_scopes`."""
    tree = _variables(directory, _port_payload(directory), exclude_scopes)
    return {c: {s: sub for s, sub in t.items()
                if not _excluded(s, exclude_scopes)}
            for c, t in tree.items()}


def model_state(checkpoint_dir: str) -> Dict[str, torch.Tensor]:
    """The model's `state_dict` (CPU tensors) in the newest checkpoint
    under `checkpoint_dir`: one of the port's, or the JAX package's Orbax
    checkpoint through `read_orbax` and the bridge."""
    payload = _port_payload(checkpoint_dir)
    if payload is not None and "model" in payload:
        return payload["model"]
    return jax_to_state_dict(_variables(checkpoint_dir, payload, ()))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


def warm_start(init: Dict[str, Any], pretrained: Dict[str, Any],
               exclude_scopes: Sequence[str] = ()) -> Dict[str, Any]:
    """slim's `assign_from_checkpoint_fn` on one collection of Flax trees
    (`gvcnn_tf_tpu/checkpoint.py::warm_start`): every top-level scope of
    `pretrained` that `init` has and whose name starts with no entry of
    `exclude_scopes` replaces `init`'s; a scope whose shapes or structure
    differ raises ValueError, naming it."""
    out = dict(init)
    for scope, sub in pretrained.items():
        if _excluded(scope, exclude_scopes) or scope not in out:
            continue
        want, got = _shapes(out[scope]), _shapes(sub)
        if want != got:
            raise ValueError(f"warm-start shape mismatch in scope {scope!r}: "
                             f"{got} vs {want}")
        out[scope] = sub
    return out


def _restricted(pretrained, like):
    """`pretrained` without the keys that `like` lacks, at every level."""
    if not (isinstance(pretrained, dict) and isinstance(like, dict)):
        return pretrained
    return {k: _restricted(v, like[k]) for k, v in pretrained.items()
            if k in like}


def warm_start_model(model: ViewModel, checkpoint_path: str,
                     exclude_scopes: Sequence[str] = ()) -> ViewModel:
    """In place: `model`'s parameters and BatchNorm statistics warm-started
    from the newest checkpoint under `checkpoint_path` (any kind, see
    `read_variables`) by `warm_start` on each collection, the checkpoint's
    BatchNorm statistics only where it has them.  As the JAX package's
    partial restore reads only the model's own leaves, leaves the model
    lacks (a backbone cut short of the checkpoint's) are dropped first; a
    leaf the checkpoint lacks, or of another shape, raises ValueError."""
    pretrained = read_variables(checkpoint_path, exclude_scopes)
    init = state_dict_to_jax(model.state_dict())
    merged = {c: warm_start(t, _restricted(pretrained[c], t), exclude_scopes)
              if pretrained.get(c) else t for c, t in init.items()}
    model.load_state_dict(jax_to_state_dict(merged))
    return model


def to_eval(model: ViewModel, state_dict: Dict[str, torch.Tensor],
            device: torch.device, fold_bn: bool = False) -> ViewModel:
    """In place: `state_dict` loaded into `model`, BatchNorm folded into the
    convs (exact, in fp32) when asked, and the model on `device`
    (channels-last on a card) in eval mode."""
    model.load_state_dict(state_dict)
    if fold_bn:
        fold_batch_norm(model)
    return to_device(model, device).eval()


def load_model(config: GVCNNConfig, checkpoint_dir: Optional[str] = None,
               device="cuda", fold_bn: bool = False) -> ViewModel:
    """`config`'s model with the weights and BatchNorm statistics of the
    newest checkpoint under `checkpoint_dir` (default: the config's
    `train_logdir`; any kind that `model_state` reads), on `device` in eval
    mode (see `to_eval`).  A checkpoint of another model raises, naming the
    missing, unexpected or mis-shaped keys.  Parameters stay fp32; the
    forward casts the convs to `compute_dtype`."""
    dev = resolve_device(device)
    state = model_state(checkpoint_dir or config.train.train_logdir)
    return to_eval(build_model(config), state, dev, fold_bn)
