"""Import a TF-Slim Inception-v1 checkpoint into the port's checkpoint
format, for warm start (counterpart of
`gvcnn_tf_tpu/tools/import_slim_checkpoint.py`).

The port keeps slim's scope names (`models/backbones/inception_v1.py`), so
the import is a renaming into the Flax tree that `bridge.py` maps:

    slim variable                                  flax path
    InceptionV1/Conv2d_1a_7x7/weights           -> InceptionV1/Conv2d_1a_7x7/conv/kernel
    .../BatchNorm/beta                          -> .../BatchNorm/bias
    .../BatchNorm/moving_mean                   -> batch_stats .../BatchNorm/mean
    .../BatchNorm/moving_variance               -> batch_stats .../BatchNorm/var
    InceptionV1/Mixed_3b/Branch_0/Conv2d_0a_1x1 -> InceptionV1/Mixed_3b/Branch_0_Conv2d_0a_1x1
    InceptionV1/Logits/Conv2d_0c_1x1/weights    -> Logits/kernel (1x1 conv squeezed to Dense)

Usage (host-side; TensorFlow is needed only to read the checkpoint):

    python -m gvcnn_tf_tpu_torch.tools.import_slim_checkpoint \\
        --slim_checkpoint inception_v1.ckpt --output_dir ckpts/imagenet_v1
    python -m gvcnn_tf_tpu_torch.train --config mn40_12view \\
        --checkpoint_path ckpts/imagenet_v1 --train_logdir runs/mn40

The output is one of the port's checkpoints (`checkpoint.Checkpointer`,
step 0) whose payload holds the Flax tree {'params': ..., 'batch_stats':
...} as CPU tensors under `variables`; `train --checkpoint_path` reads it.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from gvcnn_tf_tpu_torch.checkpoint import Checkpointer
from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import _V1_PLAN

_BRANCH = re.compile(r"(Branch_\d+)/(\w+)")


def slim_name_to_flax_path(name: str) -> Tuple[str, Tuple[str, ...]]:
    """Map one slim variable name -> (collection, flax path tuple).

    collection is 'params' or 'batch_stats'.  Raises KeyError for variables
    we don't carry (e.g. optimizer slots, aux logits).
    """
    name = name.split(":")[0]
    if any(s in name for s in ("RMSProp", "Momentum", "Adam", "ExponentialMovingAverage",
                               "global_step", "AuxLogits")):
        raise KeyError(name)
    # Fold Branch_i/<conv> into the single module name we use.
    name = _BRANCH.sub(lambda m: f"{m.group(1)}_{m.group(2)}", name)
    parts = name.split("/")
    leaf = parts[-1]
    scope = parts[:-1]

    if leaf == "weights":
        if "Logits" in parts:
            return "params", ("Logits", "kernel")      # squeeze 1x1 conv
        return "params", tuple(scope) + ("conv", "kernel")
    if leaf == "biases":
        if "Logits" in parts:
            return "params", ("Logits", "bias")
        return "params", tuple(scope) + ("conv", "bias")
    if leaf == "beta":
        return "params", tuple(scope) + ("bias",)
    if leaf == "gamma":
        return "params", tuple(scope) + ("scale",)
    if leaf == "moving_mean":
        return "batch_stats", tuple(scope) + ("mean",)
    if leaf == "moving_variance":
        return "batch_stats", tuple(scope) + ("var",)
    raise KeyError(name)


def convert_slim_vars(slim_vars: Dict[str, np.ndarray]) -> Dict[str, dict]:
    """{slim_name: array} -> {'params': tree, 'batch_stats': tree}."""
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, arr in slim_vars.items():
        try:
            coll, path = slim_name_to_flax_path(name)
        except KeyError:
            continue
        if path[:1] == ("Logits",) and path[-1] == "kernel" and arr.ndim == 4:
            arr = arr.reshape(arr.shape[-2], arr.shape[-1])  # (1,1,C,N)->(C,N)
        node = out[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(arr)
    return out


def slim_variable_shapes(num_classes: int = 1001) -> List[Tuple[str, Tuple]]:
    """[(slim name, shape)] of slim's Inception-v1 checkpoint: every conv's
    `weights` and `BatchNorm/{beta,moving_mean,moving_variance}` of the
    port's `_V1_PLAN`, then the `num_classes`-way `Logits/Conv2d_0c_1x1`
    (1001 in the public ImageNet checkpoint)."""
    specs: List[Tuple[str, Tuple]] = []

    def conv_bn(scope, kh, kw, cin, cout):
        specs.append((f"{scope}/weights", (kh, kw, cin, cout)))
        for leaf in ("beta", "moving_mean", "moving_variance"):
            specs.append((f"{scope}/BatchNorm/{leaf}", (cout,)))

    c = 3
    for name, spec in _V1_PLAN:
        scope = f"InceptionV1/{name}"
        if spec[0] == "conv":
            _, feats, (kh, kw), _ = spec
            conv_bn(scope, kh, kw, c, feats)
            c = feats
        elif spec[0] == "mixed":
            _, b0, b1r, b1, b2r, b2, b3 = spec
            conv_bn(f"{scope}/Branch_0/Conv2d_0a_1x1", 1, 1, c, b0)
            conv_bn(f"{scope}/Branch_1/Conv2d_0a_1x1", 1, 1, c, b1r)
            conv_bn(f"{scope}/Branch_1/Conv2d_0b_3x3", 3, 3, b1r, b1)
            conv_bn(f"{scope}/Branch_2/Conv2d_0a_1x1", 1, 1, c, b2r)
            conv_bn(f"{scope}/Branch_2/Conv2d_0b_3x3", 3, 3, b2r, b2)
            conv_bn(f"{scope}/Branch_3/Conv2d_0b_1x1", 1, 1, c, b3)
            c = b0 + b1 + b2 + b3
    specs.append(("InceptionV1/Logits/Conv2d_0c_1x1/weights",
                  (1, 1, c, num_classes)))
    specs.append(("InceptionV1/Logits/Conv2d_0c_1x1/biases", (num_classes,)))
    return specs


def read_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Every variable of a TensorFlow checkpoint (`Saver` prefix), as numpy.
    Needs TensorFlow, imported here and kept off the GPUs."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "reading a TF-Slim checkpoint needs the `tensorflow` package, "
            "which this Python does not have; run the importer where it is "
            "installed and copy its output directory") from e

    tf.config.set_visible_devices([], "GPU")
    reader = tf.train.load_checkpoint(path)
    return {
        name: reader.get_tensor(name)
        for name in reader.get_variable_to_shape_map()
    }


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def save_variables(tree: Dict[str, dict], output_dir: str) -> int:
    """Write the Flax tree as the port's checkpoint of step 0 under
    `output_dir`; returns the number of arrays."""
    Checkpointer(output_dir).save(0, {"step": 0, "variables": _tensors(tree)})
    return sum(1 for _ in _leaves(tree))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--slim_checkpoint", required=True)
    p.add_argument("--output_dir", required=True)
    args = p.parse_args(argv)
    tree = convert_slim_vars(read_tf_checkpoint(args.slim_checkpoint))
    n = save_variables(tree, args.output_dir)
    print(f"wrote {n} arrays to {args.output_dir} (step 0)")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
