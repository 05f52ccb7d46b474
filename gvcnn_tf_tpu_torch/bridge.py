"""Weight bridge between the JAX package's variables and the port's
`state_dict`.

The JAX side is the Flax tree `{"params": ..., "batch_stats": ...}` with
numpy arrays as leaves (for instance `jax.device_get` of `model.init`);
nothing here imports JAX.  The port's module names follow the Flax scopes,
so a path maps to a key by joining the scopes with dots and renaming the
leaf:

  params/<scope>/kernel      4-D HWIO  ->  <scope>.weight  OIHW
                             (a depthwise (7, 7, 1, 24) -> (24, 1, 7, 7))
  params/<scope>/kernel      2-D (in, out) -> <scope>.weight (out, in)
  params/<scope>/bias                  ->  <scope>.bias
  params/<scope>/scale                 ->  <scope>.scale  (BatchNorm gamma)
  batch_stats/<scope>/mean, var        ->  <scope>.running_mean, running_var

e.g. params/InceptionV1/Mixed_3b/Branch_1_Conv2d_0b_3x3/conv/kernel
(3, 3, 96, 128) -> InceptionV1.Mixed_3b.Branch_1_Conv2d_0b_3x3.conv.weight
(128, 96, 3, 3).  Both directions copy the values exactly.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)      # HWIO -> OIHW
    if a.ndim == 2:
        return a.T                          # (in, out) -> (out, in)
    return a


def _to_jax_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)      # OIHW -> HWIO
    if a.ndim == 2:
        return a.T
    return a


def jax_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax {params, batch_stats} (numpy leaves) -> the port's state_dict."""
    out = {}
    for collection, tree in variables.items():
        for path, leaf in _flatten(tree):
            *scope, name = path
            a = np.asarray(leaf)
            if collection == "params" and name == "kernel":
                key, a = "weight", _to_torch_layout(a)
            elif collection == "params" and name in ("bias", "scale"):
                key = name
            elif collection == "batch_stats" and name in _STATS:
                key = _STATS[name]
            else:
                raise KeyError(f"no port counterpart for "
                               f"{collection}/{'/'.join(path)}")
            out[".".join(scope + [key])] = torch.tensor(a)  # a copy
    return out


def state_dict_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state_dict -> Flax {params, batch_stats} (numpy leaves)."""
    variables: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *scope, name = key.split(".")
        a = t.detach().cpu().numpy()
        if name == "weight":
            collection, leaf, a = "params", "kernel", _to_jax_layout(a)
        elif name in ("bias", "scale"):
            collection, leaf = "params", name
        elif name in _STATS_BACK:
            collection, leaf = "batch_stats", _STATS_BACK[name]
        else:
            raise KeyError(f"no JAX counterpart for {key}")
        node = variables[collection]
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = np.ascontiguousarray(a)
    return variables
